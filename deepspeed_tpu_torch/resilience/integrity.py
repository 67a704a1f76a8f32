"""Integrity envelopes and seeded bit flips for KV handoff payloads.

Counterpart of deepspeed_tpu/resilience/integrity.py, the part the KV
transfer and the spill tier use, in numpy: the typed errors, the seeded
dtype-aware bit flips behind a 'corrupt' fault (`flip_bits`,
`corrupt_payload`) and the blake2b digest of a flat payload
(`payload_digest`). The tree digests and the training anomaly detector
come with the slices that use them.

bf16 pages: numpy has no bfloat16 without ml_dtypes (which the GPU
machine lacks), so the port's export_kv carries bf16 pages as their
uint16 bit patterns in a payload whose "kv_dtype" is "bfloat16". The
digest names such an array's dtype "bfloat16", as the JAX package's
digest does for the same bytes held as an ml_dtypes array, so that one
envelope means the same in both packages.
"""

import hashlib
from typing import Any, Dict, List, Tuple

import numpy as np

__all__ = ["IntegrityError", "HandoffIntegrityError", "flip_bits", "corrupt_payload",
           "payload_digest"]


class IntegrityError(RuntimeError):
    """A runtime data-integrity violation (a digest mismatch)."""


class HandoffIntegrityError(IntegrityError):
    """A KV handoff payload failed digest verification at import; callers
    discard it and take the token-identical recompute path."""


_UINT_OF_ITEMSIZE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
# mantissa widths of the float dtypes an 'exponent' flip targets: the
# exponent field is [mantissa_bits, nbits - 2], the sign bit excluded
_MANTISSA_BITS = {"float16": 10, "bfloat16": 7, "float32": 23, "float64": 52}


def _rng_for(seed: int, invocation: int, path: str) -> np.random.Generator:
    """One deterministic stream per (plan seed, matching invocation, leaf
    path)."""
    h = hashlib.blake2b(f"{int(seed)}:{int(invocation)}:{path}".encode(), digest_size=8)
    return np.random.default_rng(int.from_bytes(h.digest(), "little"))


def flip_bits(arr, seed: int, invocation: int, path: str = "", n_flips: int = 1,
              bit_class: str = "any",
              dtype_name: str = None) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Deterministically flip `n_flips` bits of a COPY of `arr`, in the
    leaf's machine words (an f32 word, a bf16 half-word).
    bit_class='exponent' restricts float flips to the exponent field;
    'any' draws over the whole word. dtype_name names the element type of
    an array carried as bits (a uint16 bf16 page: "bfloat16"). Returns
    (corrupted copy, [(flat_index, bit)])."""
    a = np.array(arr)
    if a.size == 0:
        return a, []
    rng = _rng_for(seed, invocation, path)
    flat = a.reshape(-1)
    uint = flat.view(_UINT_OF_ITEMSIZE[a.dtype.itemsize])
    nbits = a.dtype.itemsize * 8
    mant = _MANTISSA_BITS.get(dtype_name or a.dtype.name)
    log: List[Tuple[int, int]] = []
    for _ in range(max(1, int(n_flips))):
        idx = int(rng.integers(0, flat.size))
        if bit_class == "exponent" and mant is not None:
            bit = int(rng.integers(mant, nbits - 1))
        else:
            bit = int(rng.integers(0, nbits))
        uint[idx] ^= uint.dtype.type(1 << bit)
        log.append((idx, bit))
    return a, log


def _bits_dtype(payload: Dict[str, Any], arr) -> str:
    """The dtype name a payload array stands for: "bfloat16" for uint16
    bits in a bf16-tagged payload, else its own."""
    if payload.get("kv_dtype") == "bfloat16" and getattr(arr, "dtype", None) == np.uint16:
        return "bfloat16"
    return None


def corrupt_payload(payload: Dict[str, Any], seed: int, invocation: int,
                    keys: Tuple[str, ...] = ("k", "v")) -> Tuple[Dict[str, Any], List[str]]:
    """Flip one bit in one of a handoff payload's page-stack arrays (the
    in-transit / host-memory corruption model). Shallow copy; only the
    corrupted array is copied. The attached digest is left as it is:
    verification must catch the mismatch."""
    rng = _rng_for(seed, invocation, "payload-key")
    present = [k for k in keys if k in payload]
    if not present:
        return payload, []
    key = present[int(rng.integers(0, len(present)))]
    flipped, flips = flip_bits(np.asarray(payload[key]), seed, invocation, key,
                               dtype_name=_bits_dtype(payload, payload[key]))
    out = dict(payload)
    out[key] = flipped
    return out, [f"{key}[{idx}]^bit{bit}" for idx, bit in flips]


def _update_leaf(h, name: str, leaf, dtype_name: str = None) -> None:
    h.update(name.encode())
    if leaf is None:
        h.update(b"<none>")
        return
    arr = np.asarray(leaf)
    h.update((dtype_name or str(arr.dtype)).encode())
    h.update(str(arr.shape).encode())
    # hashed in place: a page stack is up to hundreds of MiB
    h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def payload_digest(payload: Dict[str, Any], exclude: Tuple[str, ...] = ("digest",),
                   digest_size: int = 16) -> str:
    """blake2b hex digest of a flat dict payload (the export_kv envelope):
    keys in sorted order, each field's name, dtype, shape and bytes, the
    digest field itself excluded so the envelope can ride inside the
    payload. Bit-exact: any single flip anywhere changes it."""
    h = hashlib.blake2b(digest_size=digest_size)
    for key in sorted(payload):
        if key in exclude:
            continue
        _update_leaf(h, key, payload[key], _bits_dtype(payload, payload[key]))
    return h.hexdigest()
