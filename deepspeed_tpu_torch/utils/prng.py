"""The threefry-2x32 random streams of the JAX package, bit for bit.

The port's copy of what the JAX package takes from `jax.random` (the
default threefry PRNG, `jax_threefry_partitionable=True`):

- `threefry2x32(k1, k2, x1, x2)`: the Threefry-2x32 hash of 20 rounds;
- `prng_key(seed)`: `jax.random.PRNGKey(seed)` for a seed in [-2^31,
  2^32), the key [0, seed mod 2^32];
- `fold_in(key, data)`: `jax.random.fold_in`, the hash of the counter
  pair [0, data] under `key`;
- `random_bits(key, shape)`: 32-bit `jax.random.bits` on the partitionable
  scheme: element i of the flat shape hashes the counter pair (i >> 32,
  i & 0xFFFFFFFF), and its bits are the two output words xor-ed;
- `uniform(key, shape, minval, maxval)`: `jax.random.uniform` in f32, the
  23 high bits of each draw as the mantissa of a float in [1, 2), less 1,
  scaled into [minval, maxval) by one multiply-add rounded once (XLA
  contracts it to a fused multiply-add) and held at or above minval.

Keys are int64 tensors [..., 2] whose two entries hold the key's uint32
words; every word is kept in [0, 2^32) by an explicit mask, since torch
has no uint32 arithmetic on the GPU. The functions broadcast over leading
dims (a [S, 2] key batch gives [S, *shape] draws), allocate nothing on
the host and never wait for the device, so they run inside a captured
CUDA graph.
"""

from typing import Sequence, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
# the rotations of the rounds, alternating by group of four, and the key
# schedule's parity constant (Salmon et al., Random123)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK32) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter words (x1, x2) under the key words (k1,
    k2): int64 tensors (or ints) holding uint32 values, broadcast together.
    Returns the two output words, int64 in [0, 2^32)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def prng_key(seed: int, device: Union[str, torch.device, None] = "cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: the int64 key [2] = [0, seed mod 2^32].
    The JAX package runs with 32-bit integers, where a seed of 2^32 or more
    loses its high word; such a seed raises here instead."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed {seed} is outside [-2^31, 2^32)")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def words(x) -> torch.Tensor:
    """Integers (int tensor, numpy array or int) -> int64 uint32 words."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x.astype(np.int64))
    x = torch.as_tensor(x)
    return x.to(torch.int64) & MASK32


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: key [..., 2], data [...] (uint32
    values; broadcast against the key's leading dims) -> keys [..., 2]."""
    data = words(data).to(key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit `jax.random.bits(key, shape)`: key [..., 2] -> int64 words
    [..., *shape] in [0, 2^32), one independent draw per leading key."""
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape, dtype=np.int64))
    lead = key.shape[:-1]
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    view = (1,) * len(lead) + (n,)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    y1, y2 = threefry2x32(k1, k2, (idx >> 32).view(view), (idx & MASK32).view(view))
    return (y1 ^ y2).reshape(*lead, *shape)


_ONE_BITS = 0x3F800000  # the f32 bits of 1.0


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 `jax.random.uniform(key, shape, minval=minval, maxval=maxval)`:
    key [..., 2] -> [..., *shape] in [minval, maxval)."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    # the product of two f32 is exact in f64; the sum rounds as XLA's fused
    # multiply-add does
    scaled = (floats.double() * float(hi - lo) + float(lo)).float()
    return torch.maximum(torch.full((), float(lo), dtype=torch.float32, device=key.device),
                         scaled)
