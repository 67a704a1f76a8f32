"""The int8 form of the grouped GEMM (ops/cuda/grouped_gemm.py
grouped_gemm_int8) and the MoE routes that use it, held against the JAX
package on the CPU, from the same numpy-made inputs.

- the int8 form's plain version (and its wrapper, which on CPU tensors is
  the plain version) against the JAX package's "dense" and "ragged"
  grouped_mm on the JAX QuantizedWeight's dequantize()'d stack, at 1e-5 in
  f32, stacks dequantizing to f32 and to bf16, with an empty segment, one
  segment holding every row and rows past the segments;
- `grouped_mm` taking QuantizedWeight stacks (int8 by the int8 form,
  4-bit dequantized first) and `dropless_apply` taking them for its three
  projections, against the JAX functions on the dequantized stacks;
- the MoE MLP's routes: on groupwise int8 stacks under use_kernel, the scan
  path runs three int8 grouped GEMMs a call (X segments of all T rows) and
  the dropless path three, with the scan's per-expert plain route's result
  (1e-5 in f32); bf16-valued stacks and the plain path launch none.

No JAX engine is built. The kernel itself is held against its plain version
on the card in tests/test_torch_cuda.py -k GroupedGemm and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.quantization import QuantizedWeight as JQuantizedWeight
from deepspeed_tpu.moe import dropless as JD
from deepspeed_tpu.ops import quantization as JQ
from deepspeed_tpu_torch.inference import model as PM
from deepspeed_tpu_torch.inference.quantization import QuantizedWeight
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.moe import dropless as PD
from deepspeed_tpu_torch.ops.cuda import grouped_gemm as PG
from deepspeed_tpu_torch.ops.quantization import pack_int4

F32_TOL = dict(rtol=1e-5, atol=1e-5)
# segment sizes over 20 rows: an empty segment, one segment holding every
# row, rows past the segments, singletons
COUNTS = {"mixed": [5, 0, 9, 6], "one_full": [0, 20, 0, 0], "first_full": [20, 0, 0, 0],
          "rows_past_segments": [3, 4, 0, 2], "singletons": [1, 1, 1, 17]}
GROUP = 8  # 3 groups of the 24 output columns

_jit_grouped = jax.jit(JD.grouped_mm, static_argnames=("impl",))
_jit_quantize = jax.jit(JQ.quantize_groupwise, static_argnums=(1, 2))


def _t(a):
    return torch.from_numpy(np.array(a))


def _stack(rng, X=4, K=16, N=24, bits=8):
    """A weight stack [X, K, N] quantized groupwise by the JAX function:
    (its codes, its scales) as numpy arrays."""
    w = rng.standard_normal((X, K, N)).astype(np.float32)
    q, scale = _jit_quantize(jnp.asarray(w), GROUP, bits)
    return np.asarray(q), np.asarray(scale)


def _both(q, scale, dtype_name, bits=8):
    """The JAX and the port QuantizedWeight of the same codes and scales
    (4-bit codes packed two to a byte, as the stacks keep them)."""
    jq = jnp.asarray(q) if bits == 8 else JQ.pack_int4(jnp.asarray(q))
    pq = _t(q) if bits == 8 else pack_int4(_t(q))
    return (JQuantizedWeight(q=jq, scale=jnp.asarray(scale), bits=bits, dtype_name=dtype_name),
            QuantizedWeight(q=pq, scale=_t(scale), bits=bits, dtype_name=dtype_name))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(COUNTS))
def test_int8_plain_matches_jax(rng, case, dtype_name):
    """The int8 form's plain version and wrapper (CPU: the plain version)
    on the codes and scales against the JAX grouped_mm, "dense" and
    "ragged", on the JAX stack's dequantize(): equal at 1e-5 in f32, rows
    past the segments zero."""
    counts = np.array(COUNTS[case], np.int32)
    xs = rng.standard_normal((20, 16)).astype(np.float32)
    q, scale = _stack(rng)
    jw, pw = _both(q, scale, dtype_name)
    with jax.default_matmul_precision("highest"):
        want = {impl: np.asarray(_jit_grouped(jnp.asarray(xs), jw.dequantize(),
                                              jnp.asarray(counts), impl=impl))
                for impl in ("dense", "ragged")}
    dtype = getattr(torch, dtype_name)
    args = (_t(xs), pw.q, pw.scale, _t(counts))
    got = {"plain": PG.grouped_gemm_int8_plain(*args, dtype),
           "wrapper": PG.grouped_gemm_int8(*args, dtype)}
    for g in got.values():
        for w in want.values():
            np.testing.assert_allclose(g.numpy(), w, **F32_TOL)
    assert torch.equal(got["wrapper"], got["plain"])
    assert not got["plain"][int(counts.sum()):].any()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("impl", ["auto", "ragged", "dense"])
def test_grouped_mm_takes_quantized_stacks(rng, impl, bits):
    """grouped_mm on a QuantizedWeight stack (int8: the int8 form; 4-bit:
    dequantized first) equals the JAX grouped_mm on the JAX stack's
    dequantize(), every impl, at 1e-5 in f32."""
    counts = np.array(COUNTS["mixed"], np.int32)
    xs = rng.standard_normal((20, 16)).astype(np.float32)
    q, scale = _stack(rng, bits=bits)
    jw, pw = _both(q, scale, "float32", bits)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(_jit_grouped(jnp.asarray(xs), jw.dequantize(), jnp.asarray(counts),
                                       impl="dense"))
    got = PD.grouped_mm(_t(xs), pw, _t(counts), impl=impl)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "biases"])
def test_dropless_apply_takes_quantized_stacks(rng, gated):
    """dropless_apply with QuantizedWeight stacks for w_gate, w_in and
    w_out against the JAX dropless_apply on the dequantized stacks (the
    same routing decisions), in f32 at 1e-5."""
    T_, E, F, X = 13, 16, 24, 4
    tokens = rng.standard_normal((T_, E)).astype(np.float32)
    idx = np.stack([rng.permutation(X)[:2] for _ in range(T_)]).astype(np.int32)
    wts = rng.random((T_, 2)).astype(np.float32)
    counts = np.bincount(idx.reshape(-1), minlength=X).astype(np.int32)
    stacks = {}
    for name, (K, N) in (("w_gate", (E, F)), ("w_in", (E, F)), ("w_out", (F, E))):
        stacks[name] = _both(*_stack(rng, X, K, N), "float32")
    b_in = None if gated else rng.standard_normal((X, F)).astype(np.float32)
    b_out = None if gated else rng.standard_normal((X, E)).astype(np.float32)
    jgate = stacks["w_gate"][0].dequantize() if gated else None
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JD.dropless_apply(
            jnp.asarray(tokens), jnp.asarray(idx), jnp.asarray(wts), jnp.asarray(counts),
            stacks["w_in"][0].dequantize(), stacks["w_out"][0].dequantize(), jgate,
            None if gated else jnp.asarray(b_in), None if gated else jnp.asarray(b_out),
            act=jax.nn.silu if gated else jax.nn.gelu, impl="dense"))
    pact = torch.nn.functional.silu if gated else (
        lambda x: torch.nn.functional.gelu(x, approximate="tanh"))
    for impl in ("ragged", "dense"):
        got = PD.dropless_apply(
            _t(tokens), _t(idx).long(), _t(wts), _t(counts), stacks["w_in"][1],
            stacks["w_out"][1], w_gate=stacks["w_gate"][1] if gated else None,
            b_in=None if gated else _t(b_in), b_out=None if gated else _t(b_out),
            act=pact, impl=impl)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


# the tiny Mixtral form of tests/test_torch_moe_serving.py
MIXTRAL_TINY = dict(vocab_size=256, n_layers=1, n_heads=4, n_kv_heads=2, d_model=64, d_ff=128,
                    max_seq=128, variant="llama", n_experts=4, moe_top_k=2)


@pytest.mark.parametrize("dropless", [False, True], ids=["scan", "dropless"])
def test_int8_stacks_route_through_the_int8_form(rng, monkeypatch, dropless):
    """On groupwise int8 stacks (quantize_layer) under use_kernel, the MoE
    MLP runs three int8 grouped GEMMs a call on either path (the scan's
    over X segments of all T rows, h repeated) and no bf16 grouped GEMM,
    and gives the scan's per-expert plain route's FFN (use_kernel False:
    one expert dequantized at a time) at 1e-5 in f32; the plain path and
    bf16-valued stacks launch no int8 grouped GEMM."""
    calls = {"int8": [], "bf16": 0}
    real_int8, real_bf16 = PG.grouped_gemm_int8, PG.grouped_gemm

    def int8(xs, codes, scale, counts, dtype=torch.bfloat16):
        calls["int8"].append((tuple(xs.shape), counts.tolist()))
        return real_int8(xs, codes, scale, counts, dtype)

    def bf16(*args):
        calls["bf16"] += 1
        return real_bf16(*args)

    for mod in (PM, PD):
        monkeypatch.setattr(mod, "grouped_gemm_int8", int8)
    monkeypatch.setattr(PD, "grouped_gemm", bf16)
    cfg = PT.TransformerConfig(**MIXTRAL_TINY, moe_dropless=dropless)
    params = PT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    lp = PM.prepare(params, cfg)["layers"][0]
    qlp = PM.quantize_layer(lp, cfg)
    h = _t(rng.standard_normal((11, 64)).astype(np.float32))
    got = PM._mlp(h, qlp, cfg)
    assert len(calls["int8"]) == 3 and calls["bf16"] == 0
    if not dropless:  # X segments of all 11 rows
        assert all(c == ((44, s), [11] * 4) for c, s in zip(calls["int8"], (64, 64, 128)))
    plain = PM._mlp(h, qlp, PT.TransformerConfig(**MIXTRAL_TINY), use_kernel=False)
    assert len(calls["int8"]) == 3
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32_TOL)
    PM._mlp(h, lp, cfg)
    assert len(calls["int8"]) == 3  # full-precision stacks: not the int8 form
