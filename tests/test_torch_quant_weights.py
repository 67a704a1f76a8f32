"""Quantized weights of the port held against the JAX package on the CPU:
per-channel int8 (the speed path) and groupwise int8/int4 (the memory
path), from the same numpy-made weights.

- Codes and scales bit for bit: `channel_quantize` (contract_ndim 1 and 2,
  scale_first, f32 and bf16 weights, zero channels, exact .5 ties, NaN and
  inf), `quantize_groupwise`, `pack_int4`/`unpack_int4` and
  `quantize_for_inference` against the JAX functions under jax.jit, which
  is how the JAX engine runs them (XLA computes absmax / 127 there as a
  multiplication by the f32 reciprocal; see ROADMAP C's contract notes).
- `quantize_prepared` leaf for leaf against the JAX tree.
- `_wmm`, `_embed_rows` and `_lm_logits` on the same codes, every product
  form of the serving forward: f32 at 1e-5; bf16 at the serving tests'
  one-ulp pin (rtol 8e-3, atol 1e-3 x the largest |value|: the two
  frameworks sum the f32 product in another order, which may flip the
  bf16 rounding of a product and so of its scaled value).
- Engines, per-channel and groupwise, against the JAX engine with the same
  `quantization`: put() logits (a prefill wave, single-token decodes, a
  chunked continuation) at the engine tests' 1e-4 and identical greedy
  tokens, and decode_multi_fn greedy and sampled (the bench's lane),
  tokens identical, logits at 1e-4. Forms: the tied Llama, Phi-2's
  (an untied lm_head with its bias), BLOOM's (q/k/v and output biases, a
  non-gated MLP, the embedding LayerNorm) and Falcon-7B's (the parallel
  residual, one KV head).
- The engine's contract: a prepared int8 tree carried across by
  `params_from_numpy` serves as quantizing in the engine does;
  `refresh_params` quantizes again and drops captured graphs; `warmup()`;
  the JAX tests' row scales, memory, int8-only and unknown-key checks;
  offload still raising.
- The W8A16 GEMM's split plan (ops/cuda/int8_matmul.py) at the served
  shapes. (The kernel runs only on the card: tests/test_torch_cuda.py and
  chip_smoke.py hold it against its plain version.)
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    FALCON_7B_TINY,
    FALCON_PHI_STD,
    PHI_2_TINY,
    SERVE,
    TINY,
    numpy_params,
    to_jax,
)
from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.inference import model as JM
from deepspeed_tpu.inference import quantization as JQ
from deepspeed_tpu.inference.sampling import SamplingConfig as JaxSamplingConfig
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import quantization as JO
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.inference import model as PM
from deepspeed_tpu_torch.inference import quantization as PQ
from deepspeed_tpu_torch.inference.sampling import SamplingConfig
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops import cuda as PK
from deepspeed_tpu_torch.ops import quantization as PO
from deepspeed_tpu_torch.ops.cuda import int8_matmul as PI
from deepspeed_tpu_torch.utils.convert import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL, BF16_ATOL = 8e-3, 1e-3  # one bf16 ulp, and near zero
PER_CHANNEL = {"bits": 8, "per_channel": True}
GROUP8 = {"bits": 8, "group_size": 64}
GROUP4 = {"bits": 4, "group_size": 64}
LANE = dict(do_sample=True, temperature=0.9, top_k=40, top_p=0.95)  # the bench's
BLOOM_TINY = dict(TINY, variant="gpt2", alibi=True, embedding_layernorm=True,
                  activation="gelu")
FORMS = {"llama": TINY, "phi_2": PHI_2_TINY, "bloom": BLOOM_TINY, "falcon_7b": FALCON_7B_TINY}
# weight std of each form: the existing engine parity tests' (the Llama
# engine test's numpy_params default, the ALiBi tests' 0.3, FALCON_PHI_STD),
# where their 1e-4 pin was set
STD = {"llama": 0.08, "bloom": 0.3, **FALCON_PHI_STD}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: pytest-xdist workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32 if dtype is not None else None))
    return t if dtype is None else t.to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _weight(rng, shape, out_axes, zero=True, ties=True):
    """Normal weights of `shape`; one output channel (an index of the
    output dims `out_axes`) all zero; another whose absmax is 127 x 2^-3,
    so its scale is 2^-3 exactly (127 x f32(1/127) is 1 in f32) and its
    entries (k + 1/2) x 2^-3 are exact ties of x / scale."""
    w = rng.normal(0, 0.5, shape).astype(np.float32)
    moved = np.moveaxis(w, out_axes, tuple(range(len(out_axes))))  # a view
    flat = moved.reshape(-1, *moved.shape[len(out_axes):])
    if zero:
        flat[1] = 0.0
    if ties:
        t = (rng.integers(-120, 120, flat[2].shape) + 0.5) * 0.125
        t.reshape(-1)[0] = 127 * 0.125
        flat[2] = t
    return np.ascontiguousarray(np.moveaxis(flat.reshape(moved.shape),
                                            tuple(range(len(out_axes))), out_axes))


def _jit_channel(w, contract_ndim, scale_first=False):
    return jax.jit(lambda x: JQ.channel_quantize(x, contract_ndim, scale_first))(w)


# ---------------------------------------------------------------------------
# codes and scales
# ---------------------------------------------------------------------------

CHANNEL_CASES = {  # name -> (shape, contract_ndim, scale_first, output axes)
    "w_qkv": ((64, 6, 16), 1, False, (1, 2)),
    "wo": ((4, 16, 48), 2, False, (2,)),
    "w_gi": ((96, 40), 1, False, (1,)),
    "embed": ((50, 32), 1, True, (0,)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CHANNEL_CASES))
def test_channel_quantize_bit_for_bit(case, dtype):
    shape, c, sf, out_axes = CHANNEL_CASES[case]
    w = _weight(np.random.default_rng(0), shape, out_axes)
    jq = _jit_channel(jnp.asarray(w, getattr(jnp, dtype)), c, sf)
    pq = PQ.channel_quantize(_t(w, getattr(torch, dtype)), c, scale_first=sf)
    np.testing.assert_array_equal(pq.codes().numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(pq.scales().numpy(), np.asarray(jq.scale))
    assert pq.shape == tuple(jq.q.shape) and pq.ndim == jq.q.ndim
    assert pq.dtype_name == jq.dtype_name == dtype
    assert pq.q.shape == (math.prod(pq.out_shape), w.size // math.prod(pq.out_shape))
    scales = pq.scale.numpy()
    assert scales[1] == 1.0 and (pq.q[1] == 0).all()  # the zero channel
    assert scales[2] == 0.125
    ties = pq.q[2].numpy()
    assert (ties % 2 == 0).sum() > 0.45 * ties.size  # half to even: every tie lands even


def test_channel_quantize_non_finite_as_the_jax_package():
    """A NaN makes its channel's scale 1 (absmax NaN is not > 0) and its
    own code 0; an inf makes the scale inf and the finite codes 0; -inf
    under scale 1 clamps to -127: the JAX package's codes on the CPU."""
    w = np.random.default_rng(1).normal(size=(6, 5)).astype(np.float32)
    w[1, 2], w[3, 3], w[0, 4], w[4, 4] = np.nan, np.inf, -np.inf, np.nan
    for sf in (False, True):
        jq = _jit_channel(jnp.asarray(w), 1, sf)
        pq = PQ.channel_quantize(_t(w), 1, scale_first=sf)
        np.testing.assert_array_equal(pq.codes().numpy(), np.asarray(jq.q))
        np.testing.assert_array_equal(pq.scales().numpy(), np.asarray(jq.scale))


def test_from_codes_round_trips_the_jax_layout():
    for name, (shape, c, sf, out_axes) in CHANNEL_CASES.items():
        jq = _jit_channel(jnp.asarray(_weight(np.random.default_rng(2), shape, out_axes)), c, sf)
        pq = PQ.ChannelQuantWeight.from_codes(_t(np.asarray(jq.q)), _t(np.asarray(jq.scale)),
                                              contract_ndim=c, scale_first=sf)
        np.testing.assert_array_equal(pq.codes().numpy(), np.asarray(jq.q), err_msg=name)
        np.testing.assert_array_equal(pq.scales().numpy(), np.asarray(jq.scale))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group,last", [(64, 128), (64, 96), (0, 40)])
def test_quantize_groupwise_bit_for_bit(bits, group, last):
    """Group 64 of 128 (two groups a row), of 96 (does not divide: one
    scale a row), and group 0 (one a row)."""
    w = np.random.default_rng(3).normal(size=(3, 7, last)).astype(np.float32)
    w[0, 1] = 0.0
    w[1, 2, : last // 2] = (np.arange(last // 2) % 13 - 6 + 0.5) * 2.0 ** -4
    w[1, 2, 0] = (127 if bits == 8 else 7) * 2.0 ** -4  # scale 2^-4 where it is exact
    jq, js = jax.jit(lambda x: JO.quantize_groupwise(x, group, bits))(jnp.asarray(w))
    pq, ps = PO.quantize_groupwise(_t(w), group, bits)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    back = jax.jit(lambda q, s: JO.dequantize_groupwise(q, s, jnp.float32))(jq, js)
    np.testing.assert_array_equal(PO.dequantize_groupwise(pq, ps).numpy(), np.asarray(back))


def test_pack_int4_bit_for_bit():
    q = np.random.default_rng(4).integers(-7, 8, (5, 2, 24)).astype(np.int8)
    jp = jax.jit(JO.pack_int4)(jnp.asarray(q))
    pp = PO.pack_int4(_t(q))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(PO.unpack_int4(pp).numpy(), q)
    np.testing.assert_array_equal(PO.unpack_int4(pp).numpy(), np.asarray(JO.unpack_int4(jp)))


def test_blockwise_round_trip_matches():
    x = np.random.default_rng(5).normal(size=(3, 1000)).astype(np.float32)
    jq, js = jax.jit(lambda a: JO.quantize_blockwise(a, 256, 8))(jnp.asarray(x))
    pq, ps = PO.quantize_blockwise(_t(x), 256, 8)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        PO.dequantize_blockwise(pq, ps, x.shape).numpy(),
        np.asarray(JO.dequantize_blockwise(jq, js, x.shape)))


def _prepared(over, seed=6, std=0.3):
    """The JAX and the port prepared trees (f32) of one form."""
    jc, pc = JT.TransformerConfig(**over), PT.TransformerConfig(**over)
    tree = numpy_params(jc, seed=seed, std=std)
    return (jc, JM.prepare(to_jax(tree), jc), pc,
            PM.prepare(params_from_numpy(tree, pc, device="cpu"), pc))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("bits,group,min_ndim", [(8, 64, 2), (4, 64, 2), (8, 48, 3)])
def test_quantize_for_inference_leaf_for_leaf(bits, group, min_ndim):
    """Every leaf of the prepared Phi-2-form tree (biases, norms, an odd
    width nowhere; group 48 divides some last dims and not others)."""
    jc, jp, pc, pp = _prepared(PHI_2_TINY)
    jq = jax.jit(lambda p: JQ.quantize_for_inference(p, bits, group, min_ndim))(jp)
    pq = PQ.quantize_for_inference(pp, bits, group, min_ndim)
    jf = _flat(jax.tree.map(lambda x: x, jq, is_leaf=lambda x: isinstance(x, JQ.QuantizedWeight)))
    pf = _flat(pq)
    assert list(jf) == list(pf)
    quantized = set()
    for name, j in jf.items():
        p = pf[name]
        if isinstance(j, JQ.QuantizedWeight):
            quantized.add(name.split("/")[-1])
            assert isinstance(p, PQ.QuantizedWeight), name
            assert (p.bits, p.dtype_name) == (j.bits, j.dtype_name)
            np.testing.assert_array_equal(p.q.numpy(), np.asarray(j.q), err_msg=name)
            np.testing.assert_array_equal(p.scale.numpy(), np.asarray(j.scale), err_msg=name)
            np.testing.assert_array_equal(p.dequantize().numpy(), np.asarray(j.dequantize()))
        else:
            assert isinstance(p, torch.Tensor), name
            np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=name)
    # every leaf of ndim >= min_ndim, the [H + 2KV, D] q/k/v bias among them
    assert quantized == ({"w_qkv", "wo"} if min_ndim == 3 else
                         {"embed", "lm_head", "b_qkv", "w_qkv", "wo", "w_in", "w_out"})
    assert PQ.quantized_nbytes(pq) == JQ.quantized_nbytes(jq)


def test_int4_leaves_an_odd_last_dim_full_precision():
    w = {"a": torch.randn(4, 7), "b": torch.randn(4, 8), "s": torch.randn(8)}
    q = PQ.quantize_for_inference(w, bits=4, group_size=0)
    jq = JQ.quantize_for_inference({k: jnp.asarray(v.numpy()) for k, v in w.items()}, 4, 0)
    assert isinstance(q["a"], torch.Tensor) and not isinstance(jq["a"], JQ.QuantizedWeight)
    assert isinstance(q["b"], PQ.QuantizedWeight) and isinstance(jq["b"], JQ.QuantizedWeight)
    assert q["b"].q.shape == (4, 4) and torch.equal(q["s"], w["s"])
    with pytest.raises(ValueError, match="4 or 8"):
        PQ.quantize_for_inference(w, bits=2)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_quantize_prepared_leaf_for_leaf(form):
    jc, jp, pc, pp = _prepared(FORMS[form])
    jq = jax.jit(lambda p: JM.quantize_prepared(p, jc))(jp)
    pq = PM.quantize_prepared(pp, pc)
    is_cq = lambda x: isinstance(x, JQ.ChannelQuantWeight)
    jf, pf = _flat(jax.tree.map(lambda x: x, jq, is_leaf=is_cq)), _flat(pq)
    assert list(jf) == list(pf)
    quantized = set()
    for name, j in jf.items():
        p = pf[name]
        if is_cq(j):
            quantized.add(name.split("/")[-1])
            assert isinstance(p, PQ.ChannelQuantWeight), name
            np.testing.assert_array_equal(p.codes().numpy(), np.asarray(j.q), err_msg=name)
            np.testing.assert_array_equal(p.scales().numpy(), np.asarray(j.scale), err_msg=name)
            assert p.shape == tuple(j.shape) and p.dtype_name == j.dtype_name
        else:
            assert isinstance(p, torch.Tensor), name
            np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=name)
    weights = {"embed", "w_qkv", "wo", "w_out", "w_gi" if pc.is_gated else "w_in"}
    assert quantized == weights | ({"lm_head"} if not pc.tie_embeddings else set())


# ---------------------------------------------------------------------------
# the products on the same codes
# ---------------------------------------------------------------------------

WMM_FORMS = {  # name -> (JAX einsum, x shape, weight shape, contract_ndim, out axes)
    "qkv": ("bse,ehd->bshd", (2, 5, 64), (64, 6, 16), 1, (1, 2)),
    "wo": ("shd,hde->se", (7, 4, 16), (4, 16, 48), 2, (2,)),
    "up": ("te,ef->tf", (9, 48), (48, 80), 1, (1,)),
    "down": ("tf,fe->te", (9, 80), (80, 48), 1, (1,)),
}


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                   atol=BF16_ATOL * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", sorted(WMM_FORMS))
def test_wmm_matches_jax_on_the_same_codes(form, dtype):
    eq, xs, ws, c, out_axes = WMM_FORMS[form]
    rng = np.random.default_rng(7)
    x = rng.normal(size=xs).astype(np.float32)
    jw = _jit_channel(jnp.asarray(_weight(rng, ws, out_axes), getattr(jnp, dtype)), c)
    pw = PQ.ChannelQuantWeight.from_codes(_t(np.asarray(jw.q)), _t(np.asarray(jw.scale)), c,
                                          dtype_name=dtype)
    want = JM._wmm(eq, jnp.asarray(x, getattr(jnp, dtype)), jw)
    for use_kernel in (True, False):  # on the CPU the wrapper runs the plain version
        got = PM._wmm(_t(x, getattr(torch, dtype)), pw, use_kernel, n_contract=c)
        assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_rows_and_logits_match_jax(dtype):
    """The per-row embedding lookup, the tied logits (`...e,ve->...v`) and
    an untied head with its bias (`...e,ev->...v`, + lm_head_b in f32)."""
    rng = np.random.default_rng(8)
    V, E = 96, 64
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    emb = _jit_channel(jnp.asarray(_weight(rng, (V, E), (0,)), jdt), 1, scale_first=True)
    head = _jit_channel(jnp.asarray(_weight(rng, (E, V), (1,)), jdt), 1)
    pemb = PQ.ChannelQuantWeight.from_codes(_t(np.asarray(emb.q)), _t(np.asarray(emb.scale)),
                                            scale_first=True, dtype_name=dtype)
    phead = PQ.ChannelQuantWeight.from_codes(_t(np.asarray(head.q)), _t(np.asarray(head.scale)),
                                             dtype_name=dtype)
    bias = rng.normal(size=(V,)).astype(np.float32)
    toks = rng.integers(0, V, (3, 5)).astype(np.int32)
    got = PM._embed_rows(pemb, torch.from_numpy(toks))
    assert got.dtype == pdt
    np.testing.assert_array_equal(got.float().numpy(), _np(JM._embed_rows(emb, jnp.asarray(toks))))
    x = rng.normal(size=(4, E)).astype(np.float32)
    for tied in (True, False):
        over = dict(TINY, d_model=E, vocab_size=V, tie_embeddings=tied, lm_head_bias=not tied,
                    n_heads=4)
        jc, pc = JT.TransformerConfig(**over), PT.TransformerConfig(**over)
        jparams = {"embed": emb} if tied else {"embed": emb, "lm_head": head,
                                               "lm_head_b": jnp.asarray(bias)}
        pparams = {"embed": pemb} if tied else {"embed": pemb, "lm_head": phead,
                                                "lm_head_b": torch.from_numpy(bias)}
        want = JM._lm_logits(jnp.asarray(x, jdt), jparams, jc)
        for use_kernel in (True, False):
            got = PM._lm_logits(_t(x, pdt), pparams, pc, use_kernel)
            assert got.dtype == torch.float32 and want.dtype == jnp.float32
            _close(got, want, dtype)


def test_plain_matmul_rounds_as_wmm():
    """int8_matmul_plain in bf16 rounds the product to bf16 and then its
    product with bf16(scale): the JAX package's two roundings; the logits
    form rounds only the product."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(3, 32)).astype(np.float32)).bfloat16()
    q = torch.from_numpy(rng.integers(-127, 128, (5, 32)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.02, 5).astype(np.float32))
    exact = x.double() @ q.double().t()
    y = PI.int8_matmul(x, q, s)
    ref = (exact.float().bfloat16().float() * s.bfloat16().float()).bfloat16()
    assert torch.equal(y, ref)
    assert torch.equal(PI.int8_matmul(x, q, s, out_f32=True),
                       exact.float().bfloat16().float() * s)
    assert PI.int8_matmul.launches == 0  # CPU tensors: the plain version


# ---------------------------------------------------------------------------
# engines against the JAX engine
# ---------------------------------------------------------------------------

def _engines(over, quantization, std, seed=7):
    jc, pc = JT.TransformerConfig(**over), PT.TransformerConfig(**over)
    tree = numpy_params(jc, seed=seed, std=std)
    jeng = jax_init_inference(to_jax(tree), jc, dict(SERVE), dtype=jnp.float32,
                              quantization=dict(quantization))
    peng = init_inference(params_from_numpy(tree, pc, device="cpu"), pc, dict(SERVE),
                          dtype=torch.float32, device="cpu", quantization=dict(quantization))
    return jeng, peng


def _scripted(jeng, peng, vocab):
    """A prefill wave, 4 greedy single-token decodes of its first prompt,
    a 3-token continuation of its second; then greedy and sampled
    decode_multi_fn over both rows. Returns the JAX and port results."""
    r = np.random.default_rng(13)
    prompts = [r.integers(0, vocab, n).astype(np.int32) for n in (13, 40)]
    out = []

    def put(uids, toks):
        lj = np.asarray(jeng.put(uids, [t.copy() for t in toks]))
        lp = peng.put(uids, [t.copy() for t in toks])
        out.append((lj, lp))
        return lj, lp

    lj, _ = put([0, 1], prompts)
    for _ in range(4):
        lj, _ = put([0], [np.array([int(np.argmax(lj[0]))], np.int32)])
    put([1], [r.integers(0, vocab, 3).astype(np.int32)])
    uids = [0, 1]
    tables = peng.state.block_table(uids, peng.config.blocks_per_seq, peng.pad_block)
    ctx = np.array([peng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
    toks = np.array([7, 8], np.int32)
    jg, jl, jeng.cache, _ = jeng.decode_multi_fn(2, 6)(
        jeng.params, jeng.cache, jnp.asarray(toks), jnp.asarray(tables), jnp.asarray(ctx))
    pg, pl_, _, _ = peng.decode_multi_fn(2, 6)(peng.params, peng.cache, toks, tables, ctx)
    greedy = (np.asarray(jg), pg.numpy(), np.asarray(jl), pl_.numpy())
    ctx = ctx + 6
    keys = peng._row_keys(3, np.array([0, 1], np.uint32))
    jkeys = jeng._row_keys(3, np.array([0, 1], np.uint32))
    step0 = ctx.copy()
    jfn = jeng.decode_multi_fn(2, 6, sampling=JaxSamplingConfig(**LANE))
    pfn = peng.decode_multi_fn(2, 6, sampling=SamplingConfig(**LANE))
    jg, jl, jeng.cache, _ = jfn(jeng.params, jeng.cache, jnp.asarray(jg[-1]),
                                jnp.asarray(tables), jnp.asarray(ctx), jkeys,
                                jnp.asarray(step0))
    pg2, pl2, _, _ = pfn(peng.params, peng.cache, pg[-1].numpy(), tables, ctx, keys, step0)
    sampled = (np.asarray(jg), pg2.numpy(), np.asarray(jl), pl2.numpy())
    return out, greedy, sampled


ENGINE_CASES = [(form, "per_channel") for form in sorted(FORMS)] + [
    (form, "group8") for form in sorted(FORMS)] + [("llama", "group4"), ("phi_2", "group4")]
QUANT = {"per_channel": PER_CHANNEL, "group8": GROUP8, "group4": GROUP4}


@pytest.mark.parametrize("form,quant", ENGINE_CASES)
def test_quantized_engine_matches_jax_engine(form, quant):
    over = FORMS[form]
    jeng, peng = _engines(over, QUANT[quant], STD[form])
    puts, greedy, sampled = _scripted(jeng, peng, over["vocab_size"])
    for lj, lp in puts:
        assert lp.shape == lj.shape
        np.testing.assert_allclose(lp, lj, **TOL)
        assert (lp.argmax(-1) == lj.argmax(-1)).all()
    for jg, pg, jl, pl_ in (greedy, sampled):
        np.testing.assert_array_equal(pg, jg)
        np.testing.assert_allclose(pl_, jl, **TOL)
    assert len(np.unique(greedy[1])) > 2 and len(np.unique(sampled[1])) > 2
    kinds = {type(x) for x in _flat(peng.params).values()}
    want = PQ.ChannelQuantWeight if quant == "per_channel" else PQ.QuantizedWeight
    assert want in kinds


# ---------------------------------------------------------------------------
# the engine's contract
# ---------------------------------------------------------------------------

def _serve(eng, prompt):
    return eng.put([0], [prompt.copy()])


def test_a_carried_int8_tree_serves_as_quantizing_in_the_engine():
    """The JAX package's quantized prepared tree (per-channel, and
    groupwise), carried across as numpy by params_from_numpy, serves the
    same logits as the port quantizing inside its engine (bit for bit: the
    same codes), and as the JAX engine serving that tree."""
    jc, pc = JT.TransformerConfig(**TINY), PT.TransformerConfig(**TINY)
    tree = numpy_params(jc, seed=11, std=0.3)
    prompt = np.random.default_rng(0).integers(0, 512, 21).astype(np.int32)
    prep = JM.prepare(to_jax(tree), jc)
    for quant, xform in ((PER_CHANNEL, lambda p: JM.quantize_prepared(p, jc)),
                         (GROUP8, lambda p: JQ.quantize_for_inference(p, 8, 64))):
        jtree = jax.jit(xform)(prep)
        carried = params_from_numpy(jax.tree.map(np.asarray, jtree), pc, device="cpu")
        engines = [
            init_inference(carried, pc, dict(SERVE), dtype=torch.float32, device="cpu"),
            init_inference(params_from_numpy(tree, pc, device="cpu"), pc, dict(SERVE),
                           dtype=torch.float32, device="cpu", quantization=dict(quant))]
        got = [_serve(e, prompt) for e in engines]
        np.testing.assert_array_equal(got[0], got[1])
        if "per_channel" in quant:  # a JAX tree of quantized leaves serves as given
            jeng = jax_init_inference(jtree, jc, dict(SERVE), dtype=jnp.float32)
            np.testing.assert_allclose(got[0], np.asarray(_serve(jeng, prompt)), **TOL)


def test_a_carried_bf16_tree_rounds_its_scales_as_the_jax_engine():
    """A carried tree served in bf16: the JAX engine's cast rounds each
    quantized leaf's scales to bf16; the port keeps them in f32 with the
    rounded values."""
    pc = PT.TransformerConfig(**TINY)
    params = params_from_numpy(numpy_params(JT.TransformerConfig(**TINY), seed=2), pc,
                               device="cpu")
    prep = PM.quantize_prepared(PM.prepare(params, pc), pc)
    eng = init_inference(prep, pc, dict(SERVE), device="cpu")
    w = eng.params["layers"][0]["w_qkv"]
    assert w.scale.dtype == torch.float32
    assert torch.equal(w.scale, prep["layers"][0]["w_qkv"].scale.bfloat16().float())
    assert torch.equal(w.q, prep["layers"][0]["w_qkv"].q)


def test_refresh_params_quantizes_again_and_drops_graphs():
    jc, pc = JT.TransformerConfig(**TINY), PT.TransformerConfig(**TINY)
    eng = init_inference(params_from_numpy(numpy_params(jc, seed=1), pc, device="cpu"), pc,
                         dict(SERVE), dtype=torch.float32, device="cpu",
                         quantization=dict(PER_CHANNEL))
    eng.graphs.programs["stale"] = object()  # as warmup() leaves a captured program
    fresh = params_from_numpy(numpy_params(jc, seed=2), pc, device="cpu")
    eng.refresh_params(fresh)
    assert len(eng.graphs) == 0
    want = PM.quantize_prepared(PM.prepare(fresh, pc), pc)
    for name in ("w_qkv", "wo", "w_gi", "w_out"):
        got = eng.params["layers"][1][name]
        assert isinstance(got, PQ.ChannelQuantWeight)
        assert torch.equal(got.q, want["layers"][1][name].q)
        assert torch.equal(got.scale, want["layers"][1][name].scale)
    assert isinstance(eng.params["embed"], PQ.ChannelQuantWeight)


@pytest.mark.parametrize("quant", ["per_channel", "group8"])
def test_warmup_on_a_quantized_engine(quant):
    """warmup() runs every decode program of the quantized engine over pad
    rows (the JAX warmup's program count) and changes no later decode."""
    jc, pc = JT.TransformerConfig(**TINY), PT.TransformerConfig(**TINY)
    tree = numpy_params(jc, seed=3, std=0.3)
    engines = [init_inference(params_from_numpy(tree, pc, device="cpu"), pc, dict(SERVE),
                              dtype=torch.float32, device="cpu",
                              quantization=dict(QUANT[quant])) for _ in range(2)]
    jeng = jax_init_inference(to_jax(tree), jc, dict(SERVE), dtype=jnp.float32,
                              quantization=dict(QUANT[quant]))
    rep = engines[0].warmup(widths=[8, 16], decode_chunks=(4,))
    assert rep["programs"] == jeng.warmup(widths=[8, 16], decode_chunks=(4,))["programs"]
    assert rep["graphs"] == 0  # the CPU has no graphs
    prompt = np.random.default_rng(1).integers(0, 512, 30).astype(np.int32)
    for step in range(3):
        got = [e.put([0], [prompt.copy()] if step == 0 else [np.array([step], np.int32)])
               for e in engines]
        np.testing.assert_array_equal(got[0], got[1])


def test_row_scales_and_round_trip_error():
    """Twins of tests/test_inference.py's: the embedding's row scales, and
    a per-channel round trip within absmax / 127."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(64, 8, 16)).astype(np.float32))
    cq = PQ.channel_quantize(w, 1)
    deq = cq.codes().float() * cq.scales()[None]
    assert (deq - w).abs().max() <= w.abs().max() / 127 + 1e-6
    assert cq.q.dtype == torch.int8 and cq.scales().shape == (8, 16)
    e = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
    eq = PQ.channel_quantize(e, 1, scale_first=True)
    assert eq.scale.shape == (32,)
    np.testing.assert_allclose((eq.codes().float() * eq.scale[:, None]).numpy(), e.numpy(),
                               atol=float(e.abs().max()) / 127 + 1e-6)


def _small():
    over = dict(vocab_size=128, n_layers=2, n_heads=4, d_model=64, max_seq=128,
                variant="llama")
    cfg = PT.TransformerConfig(**over)
    params = params_from_numpy(numpy_params(JT.TransformerConfig(**over), seed=0), cfg,
                               device="cpu")
    icfg = dict(max_seq_len=64, kv_block_size=8, num_kv_blocks=32, min_prefill_bucket=8,
                max_batch_size=8)
    return cfg, params, icfg


def test_per_channel_memory_below_045_of_f32():
    cfg, params, icfg = _small()
    full = init_inference(params, cfg, dict(icfg), dtype=torch.float32, device="cpu")
    q8 = init_inference(params, cfg, dict(icfg), dtype=torch.float32, device="cpu",
                        quantization=dict(PER_CHANNEL))
    assert isinstance(q8.params["layers"][0]["w_qkv"], PQ.ChannelQuantWeight)
    assert isinstance(q8.params["embed"], PQ.ChannelQuantWeight)
    assert PQ.quantized_nbytes(q8.params) < 0.45 * PQ.quantized_nbytes(full.params)


@pytest.mark.parametrize("quantization,exc,match", [
    ({"bits": 4, "per_channel": True}, ValueError, "int8-only"),
    ({"bits": 8, "per_channel": True, "bogus": 1}, TypeError, "bogus"),
    ({"bits": 8, "groups": 64}, TypeError, "groups"),
    ({"bits": 3}, ValueError, "4 or 8"),
])
def test_quantization_keys_checked_as_the_jax_engine(quantization, exc, match):
    cfg, params, icfg = _small()
    with pytest.raises(exc, match=match):
        init_inference(params, cfg, dict(icfg), device="cpu", quantization=quantization)


@pytest.mark.parametrize("quantization", [None, PER_CHANNEL, GROUP8])
def test_offload_still_raises_naming_its_item(quantization):
    cfg, params, icfg = _small()
    with pytest.raises(NotImplementedError, match="A14"):
        init_inference(params, cfg, dict(icfg), device="cpu", quantization=quantization,
                       offload={"device": "cpu"})
    with pytest.raises(NotImplementedError, match="A11"):
        init_inference(params, cfg, dict(icfg, tp_size=2), device="cpu",
                       quantization=quantization)


# ---------------------------------------------------------------------------
# the W8A16 GEMM's split plan
# ---------------------------------------------------------------------------

# (M, N, K): decode and prefill products of the flagship (d 1024, 8 x 128
# heads over 8, vocab 32000), Llama-2-7B, Falcon-7B (K 4544, N 4672) and
# BLOOM-7B1's vocab
PLAN_SHAPES = [(M, N, K) for M in (1, 8, 32, 64, 512, 4096)
               for N, K in ((3072, 1024), (1024, 1024), (5632, 1024), (1024, 2816),
                            (32000, 1024), (12288, 4096), (4096, 4096), (22016, 4096),
                            (4096, 11008), (4672, 4544), (4544, 4544), (250880, 4096))]


@pytest.mark.parametrize("M", [1, 8, 32, 64, 512, 4096])
def test_split_plan_rules(M):
    for m, N, K in PLAN_SHAPES:
        if m != M:
            continue
        plan = PI.matmul_split_plan(M, N, K, 132)
        small = N * K <= PI.SMALL_CODE_BYTES and M <= 64
        assert plan.bm == (16 if small else PI.block_rows(M))
        assert plan.bm >= min(M, 128) or small
        assert plan.split_len % PI.BK == 0 and 1 <= plan.n <= PI.MAX_SPLITS
        assert (plan.n - 1) * plan.split_len < K <= plan.n * plan.split_len  # none empty
        assert plan.tiles == -(-M // plan.bm) * -(-N // PI.BN)
        assert plan.ctas == plan.tiles * plan.n
        if plan.n > 1:
            assert plan.ctas <= PI.resident_ctas(plan.bm) * 132  # one wave
            assert plan.scratch_shape == (plan.n, M, N)
            if not small:
                assert 2 * plan.scratch_bytes <= N * K / 2 + 1  # partials <= half the codes
                assert plan.split_len >= PI.MIN_SPLIT_CHUNKS * PI.BK
        else:
            assert plan.scratch_bytes == 0
    if M >= 512:  # prefill: enough tiles, never split
        assert all(PI.matmul_split_plan(m, N, K, 132).n == 1
                   for m, N, K in PLAN_SHAPES if m == M and N >= 1024)


def test_split_plan_pins():
    """Llama-2-7B's decode splits: one wave of resident CTAs (3 of 16 or
    32 rows an SM, 2 of 64, 1 of 128, by shared memory), at least 512 deep,
    the partials at most half the codes' bytes."""
    assert [PI.resident_ctas(bm) for bm in (16, 32, 64, 128)] == [3, 3, 2, 1]
    assert PI.matmul_split_plan(8, 12288, 4096, 132)[:3] == (16, 4, 1024)
    assert PI.matmul_split_plan(8, 4096, 4096, 132)[:3] == (16, 8, 512)
    assert PI.matmul_split_plan(8, 4096, 11008, 132)[:3] == (16, 8, 1408)
    assert PI.matmul_split_plan(8, 32000, 4096, 132)[:3] == (16, 1, 4096)
    assert PI.matmul_split_plan(64, 4096, 4096, 132)[:3] == (64, 4, 1024)


def test_split_plan_small_codes():
    """The flagship's decode products (codes of at most 8 MB): 16-row CTAs
    at every decode width and splits down to one 128-deep slice; prefill
    and the 32 MB tied logits keep the large-code rule."""
    assert PI.matmul_split_plan(8, 3072, 1024, 132)[:3] == (16, 8, 128)
    assert PI.matmul_split_plan(64, 3072, 1024, 132)[:3] == (16, 4, 256)
    assert PI.matmul_split_plan(64, 1024, 2816, 132)[:3] == (16, 8, 384)
    assert PI.matmul_split_plan(64, 32000, 1024, 132)[:3] == (64, 1, 1024)
    assert PI.matmul_split_plan(512, 1024, 1024, 132)[:3] == (128, 1, 1024)
    assert PI.matmul_split_plan(512, 12288, 4096, 132)[:2] == (128, 1)


def test_the_gemm_is_a_registered_kernel():
    assert PK.WRAPPERS["int8_matmul"] is PI.int8_matmul
    assert "int8_matmul" in PK.launch_counts()
