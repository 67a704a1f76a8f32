"""GPT-NeoX- and GPT-J-class serving of the port held against the JAX package
on the CPU, from the same numpy-made inputs.

The port's plain versions (what its wrappers run on CPU tensors, and what
its CUDA kernels are held against on the card by tests/test_torch_cuda.py
and chip_smoke.py) against the JAX package's functions, run as its own
tests run them here: Pallas kernels in interpret mode, beside their XLA
oracles. The two modes of this slice: head_dim 96 (GPT-NeoX-20B: 64 heads
of 96) and head_dim 256 (GPT-J-6B: 16 heads of 256).

- the paged writes at D 96 and 256: the bf16 write against the
  interpret-mode JAX paged_kv_write, the int8 write (codes and scales)
  against the JAX package's _write_kv_quant, bit for bit, and the
  quantizer against the JAX quantize_kv_rows with .5 ties and zero rows;
- paged decode in all four modes (f32 and int8 pools, plain and fused) at
  D 96 and 256, with and without GQA: against the interpret-mode JAX
  paged_decode_attention (its fused mode with k_new: the route the JAX
  package takes at D 96, where paged_decode_fused's D % 128 == 0 fails),
  paged_decode_fused (#5, the route at D 256 on bf16 pools) and
  paged_decode_attention_xla, at 5e-5 (KERNEL_VS_ORACLE_ATOL of
  tests/test_torch_paged_quant.py); the fused modes' written rows (codes
  and scales on int8) bit-identical;
- the flash forward (o and lse) at D 96 and 256, with GQA, against the
  interpret-mode JAX kernel and `_xla_attention` at 2e-4
  (tests/test_flash_attention.py's pin);
- a tiny GPT-NeoX form (two LayerNorms, partial rotary 0.25 in split
  halves, biases) and a tiny GPT-J form (interleaved partial rotary, one
  shared LayerNorm, an lm_head bias) as engines against the JAX engine
  (its XLA decode route), both on f32 pools and the GPT-J form on int8
  pools: prefill, decode, chunked continuation, prefix hit and decode_multi,
  logits within 1e-4 on f32 pools and 2e-3 on int8 pools (the tolerances
  the window and ALiBi engine tests pin), greedy tokens identical; the
  interleaved rotary bites (the GPT-J form read with split halves gives
  other logits);
- rotary scaling: the port's rope_inv_freq and _rope_at with no scaling,
  "linear" and "llama3", split-halves and interleaved pairs, whole and
  partial rotary, against the JAX rope_inv_freq and _rope in f32;
- params_from_numpy on both families' trees; chip_smoke.py's GPT_NEOX_20B
  and GPT_J_6B against the JAX package's config_from_hf of
  EleutherAI/gpt-neox-20b's and EleutherAI/gpt-j-6b's config.json
  (20,554,567,680 and 6,050,882,784 parameters in both packages);
- both forms train on the CPU through the plain versions (check_trained,
  make_loss_fn); their training is held against the JAX package in
  tests/test_torch_neox_gptj_train.py, and the flash backward kernels at
  D 96 and 256 on the card in tests/test_torch_cuda.py.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (GPT_J_TINY, NEOX_GPTJ as MODELS, NEOX_GPTJ_STD as STD, SERVE,
                           numpy_params, to_jax)
from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.inference import model as JM
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import attention as JA
from deepspeed_tpu.ops.pallas import flash_attention as JF
from deepspeed_tpu.ops.pallas import paged_attention as JP
from deepspeed_tpu.utils.hf_checkpoint import config_from_hf
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.inference import model as PM
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops.cuda import flash_attention as PF
from deepspeed_tpu_torch.ops.cuda import paged_attention as PP
from deepspeed_tpu_torch.utils.convert import params_from_numpy
from deepspeed_tpu_torch.utils.tree import leaves

FLASH_TOL = dict(rtol=2e-4, atol=2e-4)
KERNEL_VS_ORACLE_ATOL = 5e-5
TOL = {"auto": dict(rtol=1e-4, atol=1e-4), "int8": dict(rtol=2e-3, atol=2e-3)}
# the engines' weight seeds: at the Falcon/Phi tests' seed 7 the GPT-NeoX
# form's greedy tokens settle on one token after the first step, which
# would leave the token-identity check little to compare
SEED = {"gpt_neox": 1, "gpt_j": 7}
# EleutherAI/gpt-neox-20b and EleutherAI/gpt-j-6b config.json, the values
# config_from_hf reads
GPT_NEOX_20B_HF = {"architectures": ["GPTNeoXForCausalLM"], "vocab_size": 50432,
                   "hidden_size": 6144, "intermediate_size": 24576, "num_hidden_layers": 44,
                   "num_attention_heads": 64, "max_position_embeddings": 2048,
                   "hidden_act": "gelu_fast", "use_parallel_residual": True,
                   "rotary_pct": 0.25, "rotary_emb_base": 10000, "layer_norm_eps": 1e-05,
                   "tie_word_embeddings": False}
GPT_J_6B_HF = {"architectures": ["GPTJForCausalLM"], "vocab_size": 50400, "n_embd": 4096,
               "n_head": 16, "n_layer": 28, "n_inner": None, "n_positions": 2048,
               "rotary_dim": 64, "layer_norm_epsilon": 1e-05,
               "activation_function": "gelu_new", "tie_word_embeddings": False}


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_bh(x):
    B, S, h, D = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * h, S, D)


def _int8_rows(rng, shape):
    """Rows [T, KV, D]: unit normal, the first two .5 ties (absmax 127:
    scale exactly 1), the third zeros."""
    x = rng.standard_normal(shape).astype(np.float32)
    x[:2] = rng.integers(-126, 126, (2,) + shape[1:]) + 0.5
    x[:2, :, -1] = 127.0
    x[2] = 0.0
    return x


# ---------------------------------------------------------------------------
# the paged writes and the quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [96, 256])
def test_int8_quantizer_is_the_jax_one(rng, D):
    """quantize_kv_rows at head_dim 96 and 256 bit-identical to the JAX
    package's, .5 ties and zero rows included."""
    x = _int8_rows(rng, (24, 3, D))
    want = [np.asarray(a) for a in JP.quantize_kv_rows(jnp.asarray(x), jnp.asarray(-x))]
    got = PP.quantize_kv_rows(_t(x), _t(-x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("D", [96, 256])
def test_plain_writes_match_jax(rng, D):
    """The plain bf16 write against the interpret-mode JAX paged_kv_write
    (#6), the plain int8 write against the JAX package's _write_kv_quant
    (the codes through paged_kv_write, the scales through
    paged_scale_write), bit for bit, with dropped rows; the CPU wrappers
    are the plain versions."""
    NBLK, bs, KV, T = 6, 16, 2, 21
    slots = rng.permutation(NBLK * bs)[:T].astype(np.int32)
    slots[5::6] = -1
    kn, vn = _int8_rows(rng, (T, KV, D)), _int8_rows(rng, (T, KV, D))[::-1].copy()
    kc, vc = (rng.standard_normal((NBLK, bs, KV, D)).astype(np.float32) for _ in range(2))
    jk, jv = JP.paged_kv_write(*(jnp.asarray(a) for a in (kc, vc, kn, vn, slots)))
    pk, pv = _t(kc), _t(vc)
    assert PP.paged_kv_write(pk, pv, _t(kn), _t(vn), _t(slots))[0] is pk
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    qk, ks, qv, vs = JP.quantize_kv_rows(jnp.asarray(kc.reshape(-1, KV, D)),
                                         jnp.asarray(vc.reshape(-1, KV, D)))
    pools = [np.asarray(qk).reshape(kc.shape), np.asarray(qv).reshape(kc.shape),
             np.asarray(ks).reshape(NBLK, bs, KV), np.asarray(vs).reshape(NBLK, bs, KV)]
    want = jax.jit(JM._write_kv_quant)(*(jnp.asarray(a) for a in (*pools, kn, vn, slots)))
    got = [_t(p) for p in pools]
    PP.paged_kv_write_int8(*got, _t(kn), _t(vn), _t(slots))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# paged decode at head_dim 96 and 256
# ---------------------------------------------------------------------------

def _decode_case(rng, H, KV, D, quant, S=4, bs=16, NB=12, NBLK=52):
    """Rows: ctx 5, 130 (mid-block), 190 and a pad row (ctx 0); f32 pools
    or int8 codes and scales made by the JAX package's quantize_kv_rows."""
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    kf = rng.standard_normal((NBLK, bs, KV, D)).astype(np.float32)
    vf = rng.standard_normal((NBLK, bs, KV, D)).astype(np.float32)
    if quant:
        qk, ks, qv, vs = (np.asarray(a) for a in JP.quantize_kv_rows(
            jnp.asarray(kf.reshape(-1, KV, D)), jnp.asarray(vf.reshape(-1, KV, D))))
        pools = (qk.reshape(kf.shape), qv.reshape(kf.shape), ks.reshape(NBLK, bs, KV),
                 vs.reshape(NBLK, bs, KV))
    else:
        pools = (kf, vf)
    tbl = rng.permutation(NBLK - 1)[:S * NB].reshape(S, NB).astype(np.int32)
    tbl[S - 1] = NBLK - 1  # the pad row's table points at a scratch block
    ctx = np.array([5, 130, 190, 0], np.int32)[:S]
    return q, pools, tbl, ctx


def _jscale(pools):
    return dict(zip(("k_scale", "v_scale"), (jnp.asarray(s) for s in pools[2:])))


# (H, KV, D): a GQA group at D 96, GPT-J's MHA at D 256 (the engines below
# run GPT-NeoX's MHA at 96)
DECODE_SHAPES = {"gqa_d96": (8, 2, 96), "mha_d256": (2, 2, 256)}


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
def test_decode_plain_matches_jax_kernel_and_oracle(rng, quant, shape):
    H, KV, D = DECODE_SHAPES[shape]
    q, pools, tbl, ctx = _decode_case(rng, H, KV, D, quant)
    j = [jnp.asarray(a) for a in (q, *pools[:2], tbl, ctx)]
    with jax.default_matmul_precision("highest"):
        kern = JP.paged_decode_attention(*j, **_jscale(pools))
        oracle = JP.paged_decode_attention_xla(*j, **_jscale(pools))
    args = [_t(a) for a in (q, *pools[:2], tbl, ctx)]
    scales = [_t(s) for s in pools[2:]]
    out = PP.paged_decode_attention_plain(*args, *scales)
    live = ctx > 0  # the JAX versions leave pad rows as garbage
    for ref in (kern, oracle):
        np.testing.assert_allclose(out.numpy()[live], np.asarray(ref)[live],
                                   atol=KERNEL_VS_ORACLE_ATOL, rtol=0)
    assert not out.numpy()[~live].any()
    # the wrappers on CPU tensors are the plain versions
    wrap = PP.paged_decode_attention_int8 if quant else PP.paged_decode_attention
    assert torch.equal(wrap(*args, *scales), out)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
def test_decode_fused_matches_jax_fused_modes(rng, quant, shape):
    """The fused write+attend mode against #4's fused mode of the JAX
    package (paged_decode_attention with k_new: its engine's route at D 96
    and on int8 pools) and, at D 256 on f32 pools, against
    paged_decode_fused (#5: its engine's route there): the written rows
    (codes and scales on int8) bit-identical, the outputs within
    KERNEL_VS_ORACLE_ATOL of each JAX kernel and of the oracle over its
    written pools."""
    H, KV, D = DECODE_SHAPES[shape]
    q, pools, tbl, ctx = _decode_case(rng, H, KV, D, quant)
    S, bs = q.shape[0], pools[0].shape[1]
    kn, vn = (rng.standard_normal((S, KV, D)).astype(np.float32) for _ in range(2))
    pos = np.maximum(ctx - 1, 0)
    slots = np.where(ctx > 0, tbl[np.arange(S), pos // bs] * bs + pos % bs, -1).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (q, *pools[:2], tbl, ctx, kn, vn, slots)]
    refs = []
    with jax.default_matmul_precision("highest"):
        ref, *jpools = JP.paged_decode_attention(
            *jargs[:5], k_new=jargs[5], v_new=jargs[6], slots=jargs[7], **_jscale(pools))
        refs.append(ref)
        if not quant and JP.supports_fused_v2(D):
            ref5, *jpools5 = JP.paged_decode_fused(*jargs)
            refs.append(ref5)
            for a, b in zip(jpools5, jpools):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        refs.append(JP.paged_decode_attention_xla(
            jargs[0], *jpools[:2], jargs[3], jargs[4],
            **(dict(k_scale=jpools[2], v_scale=jpools[3]) if quant else {})))
    assert len(refs) == (3 if not quant and D == 256 else 2)
    ppools = [_t(a.copy()) for a in pools]
    fused = PP.paged_decode_fused_int8 if quant else PP.paged_decode_fused
    out, *written = fused(_t(q), ppools[0], ppools[1], _t(tbl), _t(ctx), _t(kn), _t(vn),
                          _t(slots), *ppools[2:])
    assert all(w is p for w, p in zip(written, ppools))  # in place
    for w, g in zip(jpools, ppools):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    live = ctx > 0
    for r in refs:
        np.testing.assert_allclose(out.numpy()[live], np.asarray(r)[live],
                                   atol=KERNEL_VS_ORACLE_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

FLASH_CASES = {"d96_gqa": (8, 2, 96), "d256_gqa": (4, 1, 256)}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax_kernel_and_xla(rng, case):
    H, KV, D = FLASH_CASES[case]
    B, S = 1, 100  # S no multiple of the 64-row blocks
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    with jax.default_matmul_precision("highest"):
        jo, jlse = JF._flash_fwd(_to_bh(q), _to_bh(k), _to_bh(v), None, True, 64, 64, H, KV)
        xla = JA._xla_attention(q, JA._repeat_kv(k, H // KV), JA._repeat_kv(v, H // KV))
    o, lse = PF.flash_attention_plain(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo).reshape(B, H, S, D)
                               .transpose(0, 2, 1, 3), **FLASH_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(B, H, S), **FLASH_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(xla), **FLASH_TOL)
    # the CPU wrapper is the plain version
    fo, flse = PF.flash_fwd(_t(q), _t(k), _t(v))
    assert torch.equal(fo, o) and torch.equal(flse, lse)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _pool_arrays(cache):
    return [np.asarray(a) for a in cache.k + cache.v + list(cache.k_scale or [])
            + list(cache.v_scale or [])]


def _sync(peng, jeng):
    """Copy the JAX engine's pools into the port's (int8: one code flips at
    a .5 boundary now and then between the two frameworks' f32 k/v)."""
    c = peng.cache
    for dst, src in zip(c.k + c.v + list(c.k_scale or []) + list(c.v_scale or []),
                        _pool_arrays(jeng.cache)):
        dst.copy_(_t(src))


def _scripted(model, kv_cache_dtype):
    """The same put() sequence on a JAX and a port engine: a 33-token
    prompt beside a 40-token one, 4 greedy single-token decodes of the
    first (the fused mode), then in one put a 3-token continuation of the
    second (the plain decode mode) beside a prefix hit on the second's
    first two blocks (a 5-token suffix through the plain decode mode), and
    greedy decode_multi. int8 pools start each put from the JAX engine's
    pools. The JAX engine decodes through its XLA oracle (decode_impl
    "xla"): its interpret-mode kernels would double the file's time, and
    the tests above hold the port's plain decode against those kernels in
    all four modes."""
    over = MODELS[model]
    jc, pc = JT.TransformerConfig(**over), PT.TransformerConfig(**over)
    tree = numpy_params(jc, seed=SEED[model], std=STD[model])
    cfg = dict(SERVE, kv_cache_dtype=kv_cache_dtype)
    jeng = jax_init_inference(to_jax(tree), jc, dict(cfg, decode_impl="xla"),
                              dtype=jnp.float32)
    peng = init_inference(params_from_numpy(tree, pc, device="cpu"), pc, cfg,
                          dtype=torch.float32, device="cpu")
    quant = kv_cache_dtype == "int8"
    r = np.random.default_rng(13)
    p0, p1 = (r.integers(0, 512, n).astype(np.int32) for n in (33, 40))
    out = {"prefill": [], "decode": [], "chunk": [], "prefix_hit": []}

    def put(name, uids, toks):
        if quant:
            _sync(peng, jeng)
        lj = np.asarray(jeng.put(uids, [t.copy() for t in toks]))
        lp = peng.put(uids, [t.copy() for t in toks])
        out[name].append((lj, lp))
        return lj, lp

    lj, lp = put("prefill", [0, 1], [p0, p1])
    for _ in range(4):
        tok = int(np.argmax(lj[0]))
        assert tok == int(np.argmax(lp[0]))
        lj, lp = put("decode", [0], [np.array([tok], np.int32)])
    # one put: uid 1's continuation beside the prefix hit of uid 2
    if quant:
        _sync(peng, jeng)
    toks = [r.integers(0, 512, 3).astype(np.int32),
            np.concatenate([p1[:32], r.integers(0, 512, 5)]).astype(np.int32)]
    lj = np.asarray(jeng.put([1, 2], [t.copy() for t in toks]))
    lp = peng.put([1, 2], [t.copy() for t in toks])
    out["chunk"].append((lj[:1], lp[:1]))
    out["prefix_hit"].append((lj[1:], lp[1:]))
    if quant:
        _sync(peng, jeng)
    uids = [0, 1]
    tables = peng.state.block_table(uids, peng.config.blocks_per_seq, peng.pad_block)
    ctx = np.array([peng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
    toks = np.array([7, 8], np.int32)
    jg, jl, jeng.cache, _ = jeng.decode_multi_fn(2, 8)(  # the JAX call donates its cache
        jeng.params, jeng.cache, jnp.asarray(toks), jnp.asarray(tables), jnp.asarray(ctx))
    pg, pl_, _, _ = peng.decode_multi_fn(2, 8)(peng.params, peng.cache, toks, tables, ctx)
    out["decode_multi"] = (np.asarray(jg), pg.numpy(), np.asarray(jl), pl_.numpy())
    out["stats"] = (jeng.prefix_cache_stats(), peng.prefix_cache_stats())
    out["kv_cache_dtype"] = kv_cache_dtype
    return out


# both forms on f32 pools, the GPT-J form (D 256) on int8 pools too: the
# engine's int8 lane is the same code for either form, and a JAX int8
# engine's compiles cost ~8 s here (the file keeps inside a minute); the
# int8 write and decode at D 96 are held above
@pytest.fixture(scope="module", params=[("gpt_j", "auto"), ("gpt_j", "int8"),
                                        ("gpt_neox", "auto")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def scripted_run(request):
    return _scripted(*request.param)


@pytest.mark.parametrize("step", ["prefill", "decode", "chunk", "prefix_hit"])
def test_engine_put_logits_match_jax_engine(scripted_run, step):
    assert scripted_run[step]
    tol = TOL[scripted_run["kv_cache_dtype"]]
    for lj, lp in scripted_run[step]:
        assert lp.shape == lj.shape
        np.testing.assert_allclose(lp, lj, **tol)
        assert (lp.argmax(-1) == lj.argmax(-1)).all()


def test_engine_decode_multi_tokens_identical(scripted_run):
    jg, pg, jl, pl_ = scripted_run["decode_multi"]
    assert pg.shape == (8, 2)
    np.testing.assert_array_equal(pg, jg)
    assert len(np.unique(pg)) > 3  # the tokens actually move
    np.testing.assert_allclose(pl_, jl, **TOL[scripted_run["kv_cache_dtype"]])


def test_engine_prefix_hit_was_taken(scripted_run):
    sj, sp = scripted_run["stats"]
    assert sp["lookup_hits"] == sj["lookup_hits"] == 1
    assert sp["cached_tokens"] == sj["cached_tokens"] == 32


def _put_logits(over, tree):
    cfg = PT.TransformerConfig(**over)
    eng = init_inference(params_from_numpy(tree, cfg, device="cpu"), cfg, SERVE,
                         dtype=torch.float32, device="cpu")
    return eng.put([0], [np.arange(30, dtype=np.int32) * 7])


def test_interleaved_rotary_bites():
    """The GPT-J form's weights served with split-halves rotary pairs give
    other logits, by far more than the 1e-4 tolerance above: the GPT-J
    runs above hold the interleaved pairing (rotate_every_two) against the
    JAX package's, not a pairing both would share by default."""
    tree = numpy_params(JT.TransformerConfig(**GPT_J_TINY), seed=7, std=STD["gpt_j"])
    a = _put_logits(GPT_J_TINY, tree)
    b = _put_logits(dict(GPT_J_TINY, rope_interleaved=False), tree)
    assert np.abs(a - b).max() > 1e-2


# ---------------------------------------------------------------------------
# rotary scaling
# ---------------------------------------------------------------------------

ROPE_SCALING = {"none": {}, "linear": dict(rope_scaling_type="linear", rope_scaling_factor=4.0),
                "llama3": dict(rope_scaling_type="llama3", rope_scaling_factor=8.0,
                               rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
                               rope_original_max_seq=64)}


@pytest.mark.parametrize("interleaved", [False, True], ids=["split", "interleaved"])
@pytest.mark.parametrize("scaling", sorted(ROPE_SCALING))
def test_rope_matches_jax(rng, scaling, interleaved):
    """rope_inv_freq and the rotation of q and k at positions 0..299 (past
    the llama3 rule's original 64, so its three bands all occur) against
    the JAX package's rope_inv_freq and _rope, within f32 rounding (the
    angles reach ~300 rad, where an ulp of the f32 angle is 3e-5), with
    partial rotary (32 of 64 dims; the rest pass through unchanged)."""
    over = dict(n_heads=4, d_model=256, rope_theta=10000.0, rotary_pct=0.5,
                rope_interleaved=interleaved, **ROPE_SCALING[scaling])
    jc = JT.TransformerConfig(**{**MODELS["gpt_neox"], **over})
    pc = PT.TransformerConfig(**{**MODELS["gpt_neox"], **over})
    np.testing.assert_allclose(PT.rope_inv_freq(pc).numpy(), np.asarray(JT.rope_inv_freq(jc)),
                               rtol=1e-6, atol=0)
    if scaling == "llama3":  # the three bands all occur
        inv = PT.rope_inv_freq(dataclasses.replace(pc, rope_scaling_type="none"))
        wavelen = 2 * math.pi / inv
        assert (wavelen < 64 / 4.0).any() and (wavelen > 64 / 1.0).any()
        assert ((wavelen >= 16) & (wavelen <= 64)).any()
    S = 300
    q = rng.standard_normal((1, S, 4, 64)).astype(np.float32)
    k = rng.standard_normal((1, S, 4, 64)).astype(np.float32)
    jq, jk = JT._rope(jnp.asarray(q), jnp.asarray(k), jc)
    rope = PT._rope_tables(torch.arange(S), pc)
    for got, want in ((PT._rope_at(_t(q), rope, pc), jq), (PT._rope_at(_t(k), rope, pc), jk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    R = PT.rope_dim(pc)
    np.testing.assert_array_equal(PT._rope_at(_t(q), rope, pc).numpy()[..., R:], q[..., R:])


def test_head_dim_counters():
    """The d96 and d256 counters sit on every flash kernel (#1, and the
    backward kernels #2 and #3, which take both widths) and on the serving
    kernels (both writes of #6, the four decode modes of #4/#5), at 0 where
    no kernel launched."""
    from deepspeed_tpu_torch.ops import cuda as PK

    want = {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_kv_write",
            "paged_kv_write_int8", "paged_decode_fused", "paged_decode_attention",
            "paged_decode_fused_int8", "paged_decode_attention_int8"}
    for mode in ("d96", "d256"):
        assert set(PK.MODES[mode]) == want
        assert set(PK.mode_launch_counts(mode).values()) == {0}
    assert PF._HEAD_DIMS == (64, 80, 96, 128, 256)  # forward and backward alike
    assert PP._DECODE_HEAD_DIMS == (64, 80, 96, 128, 256)


# ---------------------------------------------------------------------------
# parameters, configs, training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_params_from_numpy_takes_the_family_leaves(name):
    """Every leaf carried across as it is: GPT-NeoX's two LayerNorms and
    its q/k/v, output and MLP biases; GPT-J's shared LayerNorm (no ln2
    leaves), its MLP biases without attention biases, its lm_head_b. The
    serving layout fuses the q/k/v biases where there are any."""
    over = MODELS[name]
    jc, pc = JT.TransformerConfig(**over), PT.TransformerConfig(**over)
    tree = numpy_params(jc, seed=4)
    got = params_from_numpy(tree, pc, device="cpu")
    flat = {**{k: v for k, v in got.items() if k != "layers"},
            **{f"layers/{k}": v for k, v in got["layers"].items()}}
    assert set(flat) == set(PT._param_shapes(pc))
    want = {**{k: v for k, v in tree.items() if k != "layers"},
            **{f"layers/{k}": v for k, v in tree["layers"].items()}}
    assert set(flat) == set(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(flat[path].numpy(), arr)
    layer = set(got["layers"])
    assert ("ln2_scale" in layer) == ("ln2_bias" in layer) == (name == "gpt_neox")
    assert ({"bq", "bk", "bv", "bo"} <= layer) == (name == "gpt_neox")
    assert {"b_in", "b_out", "ln1_scale", "ln1_bias"} <= layer
    assert ("lm_head_b" in flat) == (name == "gpt_j") and "lm_head" in flat
    assert PT.param_count(pc) == _jax_param_count(jc)
    lp = PM.prepare(got, pc)["layers"][0]
    assert ("b_qkv" in lp) == (name == "gpt_neox") and "wq" not in lp


@pytest.mark.parametrize("name", sorted(MODELS))
def test_served_and_trained_on_the_cpu(name):
    """Both forms are served (unported_features empty, check_served) and
    pass check_trained: one loss and backward through the plain versions
    on the CPU is finite and reaches every leaf. (The flash backward
    kernels at D 96 and 256 on the card: tests/test_torch_cuda.py.)"""
    cfg = PT.TransformerConfig(**MODELS[name])
    assert PT.unported_features(cfg) == []
    PM.check_served(cfg)
    PT.check_trained(cfg)
    params = params_from_numpy(numpy_params(JT.TransformerConfig(**MODELS[name]), seed=3,
                                            std=STD[name]), cfg, device="cpu")
    live = [p.requires_grad_() for p in leaves(params)]
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    loss = PT.make_loss_fn(cfg, loss_chunks=4)(params, {"tokens": tokens}, None)
    grads = torch.autograd.grad(loss, live)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() and g.abs().max() > 0
                                        for g in grads)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_param_count(cfg):
    """The JAX package's parameter count from the shapes its init makes,
    summed in Python ints (its own param_count multiplies each leaf's
    shape in int32, which wraps at these sizes)."""
    shapes = jax.tree.leaves(jax.eval_shape(lambda k: JT.init(cfg, k), jax.random.PRNGKey(0)))
    return sum(math.prod(s.shape) for s in shapes)


@pytest.mark.parametrize("name,hf,n_params,shape,kv_bytes", [
    ("GPT_NEOX_20B", GPT_NEOX_20B_HF, 20_554_567_680, (96, 64, 24576, 24), 1_081_344),
    ("GPT_J_6B", GPT_J_6B_HF, 6_050_882_784, (256, 16, 16384, 64), 458_752),
])
def test_chip_smoke_config_is_config_from_hf(name, hf, n_params, shape, kv_bytes):
    """chip_smoke.py's GPT_NEOX_20B and GPT_J_6B dicts are, field by field,
    the JAX package's config_from_hf of the published config.json, count
    the same parameters in both packages and the KV bytes a token that
    their comments give."""
    want = config_from_hf(hf)
    got = PT.TransformerConfig(**getattr(_chip_smoke(), name))
    for f in dataclasses.fields(JT.TransformerConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert PT.param_count(got) == _jax_param_count(want) == n_params
    assert (got.head_dim, got.kv_heads, got.ff_dim, PT.rope_dim(got)) == shape
    assert got.n_layers * 2 * got.kv_heads * got.head_dim * 2 == kv_bytes
    assert PT.unported_features(got) == []
