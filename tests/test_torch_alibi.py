"""ALiBi (Bloom-class) serving of the port held against the JAX package on
the CPU, from the same numpy-made inputs.

The port's plain versions (what its wrappers run on CPU tensors, and what
its CUDA kernels are held against on the card by tests/test_torch_cuda.py
and chip_smoke.py) against the JAX package's functions, run as its own
tests run them here: Pallas kernels in interpret mode, beside their XLA
oracles. ALiBi rule: in prefill the score of query row r and key column c
of head h gains slope_h * (c - r); in decode, slope_h * c with c the
absolute key position (the one query sits at ctx - 1).

- alibi_slopes bit-equal to the JAX function (power-of-two and other head
  counts), model_alibi_slopes with falcon-rw's 1/sqrt(head_dim) scale;
- flash forward (o and lse) with slopes against the interpret-mode JAX
  kernel and `_xla_attention(alibi=)` at 2e-4 (tests/test_flash_attention.py
  TestAlibi's pin), GQA and ALiBi with a window included; the flash
  path's ALiBi gradient against the dense path's, and check_trained
  accepting both tiny configs (ALiBi training is held against the JAX
  package in tests/test_torch_alibi_train.py);
- paged decode, plain and fused, on f32 and int8 pools, with slopes,
  against the interpret-mode JAX kernels and `paged_decode_attention_xla`
  at 5e-5 (KERNEL_VS_ORACLE_ATOL of tests/test_torch_paged_quant.py); the
  fused modes' written rows (codes and scales on int8) bit-identical;
- a tiny Bloom-class engine (gpt2 variant, ALiBi, LayerNorm, biases, tanh
  GELU, embedding LayerNorm, head_dim 128) and a tiny falcon-rw-class one
  (llama variant, LayerNorm, erf GELU, biases, alibi_slope_scale, head_dim
  64) against the JAX engine: prefill, decode, chunked continuation,
  prefix hit and decode_multi, greedy tokens identical and logits within
  1e-4 in f32; the same on int8 pools, each put starting from the JAX
  engine's pools (tests/test_torch_paged_quant.py says why);
- params_from_numpy on the Bloom leaves, and chip_smoke.py's BLOOM-7B1
  config against the JAX package's config_from_hf of its config.json
  (7,069,016,064 parameters in both packages).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SERVE, TINY, numpy_params, to_jax
from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import attention as JA
from deepspeed_tpu.ops.pallas import flash_attention as JF
from deepspeed_tpu.ops.pallas import paged_attention as JP
from deepspeed_tpu.utils.hf_checkpoint import config_from_hf
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.inference import model as PM
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops import attention as PA
from deepspeed_tpu_torch.ops import cuda as PK
from deepspeed_tpu_torch.ops.cuda import flash_attention as PF
from deepspeed_tpu_torch.ops.cuda import paged_attention as PP
from deepspeed_tpu_torch.utils.convert import params_from_numpy

FLASH_TOL = dict(rtol=2e-4, atol=2e-4)
KERNEL_VS_ORACLE_ATOL = 5e-5
TOL = dict(rtol=1e-4, atol=1e-4)
# Bloom-class at tiny width: 2 heads of 128 (the JAX engine's fused decode
# then runs kernel #5), vocab 512
BLOOM_TINY = dict(TINY, variant="gpt2", alibi=True, embedding_layernorm=True,
                  activation="gelu")
# falcon-rw-class (config_from_hf of a FalconConfig with alibi=True,
# parallel_attn=False, bias=True, multi_query=False): 4 heads of 64
FALCON_RW_TINY = dict(TINY, n_heads=4, norm_type="layer", gated_mlp=False,
                      activation="gelu_exact", qkv_bias=True, attn_out_bias=True,
                      mlp_bias=True, alibi=True, alibi_slope_scale=1.0 / 8.0)
MODELS = {"bloom": BLOOM_TINY, "falcon_rw": FALCON_RW_TINY}
# bigscience/bloom-7b1 config.json, the values config_from_hf reads
BLOOM_7B1_HF = {"architectures": ["BloomForCausalLM"], "vocab_size": 250880,
                "hidden_size": 4096, "n_layer": 30, "n_head": 32,
                "layer_norm_epsilon": 1e-05, "tie_word_embeddings": True}


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_bh(x):
    B, S, h, D = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * h, S, D)


# ---------------------------------------------------------------------------
# slopes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", [4, 6, 12, 32])
def test_alibi_slopes_bit_equal_to_jax(H):
    got = PA.alibi_slopes(H)
    assert got.dtype == torch.float32 and got.shape == (H,)
    np.testing.assert_array_equal(got.numpy(), JA.alibi_slopes(H))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_alibi_slopes_match_jax(name):
    over = MODELS[name]
    got = PT.model_alibi_slopes(PT.TransformerConfig(**over))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JT.model_alibi_slopes(JT.TransformerConfig(**over))))


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

FLASH_CASES = {"mha": (4, 4, 0), "gqa": (4, 2, 0), "gqa_window": (4, 2, 40),
               "non_pow2_heads": (6, 3, 0)}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax_kernel_and_xla(rng, case):
    H, KV, window = FLASH_CASES[case]
    B, S, D = 1, 100, 64  # S no multiple of the 64-row blocks
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    slopes = JA.alibi_slopes(H)
    with jax.default_matmul_precision("highest"):
        jo, jlse = JF._flash_fwd(_to_bh(q), _to_bh(k), _to_bh(v), jnp.asarray(slopes), True,
                                 64, 64, H, KV, window=window, alibi=True)
        xla = JA._xla_attention(q, JA._repeat_kv(k, H // KV), JA._repeat_kv(v, H // KV),
                                window=window, alibi=jnp.asarray(slopes))
    o, lse = PF.flash_attention_plain(_t(q), _t(k), _t(v), window, PA.alibi_slopes(H))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo).reshape(B, H, S, D)
                               .transpose(0, 2, 1, 3), **FLASH_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(B, H, S), **FLASH_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(xla), **FLASH_TOL)
    # the bias bites: without it the output is another
    o0, _ = PF.flash_attention_plain(_t(q), _t(k), _t(v), window)
    assert np.abs(o0.numpy() - o.numpy()).max() > 0.1


def test_flash_alibi_is_the_relative_bias(rng):
    """Row r of head h is softmax over c <= r of q.k / sqrt(D) + slope_h
    (c - r), written out; with GQA, head h takes its own slope."""
    H, KV, S, D = 4, 2, 20, 64
    q, k, v = (_t(rng.standard_normal(s).astype(np.float32))
               for s in ((1, S, H, D), (1, S, KV, D), (1, S, KV, D)))
    slopes = PA.alibi_slopes(H)
    o, _ = PF.flash_attention_plain(q, k, v, 0, slopes)
    for h in range(H):
        for r in (0, 7, 19):
            logits = q[0, r, h] @ k[0, :r + 1, h // 2].T / 8.0 \
                + slopes[h] * (torch.arange(r + 1) - r)
            ref = logits.softmax(-1) @ v[0, :r + 1, h // 2]
            torch.testing.assert_close(o[0, r, h], ref, rtol=1e-5, atol=1e-6)


def test_flash_cpu_wrapper_is_the_plain_alibi_version(rng):
    PK.reset_launch_counts()
    q, k, v = (_t(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 50, 4, 128), (1, 50, 2, 128), (1, 50, 2, 128)))
    slopes = PA.alibi_slopes(4)
    for window in (0, 7):
        o, lse = PF.flash_fwd(q, k, v, window, slopes)
        ro, rlse = PF.flash_attention_plain(q, k, v, window, slopes)
        assert torch.equal(o, ro) and torch.equal(lse, rlse)
        o, _ = PA.causal_attention(q, k, v, use_flash=True, window=window, alibi=slopes), None
        assert torch.equal(o, ro)
    assert PK.launch_counts() == {n: 0 for n in PK.WRAPPERS}
    assert set(PK.mode_launch_counts("alibi")) == {f"{n}[alibi]" for n in PK.MODES["alibi"]}
    assert set(PK.mode_launch_counts("alibi").values()) == {0}


def test_flash_backward_and_training_still_raise_for_alibi(rng):
    """(Named for the refusals it pinned until ALiBi training was ported.)
    The ALiBi gradient of causal_attention's flash path equals autograd
    through its dense plain path (use_flash=False, differentiated through
    the bias) at 1e-5, and both tiny Bloom-class configs are served and
    trained: check_trained and make_loss_fn accept them."""
    q, k, v, do = (_t(rng.standard_normal(s).astype(np.float32))
                   for s in ((1, 16, 2, 64), (1, 16, 2, 64), (1, 16, 2, 64), (1, 16, 2, 64)))
    grads = []
    for use_flash in (True, False):
        leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
        o = PA.causal_attention(*leaves_, use_flash=use_flash, alibi=PA.alibi_slopes(2))
        grads.append(torch.autograd.grad(o, leaves_, do))
    for g, r in zip(*grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-5)
    for over in MODELS.values():
        cfg = PT.TransformerConfig(**over)
        assert PT.unported_features(cfg) == []
        PM.check_served(cfg)
        PT.check_trained(cfg)
        assert callable(PT.make_loss_fn(cfg))


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

def _decode_case(rng, H, KV, D, quant, S=4, bs=16, NB=20, NBLK=84):
    """Rows: ctx 5, 130 (mid-block), 300 (the bias reaches slope x 299) and
    a pad row (ctx 0)."""
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
    ctx = np.array([5, 130, 300, 0], np.int32)[:S]
    return q, pools, tbl, ctx


def _jscale(pools):
    return dict(zip(("k_scale", "v_scale"), (jnp.asarray(s) for s in pools[2:])))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("H,KV,D", [(4, 2, 64), (2, 2, 128)])
def test_decode_plain_matches_jax_kernel_and_oracle(rng, quant, window, H, KV, D):
    q, pools, tbl, ctx = _decode_case(rng, H, KV, D, quant)
    slopes = JA.alibi_slopes(H)
    j = [jnp.asarray(a) for a in (q, *pools[:2], tbl, ctx)]
    with jax.default_matmul_precision("highest"):
        kern = JP.paged_decode_attention(*j, window=window, alibi_slopes=jnp.asarray(slopes),
                                         **_jscale(pools))
        oracle = JP.paged_decode_attention_xla(*j, window=window,
                                               alibi_slopes=jnp.asarray(slopes), **_jscale(pools))
    args = [_t(a) for a in (q, *pools[:2], tbl, ctx)]
    scales = [_t(s) for s in pools[2:]]
    out = PP.paged_decode_attention_plain(*args, *scales, window=window,
                                          alibi_slopes=PA.alibi_slopes(H))
    live = ctx > 0  # the JAX versions leave pad rows as garbage
    for ref in (kern, oracle):
        np.testing.assert_allclose(out.numpy()[live], np.asarray(ref)[live],
                                   atol=KERNEL_VS_ORACLE_ATOL, rtol=0)
    assert not out.numpy()[~live].any()
    # the bias bites on every row that sees more than one position
    plain = PP.paged_decode_attention_plain(*args, *scales, window=window)
    assert np.abs(out.numpy() - plain.numpy())[live].max() > 0.05
    # the wrappers on CPU tensors are the plain versions
    wrap = PP.paged_decode_attention_int8 if quant else PP.paged_decode_attention
    assert torch.equal(wrap(*args, *scales, window=window, alibi_slopes=PA.alibi_slopes(H)),
                       out)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 100])
def test_decode_fused_matches_jax_fused_kernel(rng, quant, window):
    """f32 pools: kernel #5 (JAX paged_decode_fused, head_dim 128); int8
    pools: #4's fused int8 mode. The written rows (codes and scales on
    int8) are bit-identical; the outputs within KERNEL_VS_ORACLE_ATOL of
    the JAX fused kernel and of the oracle over its written pools; the
    new token's column is biased at position ctx - 1."""
    H, KV, D = 4, 2, 128
    q, pools, tbl, ctx = _decode_case(rng, H, KV, D, quant)
    S, bs = q.shape[0], pools[0].shape[1]
    kn, vn = (rng.standard_normal((S, KV, D)).astype(np.float32) for _ in range(2))
    pos = np.maximum(ctx - 1, 0)
    slots = np.where(ctx > 0, tbl[np.arange(S), pos // bs] * bs + pos % bs, -1).astype(np.int32)
    ab = jnp.asarray(JA.alibi_slopes(H))
    jargs = [jnp.asarray(a) for a in (q, *pools[:2], tbl, ctx, kn, vn, slots)]
    with jax.default_matmul_precision("highest"):
        if quant:
            ref, *jpools = JP.paged_decode_attention(
                *jargs[:5], k_new=jargs[5], v_new=jargs[6], slots=jargs[7], window=window,
                alibi_slopes=ab, **_jscale(pools))
        else:
            ref, *jpools = JP.paged_decode_fused(*jargs, window=window, alibi_slopes=ab)
        oracle = JP.paged_decode_attention_xla(
            jargs[0], *jpools[:2], jargs[3], jargs[4], window=window, alibi_slopes=ab,
            **(dict(k_scale=jpools[2], v_scale=jpools[3]) if quant else {}))
    ppools = [_t(a.copy()) for a in pools]
    fused = PP.paged_decode_fused_int8 if quant else PP.paged_decode_fused
    out, *written = fused(_t(q), ppools[0], ppools[1], _t(tbl), _t(ctx), _t(kn), _t(vn),
                          _t(slots), *ppools[2:], window=window,
                          alibi_slopes=PA.alibi_slopes(H))
    assert all(w is p for w, p in zip(written, ppools))  # in place
    for w, g in zip(jpools, ppools):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    live = ctx > 0
    for r in (ref, oracle):
        np.testing.assert_allclose(out.numpy()[live], np.asarray(r)[live],
                                   atol=KERNEL_VS_ORACLE_ATOL, rtol=0)


def test_decode_bias_uses_absolute_positions(rng):
    """slope * key_pos, not slope * (key_pos - (ctx - 1)): equal under
    softmax up to f32 rounding, which the bias's size (here ~75) makes
    visible; the plain version takes the reference's form bit for bit."""
    H, KV, D = 4, 2, 64
    q, pools, tbl, ctx = _decode_case(rng, H, KV, D, False)
    args = [_t(a) for a in (q, *pools[:2], tbl, ctx)]
    slopes = PA.alibi_slopes(H)
    out = PP.paged_decode_attention_plain(*args, alibi_slopes=slopes)
    # the same logits spelled out with absolute positions
    k = _t(pools[0])[_t(tbl).long()].reshape(len(ctx), -1, KV, D).repeat_interleave(2, 2)
    v = _t(pools[1])[_t(tbl).long()].reshape(len(ctx), -1, KV, D).repeat_interleave(2, 2)
    pos = torch.arange(k.shape[1])
    logits = torch.einsum("shd,skhd->shk", args[0], k) / D ** 0.5 + slopes[None, :, None] * pos
    logits = logits.masked_fill(~(pos[None, :] < args[4][:, None])[:, None, :], float("-inf"))
    ref = torch.einsum("shk,skhd->shd", logits.softmax(-1), v)
    live = ctx > 0
    torch.testing.assert_close(out[live], ref[live], rtol=0, atol=1e-6)


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
    """The same put() sequence on a JAX and a port engine: a 13-token
    prompt beside a 40-token one, 6 greedy single-token decodes of the
    first, a 3-token continuation of the second (the plain decode mode), a
    prefix hit on the second's first two blocks (a 5-token suffix through
    the plain decode mode) and greedy decode_multi. int8 pools start each
    put from the JAX engine's pools."""
    over = MODELS[model]
    jc, pc = JT.TransformerConfig(**over), PT.TransformerConfig(**over)
    # weights of std 0.3: at 0.08 these tied-embedding LayerNorm models
    # mostly repeat one token, and decode_multi would hold little
    tree = numpy_params(jc, seed=7, std=0.3)
    cfg = dict(SERVE, kv_cache_dtype=kv_cache_dtype)
    jeng = jax_init_inference(to_jax(tree), jc, dict(cfg, decode_impl="pallas"),
                              dtype=jnp.float32)
    peng = init_inference(params_from_numpy(tree, pc, device="cpu"), pc, cfg,
                          dtype=torch.float32, device="cpu")
    quant = kv_cache_dtype == "int8"
    r = np.random.default_rng(13)
    p0, p1 = (r.integers(0, 512, n).astype(np.int32) for n in (13, 40))
    out = {"prefill": [], "decode": [], "chunk": [], "prefix_hit": []}

    def put(name, uids, toks):
        if quant:
            _sync(peng, jeng)
        lj = np.asarray(jeng.put(uids, [t.copy() for t in toks]))
        lp = peng.put(uids, [t.copy() for t in toks])
        out[name].append((lj, lp))
        return lj, lp

    lj, lp = put("prefill", [0, 1], [p0, p1])
    for _ in range(6):
        tok = int(np.argmax(lj[0]))
        assert tok == int(np.argmax(lp[0]))
        lj, lp = put("decode", [0], [np.array([tok], np.int32)])
    put("chunk", [1], [r.integers(0, 512, 3).astype(np.int32)])
    put("prefix_hit", [2], [np.concatenate([p1[:32], r.integers(0, 512, 5)]).astype(np.int32)])
    if quant:
        _sync(peng, jeng)
    uids = [0, 1]
    tables = peng.state.block_table(uids, peng.config.blocks_per_seq, peng.pad_block)
    ctx = np.array([peng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
    toks = np.array([7, 8], np.int32)
    jg, jl, jeng.cache, _ = jeng.decode_multi_fn(2, 10)(  # the JAX call donates its cache
        jeng.params, jeng.cache, jnp.asarray(toks), jnp.asarray(tables), jnp.asarray(ctx))
    pg, pl_, _, _ = peng.decode_multi_fn(2, 10)(peng.params, peng.cache, toks, tables, ctx)
    out["decode_multi"] = (np.asarray(jg), pg.numpy(), np.asarray(jl), pl_.numpy())
    out["stats"] = (jeng.prefix_cache_stats(), peng.prefix_cache_stats())
    return out


@pytest.fixture(scope="module", params=[(m, kv) for m in sorted(MODELS) for kv in ("auto",
                                                                                   "int8")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def scripted_run(request):
    return _scripted(*request.param)


@pytest.mark.parametrize("step", ["prefill", "decode", "chunk", "prefix_hit"])
def test_engine_put_logits_match_jax_engine(scripted_run, step):
    assert scripted_run[step]
    for lj, lp in scripted_run[step]:
        assert lp.shape == lj.shape
        np.testing.assert_allclose(lp, lj, **TOL)
        assert (lp.argmax(-1) == lj.argmax(-1)).all()


def test_engine_decode_multi_tokens_identical(scripted_run):
    jg, pg, jl, pl_ = scripted_run["decode_multi"]
    assert pg.shape == (10, 2)
    np.testing.assert_array_equal(pg, jg)
    assert len(np.unique(pg)) > 3  # the tokens actually move
    np.testing.assert_allclose(pl_, jl, **TOL)


def test_engine_prefix_hit_was_taken(scripted_run):
    sj, sp = scripted_run["stats"]
    assert sp["lookup_hits"] == sj["lookup_hits"] == 1
    assert sp["cached_tokens"] == sj["cached_tokens"] == 32


@pytest.mark.parametrize("name", sorted(MODELS))
def test_alibi_bites_in_the_engine(name):
    """The same weights with every slope 0 (no position information) give
    other logits, by more than ten times the 1e-4 tolerance above (4e-3 to
    3e-2 here: the last token's own embedding dominates the logits of
    these tiny random models): the runs above are ALiBi runs."""
    over = MODELS[name]
    tree = numpy_params(JT.TransformerConfig(**over), seed=7, std=0.3)
    logits = []
    for cfg in (PT.TransformerConfig(**over),
                PT.TransformerConfig(**dict(over, alibi_slope_scale=0.0))):
        eng = init_inference(params_from_numpy(tree, cfg, device="cpu"), cfg, SERVE,
                             dtype=torch.float32, device="cpu")
        logits.append(eng.put([0], [np.arange(30, dtype=np.int32) * 7]))
    assert np.abs(logits[0] - logits[1]).max() > 1e-3


# ---------------------------------------------------------------------------
# parameters and the BLOOM-7B1 config
# ---------------------------------------------------------------------------

BLOOM_LEAVES = {"embed_ln_scale", "embed_ln_bias", "ln_f_bias", "layers/ln1_bias",
                "layers/ln2_bias", "layers/bq", "layers/bk", "layers/bv", "layers/bo",
                "layers/b_in", "layers/b_out"}


def test_params_from_numpy_on_the_bloom_leaves():
    jc, pc = JT.TransformerConfig(**BLOOM_TINY), PT.TransformerConfig(**BLOOM_TINY)
    tree = numpy_params(jc, seed=4)
    got = params_from_numpy(tree, pc, device="cpu")
    flat = {**{k: v for k, v in got.items() if k != "layers"},
            **{f"layers/{k}": v for k, v in got["layers"].items()}}
    assert BLOOM_LEAVES <= set(flat) == set(PT._param_shapes(pc))
    for path in BLOOM_LEAVES:
        src = tree[path] if "/" not in path else tree["layers"][path.split("/")[1]]
        np.testing.assert_array_equal(flat[path].numpy(), src)
    # the serving layout fuses the q/k/v biases beside w_qkv
    lp = PM.prepare(got, pc)["layers"][1]
    np.testing.assert_array_equal(
        lp["b_qkv"].numpy(),
        np.concatenate([tree["layers"][n][1] for n in ("bq", "bk", "bv")], axis=0))
    assert not {"bq", "bk", "bv", "wq"} & set(lp)
    for leaf in ("embed_ln_bias", "ln_f_bias"):
        bad = dict(tree)
        del bad[leaf]
        with pytest.raises(ValueError, match=leaf):
            params_from_numpy(bad, pc, device="cpu")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bloom_is_config_from_hf_of_bloom_7b1():
    """chip_smoke.py's BLOOM dict is, field by field, the JAX package's
    config_from_hf of bigscience/bloom-7b1's config.json, and counts
    7,069,016,064 parameters in both packages."""
    want = config_from_hf(BLOOM_7B1_HF)
    got = PT.TransformerConfig(**_chip_smoke().BLOOM)
    for f in dataclasses.fields(JT.TransformerConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert PT.param_count(got) == JT.param_count(want) == 7_069_016_064
    assert (got.head_dim, got.kv_heads, got.ff_dim) == (128, 32, 16384)
    assert PT.unported_features(got) == []
