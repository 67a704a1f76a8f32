"""Sliding-window (Mistral-class) attention of the port held against the
JAX package on the CPU, from the same numpy-made inputs.

The port's plain versions (what its wrappers run on CPU tensors, and what
its CUDA kernels are held against on the card by tests/test_torch_cuda.py
and chip_smoke.py) against the JAX package's functions, run as its own
tests run them here: Pallas kernels in interpret mode, beside their XLA
oracles. Window rule everywhere: query row r sees key column c iff
r - window < c <= r; in decode, where ctx counts the new token, the
positions ctx - window <= c < ctx.

- flash forward (o and lse) and backward (dq, dk, dv from the forward's
  o and lse) against the interpret-mode JAX kernels (`_flash_fwd`,
  jax.grad of `flash_attention(window=)`) and `_xla_attention(window=)`,
  f32 at 2e-3 (the pin of tests/test_flash_attention.py), windows 1, 5, 8,
  32 and >= S; any window >= S bit-identical to window 0; in bf16 the
  kernel rounding of P and dS against the JAX kernel under `bwd_mismatch`,
  where a band one column wider (the planted fault) fails;
- paged decode, plain and fused, bf16 and int8 pools, against the JAX
  interpret-mode kernels and `paged_decode_attention_xla(window=)` at
  5e-5 (KERNEL_VS_ORACLE_ATOL of tests/test_torch_paged_quant.py), ctx
  before, at and past the window edge with the window starting mid-block;
- the model and the engine with sliding_window=8 against the JAX engine
  (logits 1e-4, greedy tokens identical over an 11-token prompt and 8
  decode steps, a chunked continuation, a prefix hit and decode_multi), and
  on int8 pools (logits 2e-3, INT8_TOL below);
- locality: a token outside every live window of a one-layer model leaves
  the logits unchanged, and cache rows left of the window overwritten with
  NaN leave the next decode bit-identical;
- make_loss_fn loss and every gradient with sliding_window=8 and with
  attention_window_pattern=(0, 8) against jax.value_and_grad (1e-4, f32),
  and a 5-step engine trajectory against the JAX engine;
- the JAX parameter tree of an untied-lm_head, GQA, sliding-window config
  (the Mistral shape at tiny width) converts leaf for leaf, and
  Mistral-7B's published shape counts 7,241,732,096 parameters in both
  packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as pds
from _torch_parity import SERVE, TINY, flatten, numpy_params, to_jax
from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.inference import model as JM
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import attention as JA
from deepspeed_tpu.ops.pallas import flash_attention as JF
from deepspeed_tpu.ops.pallas import paged_attention as JP
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.inference import model as PM
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops import cuda as PK
from deepspeed_tpu_torch.ops.cuda import flash_attention as PF
from deepspeed_tpu_torch.ops.cuda import paged_attention as PP
from deepspeed_tpu_torch.utils.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.utils.tree import leaves, tree_map

FLASH_TOL = dict(rtol=2e-3, atol=2e-3)
KERNEL_VS_ORACLE_ATOL = 5e-5
TOL = dict(rtol=1e-4, atol=1e-4)
# int8 pools: each put starts from the JAX engine's pools, but inside a step
# a later layer's new k/v row differs by f32 rounding between the two
# frameworks and can take the neighbouring code at a .5 boundary; the step
# attends that row at once, and one code step (the row's absmax / 127)
# moved a logit by up to 9.2e-4 here. A window fault moves logits by ~3
# (test_engine_window_bites).
INT8_TOL = dict(rtol=2e-3, atol=2e-3)
# GQA (2 query heads per KV head), head_dim 64; the engine's 16-token
# blocks put the 8-token window's start mid-block
WINDOWED = dict(TINY, n_heads=4, n_kv_heads=2, sliding_window=8)
MISTRAL_7B = dict(variant="llama", vocab_size=32000, n_layers=32, d_model=4096, n_heads=32,
                  n_kv_heads=8, d_ff=14336, sliding_window=4096, rope_theta=10000.0,
                  norm_eps=1e-5, tie_embeddings=False, max_seq=8192)


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(rng, B, S, H, KV, D):
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))


def _to_bh(x):
    B, S, h, D = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * h, S, D)


# ---------------------------------------------------------------------------
# flash attention, forward and backward
# ---------------------------------------------------------------------------

class TestFlashWindow:
    B, S, H, KV, D = 1, 100, 4, 2, 64  # S no multiple of the 64-row blocks

    @pytest.mark.parametrize("window", [1, 5, 8, 32, 100, 300])
    def test_plain_matches_jax_kernel_and_xla(self, rng, window):
        B, S, H, KV, D = self.B, self.S, self.H, self.KV, self.D
        q, k, v, do = _qkv(rng, B, S, H, KV, D)
        jo, jlse = JF._flash_fwd(_to_bh(q), _to_bh(k), _to_bh(v), jnp.zeros((1,)), True, 64,
                                 64, H, KV, window=window)
        o, lse = PF.flash_attention_plain(_t(q), _t(k), _t(v), window)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo).reshape(B, H, S, D)
                                   .transpose(0, 2, 1, 3), **FLASH_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(B, H, S), **FLASH_TOL)

        def xla(q, k, v):
            return JA._xla_attention(q, JA._repeat_kv(k, H // KV), JA._repeat_kv(v, H // KV),
                                     window=window)

        def vjp(attn):
            return jax.grad(lambda q, k, v: jnp.sum(attn(q, k, v) * do),
                            argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

        with jax.default_matmul_precision("highest"):
            np.testing.assert_allclose(o.numpy(), np.asarray(xla(q, k, v)), **FLASH_TOL)
            kernel = vjp(lambda q, k, v: JF.flash_attention(q, k, v, causal=True, block_q=64,
                                                            block_k=64, window=window))
            oracle = vjp(xla)
        got = PF.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, lse, _t(do), window)
        for name, g, a, b in zip(("dq", "dk", "dv"), got, kernel, oracle):
            np.testing.assert_allclose(g.numpy(), np.asarray(a), err_msg=name, **FLASH_TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(b), err_msg=name, **FLASH_TOL)

    @pytest.mark.parametrize("window", [100, 101, 1000])
    def test_window_at_least_s_is_causal_bit_for_bit(self, rng, window):
        q, k, v, do = (_t(a) for a in _qkv(rng, self.B, self.S, self.H, self.KV, self.D))
        o, lse = PF.flash_attention_plain(q, k, v, window)
        o0, lse0 = PF.flash_attention_plain(q, k, v)
        assert torch.equal(o, o0) and torch.equal(lse, lse0)
        for g, g0 in zip(PF.flash_attention_bwd_plain(q, k, v, o, lse, do, window),
                         PF.flash_attention_bwd_plain(q, k, v, o0, lse0, do)):
            assert torch.equal(g, g0)

    def test_window_masks_the_band(self, rng):
        """Row r's output is attention over columns r-w+1..r alone."""
        q, k, v, _ = (_t(a) for a in _qkv(rng, 1, 40, 2, 2, 64))
        o, _ = PF.flash_attention_plain(q, k, v, 8)
        for r in (0, 7, 8, 23, 39):
            lo = max(r - 7, 0)
            logits = torch.einsum("hd,khd->hk", q[0, r], k[0, lo:r + 1]) / 8.0
            ref = torch.einsum("hk,khd->hd", logits.softmax(-1), v[0, lo:r + 1])
            torch.testing.assert_close(o[0, r], ref, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("fault", [None, "one_wider"])
    @pytest.mark.parametrize("window", [2, 5, 33])
    def test_kernel_rounding_matches_jax_kernel_in_bf16(self, rng, window, fault):
        """bf16 inputs: the port's plain backward (P and dS rounded to bf16
        where the kernels round them) from the JAX forward's own o and lse,
        against jax.grad of the interpret-mode windowed kernel, under the
        tolerance the CUDA kernels are held to (`bwd_mismatch`). The planted
        fault: the gradients of the JAX kernel run with a band one column
        wider (a kernel testing r - window <= c) must fail it. (Window 1
        makes dq and dk zero up to rounding, which a relative tolerance
        cannot hold; chip_smoke.py checks that case against zero.)"""
        B, S, H, KV, D = 1, 128, 2, 1, 128
        q, k, v, do = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(rng, B, S, H, KV, D))
        w_jax = window + (fault == "one_wider")
        attn = dict(causal=True, block_q=64, block_k=64, window=w_jax)
        jo, jlse = JF._flash_fwd(_to_bh(q), _to_bh(k), _to_bh(v), jnp.zeros((1,)), True, 64,
                                 64, H, KV, window=window)
        ref = jax.grad(lambda q, k, v: jnp.sum(JF.flash_attention(q, k, v, **attn)
                                               .astype(jnp.float32) * do.astype(jnp.float32)),
                       argnums=(0, 1, 2))(q, k, v)
        o_ = _t(np.asarray(jo.astype(jnp.float32)).reshape(B, H, S, D)
                .transpose(0, 2, 1, 3)).to(torch.bfloat16)
        lse_ = _t(np.asarray(jlse).reshape(B, H, S))
        q_, k_, v_, do_ = (_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
                           for a in (q, k, v, do))
        rounded = PF.flash_attention_bwd_plain(q_, k_, v_, o_, lse_, do_, window)
        n_over = []
        for i, name in enumerate(("dq", "dk", "dv")):
            stats = PF.bwd_mismatch(_t(np.asarray(ref[i].astype(jnp.float32))), rounded[i])
            n_over.append(stats["n_over"])
            if fault is None:
                assert stats["n_over"] == 0, (name, stats)
        if fault:
            assert all(n_over), n_over

    @pytest.mark.parametrize("window", [1, 8, 33])
    def test_function_matches_autograd_through_plain(self, rng, window):
        q, k, v, do = (_t(a) for a in _qkv(rng, 2, 37, 4, 2, 64))
        PK.reset_launch_counts()
        leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
        o, _ = PF.flash_attention(*leaves_, window=window)
        got = torch.autograd.grad(o, leaves_, do)
        leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(PF.flash_attention_plain(*leaves_, window)[0], leaves_, do)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        # CPU tensors: the plain versions, no kernel launch in any mode
        assert PK.launch_counts() == {n: 0 for n in PK.WRAPPERS}
        assert set(PK.mode_launch_counts("window").values()) == {0}

    def test_cpu_wrappers_are_the_plain_windowed_versions(self, rng):
        q, k, v, do = (_t(a) for a in _qkv(rng, 1, 50, 4, 2, 128))
        o, lse = PF.flash_fwd(q, k, v, 7)
        o_ref, lse_ref = PF.flash_attention_plain(q, k, v, 7)
        assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
        delta = PF._delta(o, do)
        ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do, 7)
        got = (PF.flash_bwd_dq(q, k, v, do, lse, delta, 7),) + PF.flash_bwd_dkv(
            q, k, v, do, lse, delta, 7)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)

    def test_alibi_still_raises(self, rng):
        """(Named for the refusal it pinned until the flash backward took
        ALiBi.) Window + ALiBi runs forward and backward: the Function's
        gradient equals autograd through the dense plain forward (1e-5)."""
        q, k, v, do = (_t(a) for a in _qkv(rng, 1, 16, 2, 2, 64))
        leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
        o, _ = PF.flash_attention(*leaves_, window=8, alibi=[0.5, 0.25])
        got = torch.autograd.grad(o, leaves_, do)
        leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
        slopes = torch.tensor([0.5, 0.25])
        ref = torch.autograd.grad(PF.flash_attention_plain(*leaves_, 8, slopes)[0], leaves_, do)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

def _decode_case(rng, H, KV, D, quant, S=5, bs=8, NB=6, NBLK=40):
    """Rows: ctx 5 (before a window of 12), 12 (at it), 13 (one past),
    37 (window start 25, mid-block) and a pad row (ctx 0)."""
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
    ctx = np.array([5, 12, 13, 37, 0], np.int32)[:S]
    return q, pools, tbl, ctx


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [1, 12, 20])
def test_decode_plain_matches_jax_kernel_and_oracle(rng, quant, window):
    H, KV, D = 4, 2, 64
    q, pools, tbl, ctx = _decode_case(rng, H, KV, D, quant)
    scales = pools[2:]
    j = [jnp.asarray(a) for a in (q, *pools[:2], tbl, ctx)]
    jscale = dict(zip(("k_scale", "v_scale"), (jnp.asarray(s) for s in scales)))
    with jax.default_matmul_precision("highest"):
        kern = JP.paged_decode_attention(*j, window=window, **jscale)
        oracle = JP.paged_decode_attention_xla(*j, window=window, **jscale)
    out = PP.paged_decode_attention_plain(*(_t(a) for a in (q, *pools[:2], tbl, ctx)),
                                          *(_t(s) for s in scales), window=window)
    live = ctx > 0  # the JAX versions leave pad rows as garbage
    for ref in (kern, oracle):
        np.testing.assert_allclose(out.numpy()[live], np.asarray(ref)[live],
                                   atol=KERNEL_VS_ORACLE_ATOL, rtol=0)
    assert not out.numpy()[~live].any()
    # the window really bites: the rows past the edge differ from full context
    full = PP.paged_decode_attention_plain(*(_t(a) for a in (q, *pools[:2], tbl, ctx)),
                                           *(_t(s) for s in scales))
    bites = ctx > window
    assert not np.allclose(out.numpy()[bites], full.numpy()[bites])
    np.testing.assert_array_equal(out.numpy()[~bites], full.numpy()[~bites])


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [1, 12])
def test_decode_fused_matches_jax_fused_kernel(rng, quant, window):
    """bf16 pools: kernel #5 (JAX paged_decode_fused, head_dim 128); int8
    pools: #4's fused int8 mode. The written rows (codes and scales on
    int8) are bit-identical, the outputs within KERNEL_VS_ORACLE_ATOL of
    the JAX fused kernel and of the oracle over its written pools."""
    H, KV, D = 4, 2, 128
    q, pools, tbl, ctx = _decode_case(rng, H, KV, D, quant)
    S, bs = q.shape[0], pools[0].shape[1]
    kn, vn = (rng.standard_normal((S, KV, D)).astype(np.float32) for _ in range(2))
    pos = np.maximum(ctx - 1, 0)
    slots = np.where(ctx > 0, tbl[np.arange(S), pos // bs] * bs + pos % bs, -1).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (q, *pools[:2], tbl, ctx, kn, vn, slots)]
    with jax.default_matmul_precision("highest"):
        if quant:
            ref, *jpools = JP.paged_decode_attention(
                *jargs[:5], k_new=jargs[5], v_new=jargs[6], slots=jargs[7], window=window,
                k_scale=jnp.asarray(pools[2]), v_scale=jnp.asarray(pools[3]))
        else:
            ref, *jpools = JP.paged_decode_fused(*jargs, window=window)
        oracle = JP.paged_decode_attention_xla(
            jargs[0], *jpools[:2], jargs[3], jargs[4], window=window,
            **(dict(k_scale=jpools[2], v_scale=jpools[3]) if quant else {}))
    ppools = [_t(a.copy()) for a in pools]
    out, *_ = PP.paged_decode_fused_plain(_t(q), ppools[0], ppools[1], _t(tbl), _t(ctx),
                                          _t(kn), _t(vn), _t(slots), *ppools[2:],
                                          window=window)
    for w, g in zip(jpools, ppools):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    live = ctx > 0
    for r in (ref, oracle):
        np.testing.assert_allclose(out.numpy()[live], np.asarray(r)[live],
                                   atol=KERNEL_VS_ORACLE_ATOL, rtol=0)


def test_decode_wrappers_on_cpu_are_the_plain_windowed_versions(rng):
    PK.reset_launch_counts()
    q, pools, tbl, ctx = _decode_case(rng, 4, 2, 64, quant=True)
    args = [_t(a) for a in (q, *pools[:2], tbl, ctx)]
    scales = [_t(s) for s in pools[2:]]
    assert torch.equal(PP.paged_decode_attention_int8(*args, *scales, window=12),
                       PP.paged_decode_attention_plain(*args, *scales, window=12))
    q, pools, tbl, ctx = _decode_case(rng, 4, 2, 64, quant=False)
    args = [_t(a) for a in (q, *pools[:2], tbl, ctx)]
    assert torch.equal(PP.paged_decode_attention(*args, window=12),
                       PP.paged_decode_attention_plain(*args, window=12))
    assert PK.launch_counts() == {n: 0 for n in PK.WRAPPERS}
    assert set(PK.mode_launch_counts("window")) == {f"{n}[window]" for n in PK.MODES["window"]}


# ---------------------------------------------------------------------------
# model and engine
# ---------------------------------------------------------------------------

def _configs(**over):
    return (JT.TransformerConfig(**{**WINDOWED, **over}),
            PT.TransformerConfig(**{**WINDOWED, **over}))


def test_window_for_layer_matches_jax():
    for over in ({}, {"attention_window_pattern": (0, 8)},
                 {"attention_window_pattern": (4, 4)}, {"sliding_window": 0}):
        jc, pc = _configs(**over)
        assert [pc.window_for_layer(i) for i in range(4)] == \
               [jc.window_for_layer(i) for i in range(4)]
        assert PT.unported_features(pc) == []


def _pool_arrays(cache):
    return [np.asarray(a) for a in cache.k + cache.v + list(cache.k_scale or [])
            + list(cache.v_scale or [])]


def _sync(peng, jeng):
    """Copy the JAX engine's pools into the port's (int8: see
    tests/test_torch_paged_quant.py, one code flips at a .5 boundary now
    and then between the two frameworks' f32 k/v)."""
    c = peng.cache
    for dst, src in zip(c.k + c.v + list(c.k_scale or []) + list(c.v_scale or []),
                        _pool_arrays(jeng.cache)):
        dst.copy_(_t(src))


def _scripted(kv_cache_dtype):
    """The same put() sequence on a JAX and a port engine with
    sliding_window=8: an 11-token prompt beside a 20-token one, 8 greedy
    single-token decodes of the first (context 19 >> window 8), a 3-token
    continuation of the second (the plain decode mode), a prefix hit on the
    second's first block (a 5-token suffix through the plain decode mode)
    and greedy decode_multi. int8 pools start each put from the JAX
    engine's pools."""
    jc, pc = _configs()
    tree = numpy_params(jc, seed=1)
    cfg = dict(SERVE, kv_cache_dtype=kv_cache_dtype)
    jeng = jax_init_inference(to_jax(tree), jc, dict(cfg, decode_impl="pallas"),
                              dtype=jnp.float32)
    peng = init_inference(params_from_numpy(tree, pc, device="cpu"), pc, cfg,
                          dtype=torch.float32, device="cpu")
    quant = kv_cache_dtype == "int8"
    r = np.random.default_rng(12)
    p0, p1 = (r.integers(0, 512, n).astype(np.int32) for n in (11, 20))
    out = {"prefill": [], "decode": [], "chunk": [], "prefix_hit": []}

    def put(name, uids, toks):
        if quant:
            _sync(peng, jeng)
        lj = np.asarray(jeng.put(uids, [t.copy() for t in toks]))
        lp = peng.put(uids, [t.copy() for t in toks])
        out[name].append((lj, lp))
        return lj, lp

    lj, lp = put("prefill", [0, 1], [p0, p1])
    for _ in range(8):
        tok = int(np.argmax(lj[0]))
        assert tok == int(np.argmax(lp[0]))
        lj, lp = put("decode", [0], [np.array([tok], np.int32)])
    put("chunk", [1], [r.integers(0, 512, 3).astype(np.int32)])
    put("prefix_hit", [2], [np.concatenate([p1[:16], r.integers(0, 512, 5)]).astype(np.int32)])
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


@pytest.fixture(scope="module", params=["auto", "int8"])
def scripted_run(request):
    return request.param, _scripted(request.param)


@pytest.mark.parametrize("step", ["prefill", "decode", "chunk", "prefix_hit"])
def test_engine_put_logits_match_jax_engine(scripted_run, step):
    kv, run = scripted_run
    assert run[step]
    for lj, lp in run[step]:
        assert lp.shape == lj.shape
        np.testing.assert_allclose(lp, lj, **(INT8_TOL if kv == "int8" else TOL))
        assert (lp.argmax(-1) == lj.argmax(-1)).all()


def test_engine_decode_multi_tokens_identical(scripted_run):
    kv, run = scripted_run
    jg, pg, jl, pl_ = run["decode_multi"]
    assert pg.shape == (10, 2)
    np.testing.assert_array_equal(pg, jg)
    assert len(np.unique(pg)) > 3  # the tokens actually move
    np.testing.assert_allclose(pl_, jl, **(INT8_TOL if kv == "int8" else TOL))


def test_engine_prefix_hit_was_taken(scripted_run):
    sj, sp = scripted_run[1]["stats"]
    assert sp["lookup_hits"] == sj["lookup_hits"] == 1
    assert sp["cached_tokens"] == sj["cached_tokens"] == 16


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_engine_window_bites(kv):
    """The same weights without the window give other logits once the
    context outgrows it (by ~3 here): the windowed runs above are no causal
    runs, and the tolerances above are far inside that gap."""
    jc, pc = _configs()
    tree = numpy_params(jc, seed=1)
    logits = []
    for cfg in (pc, dataclasses.replace(pc, sliding_window=0)):
        eng = init_inference(params_from_numpy(tree, cfg, device="cpu"), cfg,
                             dict(SERVE, kv_cache_dtype=kv), dtype=torch.float32, device="cpu")
        p = np.arange(11, dtype=np.int32) * 7
        logits.append((eng.put([0], [p]), eng.put([0], [np.array([3], np.int32)])))
    for windowed, causal in zip(*logits):  # the prefill's row 10 and the decode see > 8
        assert np.abs(windowed - causal).max() > 0.5


@pytest.mark.parametrize("pattern", [None, (0, 8)])
def test_prefill_and_decode_step_match_jax(rng, pattern):
    jc, pc = _configs(attention_window_pattern=pattern)
    tree = numpy_params(jc, seed=3)
    jp, pp = JM.prepare(to_jax(tree), jc), PM.prepare(params_from_numpy(tree, pc, device="cpu"),
                                                       pc)
    B, Tp, NB, bs = 2, 32, 4, 16
    toks = rng.integers(0, 512, (B, Tp)).astype(np.int32)
    n_real = np.array([32, 19], np.int32)
    tables = np.arange(B * NB, dtype=np.int32).reshape(B, NB)
    jcache = JM.init_cache(jc, 12, bs, jnp.float32)
    pcache = PM.init_cache(pc, 12, bs, torch.float32, torch.device("cpu"))
    jl, jcache = JM.prefill_batch(jp, jcache, *(jnp.asarray(a) for a in (toks, n_real, tables)),
                                  jc, use_kernel=False)
    pl_, pcache = PM.prefill_batch(pp, pcache, *(_t(a) for a in (toks, n_real, tables)), pc)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    for unique_rows in (True, False):
        tok = np.array([5, 9], np.int32)
        ctx = n_real + 1
        jd, _ = JM.decode_step(jp, jcache, jnp.asarray(tok), jnp.asarray(tables),
                               jnp.asarray(ctx), jc, use_kernel=False, unique_rows=unique_rows)
        pd, _ = PM.decode_step(pp, pcache, _t(tok), _t(tables), _t(ctx), pc,
                               unique_rows=unique_rows)
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), **TOL)


# ---------------------------------------------------------------------------
# locality
# ---------------------------------------------------------------------------

def test_token_outside_every_window_changes_nothing(rng):
    """tests/test_inference.py's one-layer check: with one layer and window
    4, the last token's logits do not see token 0. Held for the port's
    forward and its engine's prefill, and against the JAX oracle."""
    over = dict(vocab_size=128, n_layers=1, n_heads=4, d_model=64, max_seq=128,
                sliding_window=4)
    jc, pc = JT.TransformerConfig(variant="llama", **over), PT.TransformerConfig(
        variant="llama", **over)
    tree = numpy_params(jc, seed=4)
    params = params_from_numpy(tree, pc, device="cpu")
    ctx = rng.integers(0, 128, 16).astype(np.int32)
    ctx2 = ctx.copy()
    ctx2[0] = (ctx2[0] + 1) % 128
    a, b = (PT.forward(params, _t(c[None]), pc)[0, -1] for c in (ctx, ctx2))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    ref = np.asarray(JT.forward(to_jax(tree), jnp.asarray(ctx[None]), jc)[0, -1])
    np.testing.assert_allclose(a.detach().numpy(), ref, **TOL)
    eng = init_inference(params, pc, dict(SERVE), dtype=torch.float32, device="cpu")
    la, lb = eng.put([0], [ctx]), eng.put([1], [ctx2])
    np.testing.assert_allclose(la, lb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(la[0], ref, **TOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("unique_rows", [True, False])
def test_cache_rows_left_of_the_window_are_never_read(quant, unique_rows):
    """After a 40-token prefill, every pool row at positions < ctx - 8 of
    the next decode, in every layer, is overwritten with NaN (on int8
    pools: the scales): the decode's logits stay finite and bit-identical
    to those of the same step on the untouched pools."""
    jc, pc = _configs()
    params = params_from_numpy(numpy_params(jc, seed=2), pc, device="cpu")
    eng = init_inference(params, pc, dict(SERVE, kv_cache_dtype="int8" if quant else "auto"),
                         dtype=torch.float32, device="cpu")
    eng.put([0], [np.arange(40, dtype=np.int32) * 5])
    ctx = eng.state.get(0).seen_tokens + 1
    tables = torch.from_numpy(eng.state.block_table([0], eng.config.blocks_per_seq,
                                                    eng.pad_block))
    step = (torch.tensor([3], dtype=torch.int32), tables, torch.tensor([ctx], dtype=torch.int32))
    clean = PM.decode_step(eng.params, PM.PagedCache(*(
        [x.clone() for x in pools] if pools else None for pools in eng.cache)), *step, pc,
        unique_rows=unique_rows)[0]
    bs = eng.config.kv_block_size
    dead = torch.arange(ctx - pc.sliding_window)
    flat = tables[0, dead // bs].long() * bs + dead % bs
    for pool in (eng.cache.k_scale + eng.cache.v_scale) if quant else eng.cache.k + eng.cache.v:
        pool.view(-1, *pool.shape[2:])[flat] = float("nan")
    got = PM.decode_step(eng.params, eng.cache, *step, pc, unique_rows=unique_rows)[0]
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)


# ---------------------------------------------------------------------------
# training: loss, gradients, engine trajectory
# ---------------------------------------------------------------------------

def _assert_grads_close(got, ref_tree):
    ref = {k: np.asarray(v) for k, v in flatten(ref_tree).items()}
    assert sorted(got) == sorted(ref)
    for name, g in got.items():
        r = ref[name]
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("remat", ["none", "save_attn_qkv"])
@pytest.mark.parametrize("pattern", [None, (0, 8)])
def test_loss_and_grads_match_jax(remat, pattern):
    jc, pc = _configs(attention_window_pattern=pattern, remat=remat)
    tree = numpy_params(jc, seed=5)
    r = np.random.default_rng(2)
    batch = {"tokens": r.integers(0, 512, (2, 33)).astype(np.int32)}
    jl, jg = jax.value_and_grad(JT.make_loss_fn(jc, loss_chunks=4))(to_jax(tree), batch, None)
    live = tree_map(lambda p: p.requires_grad_(), params_from_numpy(tree, pc, device="cpu"))
    loss = PT.make_loss_fn(pc, loss_chunks=4)(live, batch, None)
    grads = torch.autograd.grad(loss, leaves(live))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4, atol=1e-4)
    _assert_grads_close(dict(zip(flatten(live), (g.numpy() for g in grads))),
                        jax.tree.map(np.asarray, jg))
    # the window bites: the causal loss differs
    causal = dataclasses.replace(pc, sliding_window=0, attention_window_pattern=None)
    other = PT.make_loss_fn(causal, loss_chunks=4)(params_from_numpy(tree, causal, device="cpu"),
                                                   batch, None)
    assert abs(other.item() - loss.item()) > 1e-4


ENGINE_MODEL = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=64,
                    max_seq=32, variant="llama", sliding_window=8)
ENGINE_CONFIG = {
    "train_batch_size": 16,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4,
                                                 "warmup_max_lr": 1e-3,
                                                 "warmup_num_steps": 4,
                                                 "warmup_type": "linear"}},
    "gradient_clipping": 1.0,
    "seed": 7,
    "steps_per_print": 1000,
}


@pytest.fixture(scope="module")
def trajectories():
    jc = JT.TransformerConfig(**ENGINE_MODEL)
    pc = PT.TransformerConfig(**ENGINE_MODEL)
    tree = numpy_params(jc, seed=9, std=0.05)
    r = np.random.default_rng(4)
    batches = [{"tokens": r.integers(0, 128, (16, 33)).astype(np.int32)} for _ in range(5)]
    jeng = jds.initialize(dict(ENGINE_CONFIG, mesh={"data": -1}), loss_fn=JT.make_loss_fn(jc),
                          params=to_jax(tree), param_logical_specs=JT.logical_specs(jc))
    peng = pds.initialize(dict(ENGINE_CONFIG), loss_fn=PT.make_loss_fn(pc),
                          params=params_from_numpy(tree, pc, device="cpu"),
                          param_logical_specs=PT.logical_specs(pc), device="cpu")
    jm = [jeng.train_batch(b) for b in batches]
    pm = [peng.train_batch(b) for b in batches]
    return jm, pm


@pytest.mark.parametrize("metric", ["loss", "grad_norm", "lr"])
def test_engine_trajectory_matches_jax(trajectories, metric):
    """5 AdamW steps (GAS 2, clipping, linear warmup) of the windowed model:
    lr identical, loss and grad_norm at rtol 2e-4 (tests/test_torch_train.py's
    pin)."""
    jm, pm = trajectories
    got, ref = [m[metric] for m in pm], [m[metric] for m in jm]
    if metric == "lr":
        assert got == ref
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-4)


# ---------------------------------------------------------------------------
# weights carried across, and the Mistral-7B shape
# ---------------------------------------------------------------------------

def test_untied_gqa_window_tree_converts_leaf_for_leaf():
    over = dict(tie_embeddings=False, d_ff=224)
    jc, pc = _configs(**over)
    tree = numpy_params(jc, seed=6)
    jinit = JT.init(jc, jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in flatten(tree).items()} == \
           {k: tuple(v.shape) for k, v in flatten(jinit).items()}
    pinit = PT.init(pc, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten(pinit).items()} == \
           {k: v.shape for k, v in flatten(tree).items()}
    back = flatten(params_to_numpy(params_from_numpy(tree, pc, device="cpu")))
    assert sorted(back) == sorted(flatten(tree))
    assert "lm_head" in back
    for name, a in flatten(tree).items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)


def test_mistral_7b_param_count_matches_jax():
    pc, jc = PT.TransformerConfig(**MISTRAL_7B), JT.TransformerConfig(**MISTRAL_7B)
    assert PT.param_count(pc) == JT.param_count(jc) == 7_241_732_096
    assert (pc.head_dim, pc.kv_heads, pc.ff_dim) == (128, 8, 14336)
    assert PT.unported_features(pc) == []
    PM.check_served(pc)
    PT.check_trained(dataclasses.replace(pc, remat="save_attn_qkv"))
    assert pc.flops_per_token(8192) == jc.flops_per_token(8192)
