"""Block-sparse serving of the port held against the JAX package on the
CPU, from the same numpy-made inputs.

The port's plain versions (what its wrappers run on CPU tensors, and what
its CUDA kernels are held against on the card by tests/test_torch_cuda.py
and chip_smoke.py) against the JAX package's functions, run as its own
tests run them here: Pallas kernels in interpret mode, beside their XLA
oracles.

- layouts bit-equal to the JAX package's SparsityConfig.layout in all five
  modes (bigbird and variable random blocks included) at several block
  counts, prefix-stable, with the same layout_density and validation;
  TransformerConfig.sparsity_config() equal field by field;
- sparse_causal_attention (the block gather) against the JAX function in
  f32 at 1e-5, MHA and GQA (repeated as the callers do), blocks 8 and 16;
- the decode bitmaps (_sparse_decode_allowed_slots, _sparse_decode_allowed),
  the prefill token mask and the masked prefill attention equal to the JAX
  functions, position 0 and pad rows included;
- paged decode with `allowed_slots`, plain and fused, on f32 and int8
  pools, G 1 and 4, bs 16, random bitmaps that keep each row's own block:
  against the interpret-mode JAX kernels (paged_decode_attention, and
  paged_decode_fused at D 128) and paged_decode_attention_xla with the
  bitmap expanded to positions, at 5e-5; the fused new column attended
  whatever the bitmap says; a row with nothing allowed outputs zeros;
- tiny sparse Llama engines against the JAX engine: prefill, decode,
  chunked continuation, a prefix hit and decode_multi, with a ~100-token
  prompt whose decode rows skip blocks; the kernel route (sparse_block 16
  and 32, fixed and bigbird, f32 and int8 pools, against the JAX engine's
  interpret-mode Pallas route), the finer route (sparse_block 8, against
  its XLA route) and the masked prefill of a bucket shorter than a layout
  block; logits within 1e-4, greedy tokens identical;
- the layout bites (a sparse engine's logits are not the dense model's);
  check_served accepts a sparse config and check_trained refuses it;
- chip_smoke.py's LLAMA2_7B against the JAX package's config_from_hf of
  meta-llama/Llama-2-7b-hf's config.json (6,738,415,616 parameters).
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
from deepspeed_tpu.inference import model as JM
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import sparse_attention as JS
from deepspeed_tpu.ops.pallas import paged_attention as JP
from deepspeed_tpu.utils.hf_checkpoint import config_from_hf
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.inference import model as PM
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops import cuda as PK
from deepspeed_tpu_torch.ops import sparse_attention as PS
from deepspeed_tpu_torch.ops.cuda import paged_attention as PP
from deepspeed_tpu_torch.utils.convert import params_from_numpy

KERNEL_VS_ORACLE_ATOL = 5e-5
TOL = dict(rtol=1e-4, atol=1e-4)
# the knobs of tests/test_inference.py TestSparseServing, per mode
LAYOUTS = {
    "fixed": dict(mode="fixed", num_local_blocks=2, num_global_blocks=1),
    "longformer": dict(mode="longformer", num_local_blocks=3, num_global_blocks=2),
    "bigbird": dict(mode="bigbird", num_local_blocks=2, num_global_blocks=1,
                    num_random_blocks=2, seed=3),
    "dense": dict(mode="dense"),
    "variable": dict(mode="variable", local_window_blocks=(1, 2), global_block_indices=(0,),
                     num_random_blocks=1),
    "variable_ranges": dict(mode="variable", local_window_blocks=(2, 3, 1),
                            global_block_indices=(0, 5), global_block_end_indices=(2, 7),
                            num_random_blocks=0),
}
# meta-llama/Llama-2-7b-hf config.json, the values config_from_hf reads
LLAMA2_7B_HF = {"architectures": ["LlamaForCausalLM"], "vocab_size": 32000,
                "hidden_size": 4096, "intermediate_size": 11008, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": 32,
                "max_position_embeddings": 4096, "rms_norm_eps": 1e-05,
                "rope_theta": 10000.0, "tie_word_embeddings": False}


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [1, 5, 32])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_bit_equal_to_jax(name, nb):
    kw = LAYOUTS[name]
    got = PS.SparsityConfig(block=16, **kw).layout(nb * 16)
    want = JS.SparsityConfig(block=16, **kw).layout(nb * 16)
    assert got.dtype == want.dtype == bool and got.shape == (nb, nb)
    np.testing.assert_array_equal(got, want)
    assert PS.layout_density(got) == JS.layout_density(want)
    assert not np.triu(got, 1).any() and got.diagonal().all()  # causal, diagonal kept


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_rows_are_prefix_stable(name):
    cfg = PS.SparsityConfig(block=8, **LAYOUTS[name])
    big = cfg.layout(40 * 8)
    for nb in (1, 7, 23):
        np.testing.assert_array_equal(cfg.layout(nb * 8), big[:nb, :nb])


def test_layout_validation_matches_jax():
    for bad in (dict(mode="strided"),
                dict(mode="variable", global_block_indices=(0, 1),
                     global_block_end_indices=(2,)),
                dict(mode="variable", global_block_indices=(3,), global_block_end_indices=(3,))):
        for mod in (PS, JS):
            with pytest.raises(ValueError):
                mod.SparsityConfig(**bad)
    with pytest.raises(AssertionError):
        PS.SparsityConfig(block=16).layout(40)


def test_sparsity_config_matches_jax():
    over = dict(attention_impl="sparse", sparse_mode="variable", sparse_block=32,
                sparse_num_local_blocks=3, sparse_num_global_blocks=2,
                sparse_num_random_blocks=1, sparse_local_window_blocks=[2, 4],
                sparse_global_block_indices=[0, 3], sparse_global_block_end_indices=[1, 5])
    got = PT.TransformerConfig(**TINY, **over).sparsity_config()
    want = JT.TransformerConfig(**TINY, **over).sparsity_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    np.testing.assert_array_equal(got.layout(320), want.layout(320))


# ---------------------------------------------------------------------------
# prefill: the block gather and the masked fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fixed", "bigbird"])
@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)])
def test_sparse_causal_attention_matches_jax(rng, mode, block, H, KV):
    B, S, D = 2, 64, 32
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, D)).astype(np.float32) for _ in range(2))
    # GQA: repeated as the callers (prefill, the JAX training forward) do
    k, v = (np.repeat(a, H // KV, axis=2) for a in (k, v))
    kw = LAYOUTS[mode]
    with jax.default_matmul_precision("highest"):
        want = JS.sparse_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          JS.SparsityConfig(block=block, **kw))
    cfg = PS.SparsityConfig(block=block, **kw)
    got = PS.sparse_causal_attention(_t(q), _t(k), _t(v), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # a plan made once gives the same result
    plan = PS.gather_plan(cfg, S, "cpu")
    assert torch.equal(PS.sparse_causal_attention(_t(q), _t(k), _t(v), cfg, plan), got)


def test_sparse_causal_attention_chunks_agree(rng, monkeypatch):
    """Chunking the query blocks (what bounds the gathered logits at long
    prompts) changes nothing."""
    q, k, v = (_t(rng.standard_normal((1, 96, 2, 32)).astype(np.float32)) for _ in range(3))
    cfg = PS.SparsityConfig(block=16, **LAYOUTS["bigbird"])
    whole = PS.sparse_causal_attention(q, k, v, cfg)
    monkeypatch.setattr(PS, "_CHUNK_LOGITS", 2 * 16 * 16 * 16 * 4)  # 2 query blocks a chunk
    torch.testing.assert_close(PS.sparse_causal_attention(q, k, v, cfg), whole,
                               rtol=0, atol=1e-6)


def test_prefill_mask_and_masked_attention_match_jax(rng):
    scfg = PS.SparsityConfig(block=32, **LAYOUTS["fixed"])
    jcfg = JS.SparsityConfig(block=32, **LAYOUTS["fixed"])
    for Tp in (16, 50, 100):
        np.testing.assert_array_equal(PM._sparse_prefill_mask(scfg, Tp, "cpu").numpy(),
                                      np.asarray(JM._sparse_prefill_mask(jcfg, Tp)))
    Tp = 100
    q = rng.standard_normal((2, Tp, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, Tp, 2, 32)).astype(np.float32) for _ in range(2))
    mask = PM._sparse_prefill_mask(scfg, Tp, "cpu")
    with jax.default_matmul_precision("highest"):
        want = JM._masked_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(mask.numpy()))
    got = PM._masked_causal_attention(_t(q), _t(k), _t(v), mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# decode bitmaps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fixed", "bigbird", "variable"])
@pytest.mark.parametrize("sblk,bs", [(16, 16), (32, 16), (64, 16), (8, 16)])
def test_decode_bitmaps_match_jax(name, sblk, bs):
    scfg = PS.SparsityConfig(block=sblk, **LAYOUTS[name])
    jcfg = JS.SparsityConfig(block=sblk, **LAYOUTS[name])
    NB = 8
    ctx = np.array([0, 1, 16, 17, 63, 64, 100, 128, 0], np.int32)  # pad rows ctx 0
    pos = np.maximum(ctx - 1, 0)
    if sblk % bs == 0:
        got = PM._sparse_decode_allowed_slots(scfg, _t(pos), NB, bs)
        want = JM._sparse_decode_allowed_slots(jcfg, jnp.asarray(pos), NB, bs)
        assert got.dtype == torch.int32 and got.shape == (len(ctx), NB)
        np.testing.assert_array_equal(got.numpy() != 0, np.asarray(want))
        # the per-slot bitmap expanded to positions is the per-position mask
        np.testing.assert_array_equal(
            got.bool().repeat_interleave(bs, 1).numpy(),
            np.asarray(JM._sparse_decode_allowed(jcfg, jnp.asarray(pos), NB * bs)))
    got = PM._sparse_decode_allowed(scfg, _t(pos), NB * bs)
    want = JM._sparse_decode_allowed(jcfg, jnp.asarray(pos), NB * bs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one layout made for the call serves every step
    lay = PM._sparse_layout(scfg, NB * bs, "cpu")
    assert torch.equal(PM._sparse_decode_allowed(scfg, _t(pos), NB * bs, lay), got)


# ---------------------------------------------------------------------------
# paged decode with allowed_slots
# ---------------------------------------------------------------------------

def _decode_case(rng, H, KV, D, quant, S=5, bs=16, NB=8, NBLK=48):
    """Rows: ctx 5, 40, 100 (mid-block), 128 (the whole table) and a pad
    row (ctx 0); random bitmaps with each row's own block kept."""
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
    tbl[S - 1] = NBLK - 1
    ctx = np.array([5, 40, 100, 128, 0], np.int32)[:S]
    allow = rng.integers(0, 2, (S, NB)).astype(np.int32)
    for s in range(S):
        allow[s, max(int(ctx[s]) - 1, 0) // bs] = 1
    return q, pools, tbl, ctx, allow


def _jscale(pools):
    return dict(zip(("k_scale", "v_scale"), (jnp.asarray(s) for s in pools[2:])))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("H,KV,D", [(2, 2, 128), (8, 2, 64)])
def test_decode_plain_matches_jax_kernel_and_oracle(rng, quant, H, KV, D):
    q, pools, tbl, ctx, allow = _decode_case(rng, H, KV, D, quant)
    bs = pools[0].shape[1]
    j = [jnp.asarray(a) for a in (q, *pools[:2], tbl, ctx)]
    expanded = np.repeat(allow != 0, bs, axis=1)
    with jax.default_matmul_precision("highest"):
        kern = JP.paged_decode_attention(*j, allowed_slots=jnp.asarray(allow), **_jscale(pools))
        oracle = JP.paged_decode_attention_xla(*j, allowed=jnp.asarray(expanded),
                                               **_jscale(pools))
    args = [_t(a) for a in (q, *pools[:2], tbl, ctx)]
    scales = [_t(s) for s in pools[2:]]
    out = PP.paged_decode_attention_plain(*args, *scales, allowed_slots=_t(allow))
    live = ctx > 0  # the JAX versions leave pad rows as garbage
    for ref in (kern, oracle):
        np.testing.assert_allclose(out.numpy()[live], np.asarray(ref)[live],
                                   atol=KERNEL_VS_ORACLE_ATOL, rtol=0)
    assert not out.numpy()[~live].any()
    # the per-position mask route is the same function
    assert torch.equal(PP.paged_decode_attention_plain(*args, *scales, allowed=_t(expanded)),
                       out)
    # the bitmap bites on the rows it cuts
    dense = PP.paged_decode_attention_plain(*args, *scales)
    cut = [s for s in range(len(ctx)) if not allow[s, :-(-int(ctx[s]) // bs)].all()]
    assert cut and np.abs(out.numpy()[cut] - dense.numpy()[cut]).max() > 0.05
    # the wrappers on CPU tensors are the plain versions
    wrap = PP.paged_decode_attention_int8 if quant else PP.paged_decode_attention
    assert torch.equal(wrap(*args, *scales, allowed_slots=_t(allow)), out)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("own_block", ["kept", "cut"])
def test_decode_fused_matches_jax_fused_kernel(rng, quant, own_block):
    """f32 pools: kernel #5 (JAX paged_decode_fused, head_dim 128); int8
    pools: #4's fused int8 mode. The written rows bit-identical; the
    outputs within KERNEL_VS_ORACLE_ATOL of the JAX kernel and (own block
    kept) of the oracle over its written pools. With the own block cut
    from the bitmap, the new token at ctx - 1 is still attended, by both
    packages, and nothing else of its block."""
    H, KV, D = 8, 2, 128
    q, pools, tbl, ctx, allow = _decode_case(rng, H, KV, D, quant)
    S, bs = q.shape[0], pools[0].shape[1]
    pos = np.maximum(ctx - 1, 0)
    if own_block == "cut":
        allow[np.arange(S), pos // bs] = 0
    kn, vn = (rng.standard_normal((S, KV, D)).astype(np.float32) for _ in range(2))
    slots = np.where(ctx > 0, tbl[np.arange(S), pos // bs] * bs + pos % bs, -1).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (q, *pools[:2], tbl, ctx, kn, vn, slots)]
    ja = jnp.asarray(allow)
    with jax.default_matmul_precision("highest"):
        if quant:
            ref, *jpools = JP.paged_decode_attention(
                *jargs[:5], k_new=jargs[5], v_new=jargs[6], slots=jargs[7], allowed_slots=ja,
                **_jscale(pools))
        else:
            ref, *jpools = JP.paged_decode_fused(*jargs, allowed_slots=ja)
        expanded = np.repeat(allow != 0, bs, axis=1)
        expanded[np.arange(S), pos] = True
        oracle = JP.paged_decode_attention_xla(
            jargs[0], *jpools[:2], jargs[3], jargs[4], allowed=jnp.asarray(expanded),
            **(dict(k_scale=jpools[2], v_scale=jpools[3]) if quant else {}))
    ppools = [_t(a.copy()) for a in pools]
    fused = PP.paged_decode_fused_int8 if quant else PP.paged_decode_fused
    out, *written = fused(_t(q), ppools[0], ppools[1], _t(tbl), _t(ctx), _t(kn), _t(vn),
                          _t(slots), *ppools[2:], allowed_slots=_t(allow))
    assert all(w is p for w, p in zip(written, ppools))  # in place
    for w, g in zip(jpools, ppools):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    live = ctx > 0
    for r in (ref, oracle):
        np.testing.assert_allclose(out.numpy()[live], np.asarray(r)[live],
                                   atol=KERNEL_VS_ORACLE_ATOL, rtol=0)


def test_decode_row_with_nothing_allowed_outputs_zeros(rng):
    """As the TPU kernel (l_safe) and the CUDA kernel (l = 0): zeros, where
    the dense XLA oracle's softmax over an all-masked row is garbage."""
    q, pools, tbl, ctx, allow = _decode_case(rng, 4, 2, 64, False)
    allow[1] = 0
    args = [_t(a) for a in (q, *pools[:2], tbl, ctx)]
    out = PP.paged_decode_attention_plain(*args, allowed_slots=_t(allow))
    assert not out[1].any() and out[0].abs().sum() > 0
    with jax.default_matmul_precision("highest"):
        kern = JP.paged_decode_attention(*(jnp.asarray(a) for a in (q, *pools, tbl, ctx)),
                                         allowed_slots=jnp.asarray(allow))
    np.testing.assert_allclose(out.numpy()[:4], np.asarray(kern)[:4],
                               atol=KERNEL_VS_ORACLE_ATOL, rtol=0)


def test_sparse_modes_and_counts():
    """The four decode wrappers carry `sparse_launches`; on CPU tensors
    nothing launches."""
    assert set(PK.MODES["sparse"]) == {"paged_decode_fused", "paged_decode_attention",
                                    "paged_decode_fused_int8", "paged_decode_attention_int8"}
    PK.reset_launch_counts()
    assert PK.mode_launch_counts("sparse") == {f"{n}[sparse]": 0 for n in PK.MODES["sparse"]}


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _sparse_over(block, mode):
    return dict(TINY, attention_impl="sparse", sparse_block=block, sparse_mode=mode,
                sparse_num_local_blocks=2, sparse_num_global_blocks=1, sparse_num_random_blocks=1)


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


def _row_code_gaps(jeng, peng, tables):
    """Per decode row, the largest |code difference| between the two
    engines' int8 pools over the blocks of its table, in every layer."""
    gaps = np.zeros(len(tables), int)
    for jp, pp in zip(jeng.cache.k + jeng.cache.v, peng.cache.k + peng.cache.v):
        a, b = np.asarray(jp).astype(int), pp.numpy().astype(int)
        for r, row in enumerate(tables):
            gaps[r] = max(gaps[r], np.abs(a[row] - b[row]).max())
    return gaps


def _counting(monkeypatch, name, counts):
    fn = getattr(PM, name)

    def counted(*a, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **kw)

    monkeypatch.setattr(PM, name, counted)


def _scripted(monkeypatch, block, mode, kv_cache_dtype):
    """The same put() sequence on a JAX and a port engine: a 13-token
    prompt beside a 40-token one, a 100-token prompt (its decode rows at
    positions >= 64 skip layout blocks), 4 greedy single-token decodes of
    the first and the third, a 3-token continuation of the third (the
    plain decode mode), a prefix hit on the second's first two blocks (a
    5-token suffix through the plain decode mode) and greedy decode_multi
    of the first and the third. int8 pools start each put from the JAX
    engine's pools. The JAX engine's kernel switch is on: its Pallas
    kernels (interpret mode) take the bitmap when the layout block nests
    the 16-token cache block, its XLA route the per-position mask when
    not."""
    over = _sparse_over(block, mode)
    jc, pc = JT.TransformerConfig(**over), PT.TransformerConfig(**over)
    tree = numpy_params(jc, seed=11, std=0.1)
    cfg = dict(SERVE, kv_cache_dtype=kv_cache_dtype)
    jeng = jax_init_inference(to_jax(tree), jc, dict(cfg, decode_impl="pallas"),
                              dtype=jnp.float32)
    peng = init_inference(params_from_numpy(tree, pc, device="cpu"), pc, cfg,
                          dtype=torch.float32, device="cpu")
    quant = kv_cache_dtype == "int8"
    counts = {}
    for name in ("sparse_causal_attention", "_masked_causal_attention",
                 "_sparse_decode_allowed_slots", "_sparse_decode_allowed"):
        _counting(monkeypatch, name, counts)
    r = np.random.default_rng(17)
    p0, p1, p2 = (r.integers(0, 512, n).astype(np.int32) for n in (13, 40, 100))
    out = {"prefill": [], "decode": [], "chunk": [], "prefix_hit": []}

    def put(name, uids, toks):
        if quant:
            _sync(peng, jeng)
        lj = np.asarray(jeng.put(uids, [t.copy() for t in toks]))
        lp = peng.put(uids, [t.copy() for t in toks])
        out[name].append((lj, lp))
        return lj, lp

    last = {0: put("prefill", [0, 1], [p0, p1])[0][0]}
    last[3] = put("prefill", [3], [p2])[0][0]
    for _ in range(4):
        toks = [np.array([int(np.argmax(last[u]))], np.int32) for u in (0, 3)]
        lj, lp = put("decode", [0, 3], toks)
        assert (lj.argmax(-1) == lp.argmax(-1)).all()
        last = {0: lj[0], 3: lj[1]}
    put("chunk", [3], [r.integers(0, 512, 3).astype(np.int32)])
    put("prefix_hit", [2], [np.concatenate([p1[:32], r.integers(0, 512, 5)]).astype(np.int32)])
    if quant:
        _sync(peng, jeng)
    uids = [0, 3]
    tables = peng.state.block_table(uids, peng.config.blocks_per_seq, peng.pad_block)
    ctx = np.array([peng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
    toks = np.array([7, 8], np.int32)
    jg, jl, jeng.cache, _ = jeng.decode_multi_fn(2, 10)(  # the JAX call donates its cache
        jeng.params, jeng.cache, jnp.asarray(toks), jnp.asarray(tables), jnp.asarray(ctx))
    pg, pl_, _, _ = peng.decode_multi_fn(2, 10)(peng.params, peng.cache, toks, tables, ctx)
    out["decode_multi"] = (np.asarray(jg), pg.numpy(), np.asarray(jl), pl_.numpy())
    out["code_gaps"] = _row_code_gaps(jeng, peng, tables) if quant else np.zeros(len(uids))
    out["stats"] = (jeng.prefix_cache_stats(), peng.prefix_cache_stats())
    out["ctx"] = ctx
    out["counts"] = counts
    return out


# (sparse_block, mode, kv_cache_dtype): the kernel route at layout blocks
# 16 and 32 (the 13-token prompt's 16-token bucket is shorter than a
# 32-token block: the masked prefill), fixed and bigbird, f32 and int8
# pools; the finer route at 8
ENGINE_CASES = [(16, "fixed", "auto"), (16, "bigbird", "int8"), (32, "fixed", "int8"),
                (32, "bigbird", "auto"), (8, "fixed", "auto"), (8, "bigbird", "int8")]


@pytest.fixture(scope="module", params=ENGINE_CASES, ids=lambda p: "-".join(map(str, p)))
def scripted_run(request):
    with pytest.MonkeyPatch.context() as mp:
        yield _scripted(mp, *request.param), request.param


@pytest.mark.parametrize("step", ["prefill", "decode", "chunk", "prefix_hit"])
def test_engine_put_logits_match_jax_engine(scripted_run, step):
    run, _ = scripted_run
    assert run[step]
    for lj, lp in run[step]:
        assert lp.shape == lj.shape
        np.testing.assert_allclose(lp, lj, **TOL)
        assert (lp.argmax(-1) == lj.argmax(-1)).all()


def test_engine_decode_multi_tokens_identical(scripted_run):
    """Greedy tokens identical and final logits within TOL. On int8 pools
    decode_multi's 10 steps run unsynced, so a code written at a .5
    boundary may take the neighbouring code in one framework
    (tests/test_torch_paged_quant.py) and move a logit of its row by up to
    ~2e-4 here: a row whose blocks hold such a code is held to codes at
    most one step apart; every other row to TOL, and the long sparse row
    must be one of those."""
    run, _ = scripted_run
    jg, pg, jl, pl_ = run["decode_multi"]
    assert pg.shape == (10, 2)
    np.testing.assert_array_equal(pg, jg)
    assert len(np.unique(pg)) > 3  # the tokens actually move
    gaps = run["code_gaps"]
    assert gaps.max() <= 1 and gaps[1] == 0, gaps
    np.testing.assert_allclose(pl_[gaps == 0], jl[gaps == 0], **TOL)
    assert run["ctx"][1] > 100  # the long row decodes past the local window


def test_engine_took_the_configured_routes(scripted_run):
    """Prefill: the block gather for buckets that are multiples of the
    layout block, the masked attention for a shorter one (at block 32, the
    13-token prompt's 16-token bucket). Decode: the kernels' bitmap when
    the layout block nests the cache block, else the per-position mask."""
    run, (block, _, _) = scripted_run
    c = run["counts"]
    assert c.get("sparse_causal_attention", 0) > 0
    assert (c.get("_masked_causal_attention", 0) > 0) == (block == 32)
    nests = block % SERVE["kv_block_size"] == 0
    assert (c.get("_sparse_decode_allowed_slots", 0) > 0) == nests
    assert (c.get("_sparse_decode_allowed", 0) > 0) == (not nests)
    sj, sp = run["stats"]
    assert sp["lookup_hits"] == sj["lookup_hits"] == 1


def test_layout_bites_in_the_engine():
    """A sparse engine's logits for a 100-token prompt and the decode
    after it are not the dense model's on the same weights."""
    over = _sparse_over(16, "fixed")
    tree = numpy_params(JT.TransformerConfig(**over), seed=11, std=0.1)
    dense = {k: v for k, v in over.items() if not k.startswith("sparse_")}
    dense["attention_impl"] = "ulysses"
    logits = []
    for o in (over, dense):
        cfg = PT.TransformerConfig(**o)
        eng = init_inference(params_from_numpy(tree, cfg, device="cpu"), cfg, SERVE,
                             dtype=torch.float32, device="cpu")
        first = eng.put([0], [np.arange(100, dtype=np.int32) * 5 % 512])
        logits.append((first, eng.put([0], [np.array([3], np.int32)])))
    for a, b in zip(*logits):
        assert np.abs(a - b).max() > 1e-2


def test_sparse_is_served_not_trained():
    cfg = PT.TransformerConfig(**_sparse_over(16, "fixed"))
    assert PT.unported_features(cfg) == []
    PM.check_served(cfg)
    with pytest.raises(NotImplementedError, match="sparse attention.*ROADMAP A2"):
        PT.check_trained(cfg)


# ---------------------------------------------------------------------------
# the Llama-2-7B config of chip_smoke.py
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_llama2_is_config_from_hf_of_llama_2_7b():
    """chip_smoke.py's LLAMA2_7B dict is, field by field, the JAX package's
    config_from_hf of meta-llama/Llama-2-7b-hf's config.json with the
    sparse knobs as overrides, and counts 6,738,415,616 parameters in both
    packages."""
    sparse = dict(attention_impl="sparse", sparse_mode="fixed", sparse_block=128,
                  sparse_num_local_blocks=4, sparse_num_global_blocks=1)
    want = config_from_hf(LLAMA2_7B_HF, **sparse)
    got = PT.TransformerConfig(**_chip_smoke().LLAMA2_7B)
    for f in dataclasses.fields(JT.TransformerConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert PT.param_count(got) == JT.param_count(want) == 6_738_415_616
    assert (got.head_dim, got.kv_heads, got.ff_dim) == (128, 32, 11008)
    assert PT.unported_features(got) == []
