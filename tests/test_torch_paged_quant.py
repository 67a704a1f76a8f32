"""int8 KV serving of the port held against the JAX package on the CPU.

The port's plain versions (what its wrappers run on CPU tensors, and what
the CUDA kernels are held against on the card by tests/test_torch_cuda.py)
against the JAX package's functions, run as its own tests run them here:
Pallas kernels in interpret mode, beside their XLA oracles.

- quantize_kv_rows is bit-identical to the JAX package's on the same f32
  rows, built .5 ties and all-zero rows included. Rows whose absmax is
  subnormal are held against a float32 numpy quantizer; the JAX CPU run
  flushes them (the test says which case holds), so they are compared
  with it only if it keeps them.
- the quantizing write is bit-identical to the JAX package's _write_kv_quant
  (the Pallas write on the codes, paged_scale_write on the scales).
- int8 decode, plain and fused, is within KERNEL_VS_ORACLE_ATOL (the JAX
  package's own pin, tests/test_paged_quant.py) of its interpret-mode
  kernel and of paged_decode_attention_xla; the fused mode's codes and
  scales are bit-identical to the JAX fused kernel's. The fused mode's new
  rows come from `_rows`, whose first quarter is scaled by 30, so a row's
  attended values reach ~127 there: its limit is KERNEL_VS_ORACLE_ATOL per
  unit of the largest |dequantized v| the row attends to (the pin was set
  on unit-scale values), and one code step planted in the most attended
  row must still fail it.
- an int8 engine scripted run (prefill, decode, chunked continuation,
  prefix hit, COW tail, decode_multi) against the JAX int8 engine: greedy
  tokens identical; logits within TOL (the bf16 engine test's 1e-4); at
  least 99.9% of the written codes equal and every unequal code off by
  exactly one. The two frameworks' f32 k/v differ by ~1e-7, so a value
  within ~1e-7 of a .5 boundary of x / scale takes the neighbouring code
  in one of them; one code step moves that element by its row's absmax /
  127, a logit by up to ~1e-4 here. So every put() starts from the JAX
  engine's pools (copied into the port's): a step's logits then see no
  code flipped by an earlier step, and are held at 1e-4, while the codes
  each step writes are compared as above. decode_multi runs from equal
  pools too (its own 10 steps unsynced; tokens identical, logits 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SERVE, jax_config, numpy_params, to_jax, torch_config
from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.inference import model as JM
from deepspeed_tpu.ops.pallas import paged_attention as JP
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.ops import cuda as PK
from deepspeed_tpu_torch.ops.cuda import paged_attention as PP
from deepspeed_tpu_torch.utils.convert import params_from_numpy

KERNEL_VS_ORACLE_ATOL = 5e-5
TOL = dict(rtol=1e-4, atol=1e-4)
STATS = ("lookup_hits", "lookup_misses", "cached_tokens", "prompt_tokens", "cow_copies",
         "indexed_blocks", "kv_bytes_per_token", "kv_pool_bytes", "kv_quantized")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(rng, T=24, KV=4, D=128):
    """f32 rows [T, KV, D], T >= 4: unit normal, the first quarter x30, and
    the last four rows built: two of .5 ties, one of zeros, one with a zero
    head."""
    x = rng.standard_normal((T, KV, D)).astype(np.float32)
    x[:T // 4] *= 30
    # amax 127 -> scale exactly 1 (127 * f32(1/127) == 1), amax 63.5 ->
    # scale 0.5: every element but the first is k + 0.5 in scale units
    for i, amax in ((T - 4, 127.0), (T - 3, 63.5)):
        ties = rng.integers(-126, 126, (KV, D)) + 0.5
        x[i] = (ties * (amax / 127.0)).astype(np.float32)
        x[i, :, 0] = amax
    x[T - 2] = 0.0
    x[T - 1, 0] = 0.0
    return x


def _np_quantize(x):
    """float32 numpy quantizer (no flush of subnormals): the rule of
    quantize_kv_rows spelled with numpy's IEEE float32 arithmetic."""
    scale = np.abs(x).max(-1) * np.float32(1.0 / 127.0)
    scale = np.where(scale > 0, scale, np.float32(1.0)).astype(np.float32)
    code = np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8)
    return code, scale


def _nonfinite(x):
    """x [T, KV, D] with rows 1-4 non-finite in every head (copied): a NaN
    (head 0 of row 1 holds 0.5, -3, NaN, 1.25, 2, -0.75, 0, 7 and zeros),
    +inf, -inf, and a NaN beside a +inf."""
    x = x.copy()
    D = x.shape[-1]
    x[1, :, 5] = np.nan
    x[1, 0] = 0.0
    x[1, 0, :8] = [0.5, -3.0, np.nan, 1.25, 2.0, -0.75, 0.0, 7.0]
    x[2, :, 3] = np.inf
    x[3, :, D - 1] = -np.inf
    x[4, :, 0] = np.nan
    x[4, :, D // 2] = np.inf
    return x


class TestQuantizer:
    @pytest.mark.parametrize("nonfinite", [False, True])
    def test_bit_identical_to_jax(self, rng, nonfinite):
        """With `nonfinite`, rows of NaN and inf (_nonfinite): a NaN makes
        its slice's scale 1 and its own code 0, an inf without a NaN the
        scale inf and every code 0, in both."""
        k, v = _rows(rng), _rows(rng)[::-1].copy()
        if nonfinite:
            k, v = _nonfinite(k), _nonfinite(v)
        want = [np.asarray(a) for a in JP.quantize_kv_rows(jnp.asarray(k), jnp.asarray(v))]
        got = [a.numpy() for a in PP.quantize_kv_rows(_t(k), _t(v))]
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        if nonfinite:  # (numpy's cast of a NaN to int8 is the platform's)
            assert got[0][1, 0, :8].tolist() == [0, -3, 0, 1, 2, -1, 0, 7]
            assert (got[1][1] == 1).all() and (got[1][4] == 1).all()
            assert np.isinf(got[1][2]).all() and not got[0][2].any()
            assert (got[0][4, :, k.shape[-1] // 2] == 127).all()
        else:
            code, scale = _np_quantize(k)
            assert (np.abs(k / scale[..., None]) % 1 == 0.5).sum() > 1000  # ties
            np.testing.assert_array_equal(got[0], code)

    def test_subnormal_absmax(self):
        """A row whose absmax is subnormal gets a subnormal scale and full
        codes, as float32 arithmetic gives without flushing (so on the card,
        where the kernel and the plain version both keep subnormals). The
        JAX package's CPU run flushes them: its scale is 1 and its codes 0.
        Compared with JAX only if this JAX keeps subnormals."""
        x = np.full((2, 1, 64), 3e-39, np.float32)
        x[0, 0, ::3] = -5e-39
        x[1, 0, 0] = 1e-44
        code, scale = _np_quantize(x)
        assert 0 < scale[0, 0] < np.finfo(np.float32).tiny and code[0, 0, 0] == -127
        got = PP.quantize_kv_rows(_t(x), _t(x))
        np.testing.assert_array_equal(got[0].numpy(), code)
        np.testing.assert_array_equal(got[1].numpy(), scale)
        jc, js, _, _ = (np.asarray(a) for a in JP.quantize_kv_rows(jnp.asarray(x),
                                                                   jnp.asarray(x)))
        if js[0, 0] == 1.0:  # this XLA CPU run flushed the subnormal scale
            assert not jc.any()
        else:
            np.testing.assert_array_equal(jc, code)
            np.testing.assert_array_equal(js, scale)


def _pools(rng, NBLK=12, bs=16, KV=4, D=128):
    """int8 code pools and f32 scale pools as quantize_kv_rows fills them."""
    kf = rng.standard_normal((NBLK * bs, KV, D)).astype(np.float32)
    vf = rng.standard_normal((NBLK * bs, KV, D)).astype(np.float32)
    qk, ks, qv, vs = (np.asarray(a) for a in
                      JP.quantize_kv_rows(jnp.asarray(kf), jnp.asarray(vf)))
    return (qk.reshape(NBLK, bs, KV, D), qv.reshape(NBLK, bs, KV, D),
            ks.reshape(NBLK, bs, KV), vs.reshape(NBLK, bs, KV))


def test_quantizing_write_bit_identical_to_jax(rng):
    kc, vc, ks, vs = _pools(rng)
    T = 20
    kn, vn = _rows(rng, T), _rows(rng, T)
    slots = rng.permutation(11 * 16)[:T].astype(np.int32)
    slots[[3, 9]] = -1  # pad rows drop
    slots[5] = 12 * 16 + 7  # past the arena: block id clamped to the last block
    want = JM._write_kv_quant(*(jnp.asarray(a) for a in (kc, vc, ks, vs, kn, vn, slots)))
    got = [_t(a.copy()) for a in (kc, vc, ks, vs)]
    out = PP.paged_kv_write_quant_plain(*got, _t(kn), _t(vn), _t(slots))
    assert all(o is g for o, g in zip(out, got))  # in place
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _decode_case(rng, H, KV, D, S=4, bs=8, NB=3, NBLK=16):
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    kc, vc, ks, vs = _pools(rng, NBLK, bs, KV, D)
    tbl = rng.permutation(NBLK - 1)[:S * NB].reshape(S, NB).astype(np.int32)
    tbl[2] = NBLK - 1  # row 2 is a pad row on the scratch block
    ctx = np.array([5, bs * NB, 0, bs + 1], np.int32)
    return q, kc, vc, ks, vs, tbl, ctx


GEOMETRIES = [(8, 4, 16), (4, 2, 64), (2, 2, 128), (8, 2, 128)]


@pytest.mark.parametrize("H,KV,D", GEOMETRIES)
def test_plain_mode_matches_jax_kernel_and_oracle(rng, H, KV, D):
    q, kc, vc, ks, vs, tbl, ctx = _decode_case(rng, H, KV, D)
    j = [jnp.asarray(a) for a in (q, kc, vc, tbl, ctx)]
    kern = JP.paged_decode_attention(*j, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    oracle = JP.paged_decode_attention_xla(*j, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    out = PP.paged_decode_attention_plain(*(_t(a) for a in (q, kc, vc, tbl, ctx, ks, vs)))
    live = ctx > 0  # the JAX versions leave pad rows as garbage
    for ref in (kern, oracle):
        np.testing.assert_allclose(out.numpy()[live], np.asarray(ref)[live],
                                   atol=KERNEL_VS_ORACLE_ATOL, rtol=0)
    assert not out.numpy()[~live].any()


def _attended(pools, tbl, ctx):
    """Per row, the (block, slot) of each position < ctx of its table."""
    bs = pools[0].shape[1]
    return [(tbl[s, np.arange(c) // bs], np.arange(c) % bs) for s, c in enumerate(ctx)]


def _scaled_limit(pools, tbl, ctx):
    """[S, 1, 1]: KERNEL_VS_ORACLE_ATOL per unit of the largest |dequantized
    v| (code * scale) each row attends to (0 for a pad row)."""
    vc, vs = pools[1], pools[3]
    vmax = [np.abs(vc[b, o].astype(np.float32) * vs[b, o][..., None]).max(initial=0.0)
            for b, o in _attended(pools, tbl, ctx)]
    return KERNEL_VS_ORACLE_ATOL * np.asarray(vmax, np.float32)[:, None, None]


def _n_over(out, ref, limit, live):
    return int((np.abs(out - np.asarray(ref)) > limit)[live].sum())


def _fused_case(rng, H, KV, D):
    """One fused int8 decode of _decode_case's rows with _rows as the new
    rows, by the JAX fused kernel (interpret mode) and the port's plain
    version: (q, tbl, ctx, JAX output, JAX pools, port output, port pools)."""
    q, kc, vc, ks, vs, tbl, ctx = _decode_case(rng, H, KV, D)
    S, bs = q.shape[0], kc.shape[1]
    kn, vn = _rows(rng, S, KV, D), _rows(rng, S, KV, D)
    pos = np.maximum(ctx - 1, 0)
    slots = np.where(ctx > 0, tbl[np.arange(S), pos // bs] * bs + pos % bs, -1).astype(np.int32)
    ref, *jpools = JP.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, tbl, ctx)), k_new=jnp.asarray(kn),
        v_new=jnp.asarray(vn), slots=jnp.asarray(slots), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    pools = [_t(a.copy()) for a in (kc, vc, ks, vs)]
    out, *ppools = PP.paged_decode_fused_plain(_t(q), pools[0], pools[1], _t(tbl), _t(ctx),
                                               _t(kn), _t(vn), _t(slots), pools[2], pools[3])
    assert all(o is p for o, p in zip(ppools, pools))  # in place
    return q, tbl, ctx, ref, [np.asarray(w) for w in jpools], out.numpy(), pools


@pytest.mark.parametrize("H,KV,D", GEOMETRIES)
def test_fused_mode_matches_jax_fused_kernel(rng, H, KV, D):
    """Codes and scales bit-identical; the output within the scaled limit
    (_scaled_limit) of the JAX fused kernel and of the oracle over its
    pools. The JAX pin of 5e-5 unscaled left ~8 float32 ulps at the x30
    rows' scale (~127), and whether two f32 summation orders landed inside
    it depended on the host CPU (19 of 768 elements over by up to 6.0e-5,
    5.2e-6 relative, with bit-identical codes and scales)."""
    q, tbl, ctx, ref, jpools, out, pools = _fused_case(rng, H, KV, D)
    for w, g in zip(jpools, pools):  # codes and scales bit-identical
        np.testing.assert_array_equal(g.numpy(), w)
    live = ctx > 0
    limit = _scaled_limit(jpools, tbl, ctx)
    assert _n_over(out, ref, limit, live) == 0, np.abs(out - np.asarray(ref))[live].max()
    oracle = JP.paged_decode_attention_xla(jnp.asarray(q), *(jnp.asarray(a) for a in jpools[:2]),
                                           jnp.asarray(tbl), jnp.asarray(ctx),
                                           k_scale=jnp.asarray(jpools[2]),
                                           v_scale=jnp.asarray(jpools[3]))
    assert _n_over(out, oracle, limit, live) == 0


@pytest.mark.parametrize("H,KV,D", GEOMETRIES)
def test_fused_mode_limit_catches_one_code_step(rng, H, KV, D):
    """The scaled limit still sees a one-code-step error: in each live row,
    the v code of one element of its most attended (position, KV head)
    moved by one step (toward zero), attended again by the plain version,
    puts that row's output over the limit against the JAX fused kernel."""
    q, tbl, ctx, ref, jpools, out, pools = _fused_case(rng, H, KV, D)
    limit = _scaled_limit(jpools, tbl, ctx)
    G = H // KV
    for s, (blk, off) in enumerate(_attended(jpools, tbl, ctx)):
        if ctx[s] == 0:
            continue
        k = jpools[0][blk, off].astype(np.float32) * jpools[2][blk, off][..., None]
        logits = np.einsum("hd,phd->hp", q[s], np.repeat(k, G, axis=1)) / np.sqrt(D)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        h, at = np.unravel_index(p.argmax(), p.shape)  # the most attended (head, position)
        planted = [x.clone() for x in pools]
        code = planted[1][blk[at], off[at], h // G, 0]
        planted[1][blk[at], off[at], h // G, 0] = code - int(np.sign(code.item()) or -1)
        got = PP.paged_decode_attention_plain(_t(q), planted[0], planted[1], _t(tbl), _t(ctx),
                                              planted[2], planted[3]).numpy()
        row = np.arange(len(ctx)) == s
        assert _n_over(got, ref, limit, row) > 0, (s, p.max())
        assert _n_over(out, ref, limit, row) == 0  # the unplanted row passes


def test_wrappers_on_cpu_run_the_plain_int8_versions(rng):
    PK.reset_launch_counts()
    q, kc, vc, ks, vs, tbl, ctx = _decode_case(rng, 4, 2, 64)
    args = [_t(a) for a in (q, kc, vc, tbl, ctx)]
    np.testing.assert_array_equal(
        PP.paged_decode_attention_int8(*args, _t(ks), _t(vs)).numpy(),
        PP.paged_decode_attention_plain(*args, _t(ks), _t(vs)).numpy())
    kn = _t(_rows(rng, 4, 2, 64))
    pools = [_t(a.copy()) for a in (kc, vc, ks, vs)]
    PP.paged_kv_write_int8(*pools, kn, kn, _t(np.array([3, -1, 9, 40], np.int32)))
    assert PK.launch_counts() == {n: 0 for n in PK.WRAPPERS}


# ---------------------------------------------------------------------------
# the int8 engine against the JAX int8 engine
# ---------------------------------------------------------------------------

def _pool_arrays(cache):
    return [np.asarray(a) for a in cache.k + cache.v + cache.k_scale + cache.v_scale]


def _sync(peng, jeng):
    """Copy the JAX engine's pools (codes and scales) into the port's."""
    c = peng.cache
    for dst, src in zip(c.k + c.v + c.k_scale + c.v_scale, _pool_arrays(jeng.cache)):
        dst.copy_(_t(src))


def _code_agreement(jeng, peng):
    """(share of equal codes over the written rows, largest code gap):
    written rows are the (slot, head) rows whose scale left its initial 1."""
    L = len(peng.cache.k)
    jp, pp = _pool_arrays(jeng.cache), _pool_arrays(peng.cache)
    n_eq = n = gap = 0
    for i in range(2 * L):  # k then v code pools; their scale pools follow
        written = (jp[2 * L + i] != 1) | (pp[2 * L + i] != 1)
        a, b = jp[i][written].astype(np.int32), pp[i][written].astype(np.int32)
        n_eq += int((a == b).sum())
        n += a.size
        gap = max(gap, int(np.abs(a - b).max(initial=0)))
    return n_eq / n, gap, n


@pytest.fixture(scope="module")
def scripted_run():
    jc, pc = jax_config(), torch_config()
    tree = numpy_params(jc, seed=1)
    cfg = dict(SERVE, kv_cache_dtype="int8")
    jeng = jax_init_inference(to_jax(tree), jc, dict(cfg, decode_impl="pallas"),
                              dtype=jnp.float32)
    peng = init_inference(params_from_numpy(tree, pc, device="cpu"), pc, cfg,
                          dtype=torch.float32, device="cpu")
    r = np.random.default_rng(11)
    p0, p1, p2 = (r.integers(0, 512, n).astype(np.int32) for n in (20, 33, 7))
    steps = {
        "prefill": ([0, 1, 2], [p0, p1, p2]),
        "decode": ([0], [np.array([17], np.int32)]),
        "chunk": ([1], [r.integers(0, 512, 3).astype(np.int32)]),
        "decode2": ([0, 2], [np.array([3], np.int32), np.array([4], np.int32)]),
        # uid 1's first two 16-token blocks are indexed: a hit + 5-token suffix
        "prefix_hit": ([3], [np.concatenate([p1[:32], r.integers(0, 512, 5)]).astype(np.int32)]),
        # the whole prompt matches: capped at len-1, the tail block is COW'd
        "prefix_cow": ([4], [p1[:32].copy()]),
    }
    out = {}
    for name, (uids, toks) in steps.items():
        _sync(peng, jeng)
        lj = np.asarray(jeng.put(uids, [t.copy() for t in toks]))
        lp = peng.put(uids, [t.copy() for t in toks])
        out[name] = (lj, lp, jeng.prefix_cache_stats(), peng.prefix_cache_stats(),
                     _code_agreement(jeng, peng))
    _sync(peng, jeng)
    uids = [0, 1, 2]
    tables = peng.state.block_table(uids, peng.config.blocks_per_seq, peng.pad_block)
    ctx = np.array([peng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
    toks = np.array([7, 8, 9], np.int32)
    jg, jl, jeng.cache, _ = jeng.decode_multi_fn(3, 10)(
        jeng.params, jeng.cache, jnp.asarray(toks), jnp.asarray(tables), jnp.asarray(ctx))
    pg, pl_, peng.cache, _ = peng.decode_multi_fn(3, 10)(
        peng.params, peng.cache, toks, tables, ctx)
    out["decode_multi"] = (np.asarray(jg), pg.numpy(), np.asarray(jl), pl_.numpy(),
                           _code_agreement(jeng, peng))
    out["kv_bytes_per_token"] = (jeng.kv_bytes_per_token(), peng.kv_bytes_per_token())
    return out


STEPS = ["prefill", "decode", "chunk", "decode2", "prefix_hit", "prefix_cow"]


@pytest.mark.parametrize("step", STEPS)
def test_int8_put_logits_match_jax_engine(scripted_run, step):
    lj, lp, _, _, _ = scripted_run[step]
    assert lp.shape == lj.shape
    np.testing.assert_allclose(lp, lj, **TOL)
    assert (lp.argmax(-1) == lj.argmax(-1)).all()


@pytest.mark.parametrize("step", STEPS + ["decode_multi"])
def test_int8_codes_written_match_jax_engine(scripted_run, step):
    share, gap, n = scripted_run[step][-1]
    assert n > 0
    assert share >= 0.999 and gap <= 1, (share, gap, n)


@pytest.mark.parametrize("step", STEPS)
def test_int8_stats_match_jax_engine(scripted_run, step):
    _, _, sj, sp, _ = scripted_run[step]
    assert {k: sp[k] for k in STATS} == {k: sj[k] for k in STATS}
    assert sp["kv_quantized"] == 1.0


def test_int8_prefix_paths_were_taken(scripted_run):
    hit, cow = scripted_run["prefix_hit"][3], scripted_run["prefix_cow"][3]
    assert hit["lookup_hits"] == 1 and hit["cached_tokens"] == 32
    assert cow["lookup_hits"] == 2 and cow["cow_copies"] == 1


def test_int8_decode_multi_greedy_tokens_identical(scripted_run):
    jg, pg, jl, pl_, _ = scripted_run["decode_multi"]
    assert pg.shape == (10, 3)
    np.testing.assert_array_equal(pg, jg)
    assert len(np.unique(pg)) > 3  # the tokens actually move
    np.testing.assert_allclose(pl_, jl, **TOL)


def test_int8_bytes_per_token_match_jax_and_clear_the_pin(scripted_run):
    """codes + scales per token as in the JAX engine (2 layers x K and V x
    (2 heads x 128 codes + 2 f32 scales)), and the bf16/int8 ratio at the
    flagship's head_dim 128 clears the reference's 1.8x pin."""
    j, p = scripted_run["kv_bytes_per_token"]
    assert p == j == 2 * 2 * (2 * 128 + 2 * 4)
    bf16 = 2 * 2 * 2 * 128 * 2
    assert bf16 / p >= 1.8


def test_cow_copies_the_scale_tiles():
    pc = torch_config()
    params = params_from_numpy(numpy_params(jax_config(), seed=3), pc, device="cpu")
    eng = init_inference(params, pc, dict(SERVE, kv_cache_dtype="int8"), dtype=torch.float32,
                         device="cpu")
    eng.put([0], [np.arange(40, dtype=np.int32)])
    blocks = eng.state.get(0).blocks
    src, dst = blocks[1], eng.pad_block - 1
    assert dst not in blocks
    eng._copy_block(src, dst)
    for pool in eng._pools():
        torch.testing.assert_close(pool[dst], pool[src], rtol=0, atol=0)
    assert eng.cache.k_scale[0][dst].ne(1).any()
