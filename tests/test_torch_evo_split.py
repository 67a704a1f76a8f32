"""The sequence split of kernels #7 (`evoformer_fwd`, csrc/evoformer_fwd.cu),
#8 and #9 (`evoformer_bwd_dq`, `evoformer_bwd_dkv`, csrc/evoformer_bwd.cu)
and #10 (`evoformer_bwd_db2`, csrc/evoformer_db2.cu) on the CPU, where their
plans and the split's arithmetic live in Python.

- `fwd_run_plan`, `bwd_run_plan` and `db2_split_plan`: every sequence falls in exactly one
  run, in order, runs of ceil(S / n) (the kernels' rule for run c's first
  sequence), none empty; no split where the unsplit grid already holds
  SPLIT_WAVES waves of one CTA an SM, or S < 2 * MIN_RUN; a split where it
  would leave more than half the SMs idle; runs of at least MIN_RUN; the
  plans, CTAs and #10's scratch bytes at the evoformer cases E1-E3 on 132
  SMs, the scratch under a quarter of one f32 [G, N, N] logits tensor.
- A plain model of the split: the plain backward of each chunk's
  sequences as an f32 partial db2, added in chunk order, equals the
  unsplit plain db2 within f32 rounding (rtol 1e-5), and both equal
  jax.vjp through the JAX package's kernels in interpret mode at 3e-3 (the
  pin of tests/test_torch_evoformer.py), with a partial last chunk and N
  off the 64-row tiles. The forward's runs change no arithmetic: the plain
  forward run by run is the whole one bit for bit, and the JAX kernel's
  within 2e-4. Nor do the backward's: the plain backward run by run gives
  dq, dk, dv and the dS row sums of the whole bit for bit, and jax.vjp's
  dq, dk, dv and bias1 gradient within 3e-3.
- A torch model of #8's and #9's arithmetic (the exponent in log2 units
  with log2 e folded into the scale and the biases, P and dS rounded to
  the inputs' dtype tile by tile, the scale on the finished sums, the dS
  row sums in the kernel's order) with a -1e9 mask and N off the tiles:
  in bf16 within `bwd_mismatch` of the plain backward (the tolerance the
  kernels are held to on the card), in f32 within 3e-3 of jax.vjp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import evoformer_attention as JE
from deepspeed_tpu_torch.ops.cuda import evoformer_attention as PEK

H100_SMS = 132
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=3e-3, atol=3e-3)
# (B, S, N, H): the evoformer cases chip_smoke.py times (E1-E3), and small
# ones around the tiles, the waves and MIN_RUN
PLAN_SHAPES = [(1, 128, 256, 8), (1, 256, 256, 4), (1, 512, 384, 8), (1, 1, 1, 1), (1, 7, 37, 2),
               (1, 8, 37, 2), (1, 17, 129, 2), (2, 5, 65, 3), (4, 128, 384, 8), (1, 1000, 64, 1),
               (3, 33, 200, 4), (16, 64, 256, 8)]
PLANS = {"fwd": lambda B, S, N, H, sms: PEK.fwd_run_plan(B, S, N, H, sms),
         "bwd": lambda B, S, N, H, sms: PEK.bwd_run_plan(B, S, N, H, 32, sms),
         "db2": lambda B, S, N, H, sms: PEK.db2_split_plan(B, S, N, H, 32, sms)}


def _cdiv(a, b):
    return -(-a // b)


def _units(which, B, N, H):
    """CTAs a run: #7's and #8's 128-row query tiles, #9's 128-key blocks,
    #10's 128 x 64 db2 tiles."""
    return B * H * _cdiv(N, 128) * (_cdiv(N, 64) if which == "db2" else 1)


@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("which", sorted(PLANS))
def test_every_sequence_falls_in_one_run_in_order(which, shape, sms):
    B, S, N, H = shape
    plan = PLANS[which](B, S, N, H, sms)
    assert plan.n == len(plan.runs) >= 1
    assert [s for first, end in plan.runs for s in range(first, end)] == list(range(S))
    size = _cdiv(S, plan.n)  # the kernels' run c: sequences c * size onwards
    assert plan.runs == tuple((c * size, min(S, (c + 1) * size)) for c in range(plan.n))
    assert all(end > first for first, end in plan.runs)
    assert plan.ctas == plan.n * _units(which, B, N, H)


@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("which", sorted(PLANS))
def test_split_only_where_the_grid_leaves_sms_idle(which, shape, sms):
    B, S, N, H = shape
    units = _units(which, B, N, H)
    plan = PLANS[which](B, S, N, H, sms)
    if units >= PEK.SPLIT_WAVES * sms or S < 2 * PEK.MIN_RUN:
        assert plan.n == 1
    elif 2 * units <= sms:
        assert plan.n > 1  # one wave of half-runs beats one of whole runs
    if plan.n > 1:
        assert _cdiv(S, plan.n) >= PEK.MIN_RUN
    if which != "db2" or plan.n == 1:
        assert (plan.scratch_shape, plan.scratch_bytes) == ((), 0)
    else:
        assert plan.scratch_shape == (plan.n, B * H, N, N)
        assert plan.scratch_bytes == 4 * plan.n * B * H * N * N
        assert plan.scratch_bytes <= 4 * B * S * H * N * N // PEK.MIN_RUN  # f32 [G, N, N] / 4


def test_the_evoformer_cases_plans():
    """E1-E3 (chip_smoke.py EVO_CASES) on 132 SMs: #7's runs and CTAs, #10's
    chunks, CTAs and scratch, the scratch under one f32 [G, N, N] tensor
    (268,435,456 / 268,435,456 / 2,415,919,104 bytes)."""
    want = {(1, 128, 256, 8): (8, 16, 128, 2, 64, 128, 4_194_304),
            (1, 256, 256, 4): (16, 16, 128, 4, 64, 128, 4_194_304),
            (1, 512, 384, 8): (11, 47, 264, 11, 47, 1584, 51_904_512)}
    for (B, S, N, H), (fn, fsize, fctas, dn, dsize, dctas, scratch) in want.items():
        f = PEK.fwd_run_plan(B, S, N, H, H100_SMS)
        d = PEK.db2_split_plan(B, S, N, H, 32, H100_SMS)
        assert (f.n, f.runs[0][1], f.ctas) == (fn, fsize, fctas)
        assert (d.n, d.runs[0][1], d.ctas, d.scratch_bytes) == (dn, dsize, dctas, scratch)
        assert d.scratch_bytes < 4 * B * S * H * N * N
        # #8 and #9: 128-row CTAs at both head dims, so #7's runs
        for D in (32, 64):
            assert PEK.bwd_run_plan(B, S, N, H, D, H100_SMS) == f


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_the_backward_plan_is_the_same_at_both_head_dims(shape):
    """#8 and #9 keep 128-row CTAs at D 32 and 64, so one plan serves both
    kernels and both head dims."""
    B, S, N, H = shape
    assert PEK.bwd_run_plan(B, S, N, H, 32, H100_SMS) == PEK.bwd_run_plan(B, S, N, H, 64,
                                                                          H100_SMS)


def _inputs(S, N, H, D=32, seed=5):
    """q, k, v, dO [1, S, N, H, D], an MSA mask bias (-1e9 on ~20% of the
    keys, never a whole row) and a pair bias, numpy f32."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((1, S, N, H, D)).astype(np.float32) for _ in range(4))
    masked = rng.random((1, S, 1, 1, N)) < 0.2
    masked[..., 0] = False
    b1 = np.where(masked, -1e9, 0.0).astype(np.float32)
    b2 = rng.standard_normal((1, 1, H, N, N)).astype(np.float32)
    return q, k, v, do, b1, b2


def _np_args(S, N, H):
    q, k, v, _, b1, b2 = _inputs(S, N, H)
    return q, k, v, b1, b2


# (S, N, H, sms): splits with a partial last chunk (S 9 in chunks of 5, S 17
# in chunks of 5) and N off the kernels' 64-row tiles
SPLIT_CASES = {"s9_n40": (9, 40, 2, 16), "s17_n70": (17, 70, 2, 16)}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_then_combine_equals_unsplit_and_jax(case):
    S, N, H, sms = SPLIT_CASES[case]
    plan = PEK.db2_split_plan(1, S, N, H, 32, sms)
    assert 1 < plan.n < S and plan.runs[-1][1] - plan.runs[-1][0] < plan.runs[0][1]
    q, k, v, do, b1, b2 = (torch.from_numpy(a) for a in _inputs(S, N, H))
    o, lse = PEK.evoformer_fwd_plain(q, k, v, b1, b2)
    delta = PEK._delta(o, do)
    part = None
    for first, end in plan.runs:  # each chunk's f32 partial, added in chunk order
        sl = slice(first, end)
        rows = lambda x: x.reshape(S, H, N)[sl].reshape(-1, N)
        p = PEK._bwd_plain(q[:, sl], k[:, sl], v[:, sl], b1[:, sl], b2, rows(lse), rows(delta),
                           do[:, sl])[4]
        part = p if part is None else part + p
    whole = PEK._bwd_plain(q, k, v, b1, b2, lse, delta, do)[4]
    torch.testing.assert_close(part, whole, rtol=1e-5, atol=1e-5 * whole.abs().max().item())
    _, vjp = jax.vjp(lambda q, k, v, b1, b2: JE._evo_fused(q, k, v, b1, b2, True, True, 512),
                     *(jnp.asarray(a) for a in _np_args(S, N, H)))
    jdb2 = np.asarray(vjp(jnp.asarray(do.numpy()))[4])
    np.testing.assert_allclose(part.numpy(), jdb2, err_msg="split db2", **GRAD_TOL)
    np.testing.assert_allclose(whole.numpy(), jdb2, err_msg="unsplit db2", **GRAD_TOL)


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_forward_runs_change_no_arithmetic(case):
    S, N, H, sms = SPLIT_CASES[case]
    plan = PEK.fwd_run_plan(1, S, N, H, sms)
    assert plan.n > 1
    q, k, v, _, b1, b2 = (torch.from_numpy(a) for a in _inputs(S, N, H))
    o, lse = PEK.evoformer_fwd_plain(q, k, v, b1, b2)
    parts = [PEK.evoformer_fwd_plain(q[:, a:e], k[:, a:e], v[:, a:e], b1[:, a:e], b2)
             for a, e in plan.runs]
    assert torch.equal(torch.cat([p[0] for p in parts], 1), o)
    assert torch.equal(torch.cat([p[1] for p in parts]), lse)
    jo = JE._evo_fused(*(jnp.asarray(a) for a in _np_args(S, N, H)), True, True, 512)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)


def test_the_cpu_wrapper_is_the_unsplit_plain_db2():
    """On CPU tensors evoformer_bwd_db2 takes the plain version whatever the
    plan; no scratch is made."""
    S, N, H, _ = SPLIT_CASES["s17_n70"]
    q, k, v, do, b1, b2 = (torch.from_numpy(a) for a in _inputs(S, N, H))
    o, lse = PEK.evoformer_fwd_plain(q, k, v, b1, b2)
    delta = PEK._delta(o, do)
    got = PEK.evoformer_bwd_db2(q, k, v, b1, b2, do, lse, delta)
    assert torch.equal(got, PEK._bwd_plain(q, k, v, b1, b2, lse, delta, do)[4])


def _run_by_run(plan, S, H, N, q, k, v, b1, b2, lse, delta, do):
    """The plain backward of each run's sequences alone, concatenated:
    dq, dk, dv along S, the dS row sums along their (b, s, h) rows."""
    outs = []
    for first, end in plan.runs:
        sl = slice(first, end)
        rows = lambda x: x.reshape(S, H, N)[sl].reshape(-1, N)
        outs.append(PEK._bwd_plain(q[:, sl], k[:, sl], v[:, sl], b1[:, sl], b2, rows(lse),
                                   rows(delta), do[:, sl])[:4])
    return [torch.cat([o[i] for o in outs], 0 if i == 3 else 1) for i in range(4)]


def _jax_grads(S, N, H, do):
    """jax.vjp of the JAX package's fused evoformer attention (its Pallas
    kernels in interpret mode), both biases: dq, dk, dv, db1, db2."""
    _, vjp = jax.vjp(lambda q, k, v, b1, b2: JE._evo_fused(q, k, v, b1, b2, True, True, 512),
                     *(jnp.asarray(a) for a in _np_args(S, N, H)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_backward_runs_change_no_arithmetic(case):
    """#8 and #9 compute every sequence's outputs alone: the plain backward
    over the plan's runs is the whole one bit for bit, and both are
    jax.vjp's within 3e-3 (bias1's gradient from the row sums)."""
    S, N, H, sms = SPLIT_CASES[case]
    plan = PEK.bwd_run_plan(1, S, N, H, 32, sms)
    assert 1 < plan.n < S
    q, k, v, do, b1, b2 = (torch.from_numpy(a) for a in _inputs(S, N, H))
    o, lse = PEK.evoformer_fwd_plain(q, k, v, b1, b2)
    delta = PEK._delta(o, do)
    whole = PEK._bwd_plain(q, k, v, b1, b2, lse, delta, do)[:4]
    runs = _run_by_run(plan, S, H, N, q, k, v, b1, b2, lse, delta, do)
    for name, a, b in zip(("dq", "dk", "dv", "dsum"), runs, whole):
        assert torch.equal(a, b), name
    jdq, jdk, jdv, jdb1, _ = _jax_grads(S, N, H, do)
    for name, got, want in (("dq", runs[0], jdq), ("dk", runs[1], jdk), ("dv", runs[2], jdv),
                            ("db1", PEK._db1(runs[3], b1), jdb1)):
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **GRAD_TOL)


# ---------------------------------------------------------------------------
# a model of the arithmetic of kernels #8 and #9
# ---------------------------------------------------------------------------

LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
QUERY_TILE = 64  # #9's ring tiles of queries


def _fma(a, b, c):
    """f32 a * b + c rounded once, as the kernels' fmaf (the product of two
    f32 values is exact in f64; one f64 rounding, then the f32 one)."""
    return (a.double() * b.double() + c.double()).float()


def _key_tile(D):
    """#8's key tile: 128 keys at D 32, 64 at D 64 (csrc/evoformer_bwd.cu
    DqCfg)."""
    return 128 if D == 32 else 64


def _model_consts(q, b1, b2):
    """The kernels' scale in log2 units (the host's f32 scale x log2 e),
    bias1 x log2 e per key [B, S, 1, 1, N] and bias2 [B, 1, H, N, N] as
    f32 (zeros where absent)."""
    B, S, N, H, D = q.shape
    scale = torch.tensor(1.0 / D ** 0.5, dtype=torch.float32)
    b1x = (b1.float() * LOG2E) if b1 is not None else torch.zeros(B, S, 1, 1, N)
    b2f = b2.float() if b2 is not None else torch.zeros(B, 1, H, N, N)
    return scale, scale * LOG2E, b1x.reshape(B, S, 1, 1, N), b2f


def _model_dq(q, k, v, b1, b2, do, lse, delta):
    """dq as kernel #8 computes it: per key tile, x = fma(s, scale log2 e,
    fma(bias2, log2 e, bias1 log2 e)), P = 2^(x - lse log2 e), dS = P (dP -
    delta) rounded to the inputs' dtype, dQ += dS K in f32 tile by tile;
    dq = dQ x scale in the inputs' dtype."""
    B, S, N, H, D = q.shape
    scale, scale_log2, b1x, b2f = _model_consts(q, b1, b2)
    l2 = lse.reshape(B, S, H, N, 1) * LOG2E
    dl = delta.reshape(B, S, H, N, 1)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    acc = torch.zeros(B, S, H, N, D)
    for k0 in range(0, N, _key_tile(D)):
        ks = slice(k0, k0 + _key_tile(D))
        s = torch.einsum("bsqhd,bskhd->bshqk", qf, kf[:, :, ks])
        dp = torch.einsum("bsqhd,bskhd->bshqk", dof, vf[:, :, ks])
        x = _fma(s, scale_log2, _fma(b2f[..., ks], LOG2E, b1x[..., ks]))
        ds = torch.exp2(x - l2) * (dp - dl)
        acc = acc + torch.einsum("bshqk,bskhd->bshqd", ds.to(q.dtype).float(), kf[:, :, ks])
    return (acc * scale).to(q.dtype).permute(0, 1, 3, 2, 4).contiguous()


def _model_dkv(q, k, v, b1, b2, do, lse, delta):
    """dk, dv and the dS row sums as kernel #9 computes them: per 64-query
    tile, S^T and dP^T, P^T = 2^(x - lse log2 e) with the query's lse by
    column, dV += P^T dO and dK += dS^T Q with P^T and dS^T rounded to the
    inputs' dtype; dk = dK x scale. The row sums add the unrounded f32 dS
    in the kernel's order: the thread of quad lane j adds queries 8g + 2j
    and 8g + 2j + 1 of each tile, g = 0..7, one after the other across the
    tiles, then the quad adds its four parts as (p0 + p1) + (p2 + p3)."""
    B, S, N, H, D = q.shape
    scale, scale_log2, b1x, b2f = _model_consts(q, b1, b2)
    l2 = lse.reshape(B, S, H, 1, N) * LOG2E
    dl = delta.reshape(B, S, H, 1, N)
    b1k = b1x.reshape(B, S, 1, N, 1)
    b2t = b2f.transpose(-1, -2)  # [key][query]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dk, dv = torch.zeros(B, S, H, N, D), torch.zeros(B, S, H, N, D)
    part = torch.zeros(B, S, H, N, 4)
    for q0 in range(0, N, QUERY_TILE):
        qs = slice(q0, q0 + QUERY_TILE)
        st = torch.einsum("bskhd,bsqhd->bshkq", kf, qf[:, :, qs])
        dpt = torch.einsum("bskhd,bsqhd->bshkq", vf, dof[:, :, qs])
        x = _fma(st, scale_log2, _fma(b2t[..., qs], LOG2E, b1k))
        p = torch.exp2(x - l2[..., qs])
        ds = p * (dpt - dl[..., qs])
        dv = dv + torch.einsum("bshkq,bsqhd->bshkd", p.to(q.dtype).float(), dof[:, :, qs])
        dk = dk + torch.einsum("bshkq,bsqhd->bshkd", ds.to(q.dtype).float(), qf[:, :, qs])
        cols = torch.nn.functional.pad(ds, (0, QUERY_TILE - ds.shape[-1]))
        cols = cols.reshape(B, S, H, N, 8, 4, 2)  # (g, quad lane j, pair member)
        for g in range(8):
            for e in range(2):
                part = part + cols[..., g, :, e]
    dsum = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
    out = lambda t: t.to(q.dtype).permute(0, 1, 3, 2, 4).contiguous()
    return out(dk * scale), out(dv), dsum.reshape(B * S * H, N)


# (S, N, H): N off every tile (#8's 128- and 64-key tiles, #9's 64-query
# tiles) and below one
MODEL_CASES = {"s3_n70": (3, 70, 2), "s2_n200": (2, 200, 2)}


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_the_kernels_arithmetic_matches_plain_and_jax(case, D):
    S, N, H = MODEL_CASES[case]
    arrays = _inputs(S, N, H, D=D, seed=11)
    # bf16: the kernels' rounding, held as the card holds the kernels
    q, k, v, do, b1, b2 = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    o, lse = PEK.evoformer_fwd_plain(q, k, v, b1, b2)
    delta = PEK._delta(o, do)
    args = (q, k, v, b1, b2, do, lse, delta)
    got = (_model_dq(*args),) + _model_dkv(*args)
    ref = PEK._bwd_plain(q, k, v, b1, b2, lse, delta, do)[:4]
    for name, g, r in zip(("dq", "dk", "dv", "dsum"), got, ref):
        stats = PEK.bwd_mismatch(g, r)
        assert stats["n_over"] == 0, (name, stats)
        assert g.float().abs().max() > 0, name
    # f32: rounding to the inputs' dtype is a no-op; against jax.vjp
    q, k, v, do, b1, b2 = (torch.from_numpy(a) for a in arrays)
    o, lse = PEK.evoformer_fwd_plain(q, k, v, b1, b2)
    args = (q, k, v, b1, b2, do, lse, PEK._delta(o, do))
    dq, (dk, dv, dsum) = _model_dq(*args), _model_dkv(*args)
    _, vjp = jax.vjp(lambda q, k, v, b1, b2: JE._evo_fused(q, k, v, b1, b2, True, True, 512),
                     *(jnp.asarray(a) for a in (arrays[0], arrays[1], arrays[2], arrays[4],
                                                arrays[5])))
    jdq, jdk, jdv, jdb1, _ = (np.asarray(g) for g in vjp(jnp.asarray(arrays[3])))
    for name, got_, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv),
                             ("db1", PEK._db1(dsum, b1), jdb1)):
        np.testing.assert_allclose(got_.numpy(), want, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("n_runs", [None, 1, 17])
def test_the_cpu_backward_wrappers_are_the_plain_backward_whatever_the_runs(n_runs):
    """On CPU tensors evoformer_bwd_dq and evoformer_bwd_dkv take the plain
    version whatever run count is planned or asked for."""
    S, N, H, _ = SPLIT_CASES["s17_n70"]
    q, k, v, do, b1, b2 = (torch.from_numpy(a) for a in _inputs(S, N, H))
    o, lse = PEK.evoformer_fwd_plain(q, k, v, b1, b2)
    args = (q, k, v, b1, b2, do, lse, PEK._delta(o, do))
    plain = PEK._bwd_plain(*args[:5], lse, args[7], do)
    assert torch.equal(PEK.evoformer_bwd_dq(*args, n_runs=n_runs), plain[0])
    for got, want in zip(PEK.evoformer_bwd_dkv(*args, n_runs=n_runs), plain[1:4]):
        assert torch.equal(got, want)
