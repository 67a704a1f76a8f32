"""The sequence split of kernels #7 (`evoformer_fwd`, csrc/evoformer_fwd.cu)
and #10 (`evoformer_bwd_db2`, csrc/evoformer_db2.cu) on the CPU, where their
plans and the split's arithmetic live in Python.

- `fwd_run_plan` and `db2_split_plan`: every sequence falls in exactly one
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
  within 2e-4.
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
         "db2": lambda B, S, N, H, sms: PEK.db2_split_plan(B, S, N, H, 32, sms)}


def _cdiv(a, b):
    return -(-a // b)


def _units(which, B, N, H):
    """CTAs a run: #7's 128-row query tiles, #10's 128 x 64 db2 tiles."""
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
    if which == "fwd" or plan.n == 1:
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
