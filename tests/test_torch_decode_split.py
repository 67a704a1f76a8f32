"""The split-K of kernels #4/#5 (csrc/paged_decode.cu) on the CPU, where its
plan and the split's arithmetic live in Python.

- `decode_split_plan`: every position of the span falls in exactly one
  split, in order, splits of whole 64-column tiles, none empty of the span;
  the plan reads the shapes only (S, KV, G, D, the span, the SM count:
  never the window, the slopes, the bitmap or ctx_lens); no split where S x
  KV already fills the card (3968 suffix rows x 32 KV heads); the splits,
  CTAs and scratch bytes at chip_smoke.py's phase-2 decode shapes.
- A plain model of split-then-combine (_split_model: each split's f32
  partial m, l and acc per query head, by the kernel's rules for which
  positions a split owns, added in split order as the kernel's combine
  does) equals the unsplit plain version within f32 rounding (rtol 1e-5)
  and the JAX package's paged_decode_attention in interpret mode and
  paged_decode_attention_xla at the pins of tests/test_torch_kernels.py
  (TestDecode: 1e-5), in all four modes, with a window starting
  mid-block, ALiBi slopes, a bitmap with a split wholly in a hole, the
  fused new column in exactly one split, empty splits, a pad row, groups
  of 1, 4 and 71 and cache blocks of 16 and 128.
- The kernel's P V keeps P as bf16(P) + bf16(P - bf16(P)): the model run
  that way stays within the same rtol of the f32 one.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import paged_attention as JP
from deepspeed_tpu_torch.ops.cuda import paged_attention as PP

H100_SMS = 132
F32_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_kernels.py's pin
SPLIT_TOL = F32_TOL  # f32 rounding: the splits regroup the same sums
MODES = ["plain", "fused", "int8", "fused_int8"]
# (S, KV, G, D, span): chip_smoke.py's phase-2 decode shapes and the flagship's
PHASE2 = {"falcon_7b": (8, 1, 71, 64, 2048), "mistral_window": (8, 8, 4, 128, 8192),
          "bloom_alibi": (8, 32, 1, 128, 2048), "phi_2": (8, 32, 1, 80, 2048),
          "flagship": (8, 8, 1, 128, 1024)}
PLAN_SHAPES = list(PHASE2.values()) + [
    (1, 1, 1, 64, 16), (3, 2, 9, 128, 200), (2, 1, 130, 64, 4096), (1, 8, 16, 80, 65536),
    (64, 8, 4, 128, 8192), (3968, 32, 1, 128, 4096), (1, 1, 71, 64, 64), (5, 3, 2, 64, 1000)]


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# decode_split_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_every_position_falls_in_one_split_in_order(shape, sms):
    S, KV, G, D, span = shape
    plan = PP.decode_split_plan(S, KV, G, D, span, sms)
    L = plan.split_len
    assert 1 <= plan.n <= PP.MAX_SPLITS and L % PP.TILE == 0 and L > 0
    splits = [(c * L, min((c + 1) * L, span)) for c in range(plan.n)]
    assert all(first < end for first, end in splits)  # none empty of the span
    assert [p for first, end in splits for p in range(first, end)] == list(range(span))
    assert plan.ctas == S * KV * _cdiv(G, PP.MAX_GROUP_CTA) * plan.n
    if plan.n == 1:
        assert (plan.scratch_shape, plan.scratch_bytes) == ((), 0)
    else:
        assert plan.scratch_shape == (S, KV, plan.n * G * (D + 2))
        assert plan.scratch_bytes == 4 * S * KV * plan.n * G * (D + 2)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_only_where_the_grid_leaves_sms_idle(shape):
    S, KV, G, D, span = shape
    units = S * KV * _cdiv(G, PP.MAX_GROUP_CTA)
    plan = PP.decode_split_plan(S, KV, G, D, span, H100_SMS)
    if units >= PP.SPLIT_WAVES * H100_SMS or span <= PP.TILE:
        assert plan.n == 1
    elif 4 * units <= H100_SMS and span >= 32 * PP.TILE and G <= 16:
        assert plan.n > 1  # a quarter of the card would idle unsplit
    if plan.n > 1:  # enough tile-slices a split to outweigh a CTA's fixed cost
        slices = _cdiv(min(G, PP.MAX_GROUP_CTA), PP.SLICE)
        assert plan.split_len // PP.TILE * slices >= PP.MIN_SPLIT_WORK


def test_the_plan_reads_shapes_only():
    """The plan's arguments are the shapes and the SM count: the window,
    the slopes, the bitmap and ctx_lens cannot move a split boundary, so
    window >= ctx stays window 0's result bit for bit, an all-ones bitmap
    none's, zero slopes null's (on the card: TestDecodeSplitOnCard's
    test_neutral_options_bit_identical_to_none)."""
    assert list(inspect.signature(PP.decode_split_plan).parameters) == [
        "S", "KV", "G", "D", "span", "sm_count"]


def test_no_split_where_the_rows_fill_the_card():
    """A prefix-hit suffix or chunked continuation of 3968 rows over 32 KV
    heads: the grid is S x KV, no scratch, no second pass."""
    plan = PP.decode_split_plan(3968, 32, 1, 128, 4096, H100_SMS)
    assert (plan.n, plan.scratch_bytes, plan.ctas) == (1, 0, 3968 * 32)
    assert plan.split_len >= 4096


@pytest.mark.parametrize("case", sorted(PHASE2))
def test_plans_at_the_phase_2_shapes(case):
    """The splits, CTAs and scratch of the decode shapes chip_smoke.py
    times (8 rows each): Falcon-7B's wide group, Mistral's window rows over
    8192 positions, BLOOM-7B1's and Phi-2's 32 KV heads, the flagship."""
    want = {"falcon_7b": (16, 128, 128, 2_399_232),
            "mistral_window": (16, 512, 1024, 2_129_920),
            "bloom_alibi": (4, 512, 1024, 532_480),
            "phi_2": (4, 512, 1024, 335_872),
            "flagship": (2, 512, 128, 66_560)}[case]
    plan = PP.decode_split_plan(*PHASE2[case], H100_SMS)
    assert (plan.n, plan.split_len, plan.ctas, plan.scratch_bytes) == want


# ---------------------------------------------------------------------------
# the plain model of split-then-combine
# ---------------------------------------------------------------------------

def _p_two_bf16(p):
    """p as the kernel feeds it to P V: bf16(p) + bf16(p - bf16(p))."""
    hi = p.to(torch.bfloat16).float()
    return hi + (p - hi).to(torch.bfloat16).float()


def _split_model(q, k, v, ctx, plan, window=0, slopes=None, allowed_slots=None, fused=False,
                 p_rounding=None):
    """The kernel's split-K in plain f32: split c of row s owns the cache
    positions [max(c L, ctx - window), min((c + 1) L, span, limit)) of
    allowed blocks (limit ctx - 1 fused, else ctx) and, fused, the new
    column ctx - 1 if c = min((ctx - 1) // L, n - 1); each split's m, l
    and acc = sum_p exp(s_p - m) v_p per query head, added in split order
    with weights exp(m_c - max m) (0 for an empty split), zeros where no
    position is live. k, v: each row's dense context [S, span, KV, D] f32
    (the new row already in place when fused). Returns (out [S, H, D],
    the owner split of each row's new column or -1, the non-empty splits
    of each row)."""
    S, H, D = q.shape
    span, KV = k.shape[1], k.shape[2]
    G, L, n = H // KV, plan.split_len, plan.n
    bs = span // allowed_slots.shape[1] if allowed_slots is not None else span
    slope = slopes.float() if slopes is not None else torch.zeros(H)
    out = torch.zeros(S, H, D)
    owners, live_splits = [], []
    for s in range(S):
        c_ = int(ctx[s])
        limit = min(c_ - 1 if fused else c_, span)
        wlo = max(c_ - window, 0) if window > 0 else 0
        owner = min((c_ - 1) // L, n - 1) if fused and c_ > 0 else -1
        owners.append(owner)
        parts = []
        for c in range(n):
            pos = [p for p in range(max(c * L, wlo), min((c + 1) * L, span, limit))
                   if allowed_slots is None or allowed_slots[s, p // bs] != 0]
            if c == owner:
                pos.append(c_ - 1)
            if not pos:
                parts.append(None)
                continue
            P = torch.tensor(pos)
            kk = k[s, P].repeat_interleave(G, 1)  # [n_pos, H, D]
            vv = v[s, P].repeat_interleave(G, 1)
            logits = torch.einsum("hd,phd->hp", q[s].float(), kk) / D ** 0.5
            logits = logits + slope[:, None] * P.float()[None, :]
            m = logits.max(-1).values
            p = torch.exp(logits - m[:, None])
            l = p.sum(-1)
            if p_rounding is not None:
                p = p_rounding(p)
            parts.append((m, l, torch.einsum("hp,phd->hd", p, vv)))
        live_splits.append([c for c, x in enumerate(parts) if x is not None])
        full = [x for x in parts if x is not None]
        if not full:
            continue
        M = torch.stack([m for m, _, _ in full]).max(0).values
        acc, Lsum = torch.zeros(H, D), torch.zeros(H)
        for m, l, a in full:  # split order
            w = torch.exp(m - M)
            acc += a * w[:, None]
            Lsum += l * w
        out[s] = acc / Lsum[:, None]
    return out, owners, live_splits


def _case(rng, mode, G, bs, D=64, span=512):
    """Six rows over a span of 512 positions (NB = 512 / bs): ctx 1 (one
    position; fused: only its new column), 130 (just past a split of 128),
    300 (a window of 100 starts mid-block at 200), 0 (a pad row), 511 and
    257. A bitmap holds each row's own block and, for row 4, leaves the
    whole of positions 128-255 out (a split wholly in a hole)."""
    KV = 1 if G == 71 else 2
    H, NB = G * KV, span // bs
    S = 6
    nblk = S * NB + 1
    ctx = np.array([1, 130, 300, 0, 511, 257], np.int32)
    tbl = rng.permutation(nblk - 1)[: S * NB].reshape(S, NB).astype(np.int32)
    tbl[3] = nblk - 1
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    k_new = rng.standard_normal((S, KV, D)).astype(np.float32)
    v_new = rng.standard_normal((S, KV, D)).astype(np.float32)
    pos = np.maximum(ctx - 1, 0)
    slots = np.where(ctx > 0, tbl[np.arange(S), pos // bs] * bs + pos % bs, -1).astype(np.int32)
    allowed = (rng.random((S, NB)) < 0.6).astype(np.int32)
    allowed[np.arange(S), pos // bs] = 1
    allowed[4, 128 // bs:256 // bs] = 0
    if "int8" in mode:
        codes = rng.integers(-127, 128, (2, nblk, bs, KV, D)).astype(np.int8)
        scales = (rng.random((2, nblk, bs, KV)) * 0.02 + 1e-3).astype(np.float32)
        pools = [torch.from_numpy(codes[0]), torch.from_numpy(codes[1]),
                 torch.from_numpy(scales[0]), torch.from_numpy(scales[1])]
    else:
        pools = [torch.from_numpy(rng.standard_normal((nblk, bs, KV, D)).astype(np.float32))
                 for _ in range(2)]
    slopes = torch.from_numpy((2.0 ** -np.arange(1, H + 1) / 4).astype(np.float32))
    return dict(q=torch.from_numpy(q), pools=pools, tbl=torch.from_numpy(tbl),
                ctx=torch.from_numpy(ctx), k_new=torch.from_numpy(k_new),
                v_new=torch.from_numpy(v_new), slots=torch.from_numpy(slots),
                allowed=torch.from_numpy(allowed), slopes=slopes, span=span, bs=bs)


def _plain(mode, x, pools, window, slopes, allowed):
    """The unsplit plain version; fused modes write the new row into
    `pools` (in place) first."""
    kw = dict(window=window, alibi_slopes=slopes, allowed_slots=allowed)
    if mode in ("plain", "int8"):
        return PP.paged_decode_attention_plain(x["q"], pools[0], pools[1], x["tbl"], x["ctx"],
                                               *pools[2:], **kw)
    return PP.paged_decode_fused_plain(x["q"], pools[0], pools[1], x["tbl"], x["ctx"],
                                       x["k_new"], x["v_new"], x["slots"], *pools[2:], **kw)[0]


def _dense(x, pools):
    """Each row's context [S, span, KV, D] f32 from the (written) pools,
    dequantized to q's dtype on int8 pools, as the plain version reads it."""
    tbl = x["tbl"].long()
    S = tbl.shape[0]
    KV, D = pools[0].shape[2:]
    k = pools[0][tbl].reshape(S, -1, KV, D)
    v = pools[1][tbl].reshape(S, -1, KV, D)
    if len(pools) > 2:
        k = PP.dequantize(k, pools[2][tbl].reshape(S, -1, KV), x["q"].dtype)
        v = PP.dequantize(v, pools[3][tbl].reshape(S, -1, KV), x["q"].dtype)
    return k.float(), v.float()


FEATURES = {"dense": (0, False, False), "window_100": (100, False, False),
            "alibi": (0, True, False), "bitmap": (0, False, True),
            "window_alibi_bitmap": (100, True, True)}


@pytest.mark.parametrize("feature", sorted(FEATURES))
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("G", [1, 4, 71])
@pytest.mark.parametrize("mode", MODES)
def test_split_model_equals_the_unsplit_plain_version(mode, G, bs, feature):
    rng = np.random.default_rng(G * 1000 + bs)
    x = _case(rng, mode, G, bs)
    window, alibi, bitmap = FEATURES[feature]
    slopes = x["slopes"] if alibi else None
    allowed = x["allowed"] if bitmap else None
    pools = [p.clone() for p in x["pools"]]
    ref = _plain(mode, x, pools, window, slopes, allowed)
    k, v = _dense(x, pools)
    fused = "fused" in mode
    plan = PP.decode_split_plan_for(6, k.shape[2], G, k.shape[3], x["span"], 4)
    assert (plan.n, plan.split_len) == (4, 128)
    got, owners, live = _split_model(x["q"], k, v, x["ctx"], plan, window, slopes, allowed,
                                     fused)
    torch.testing.assert_close(got, ref.float(), **SPLIT_TOL)
    assert not got[3].any() and 3 not in [s for s, sp in enumerate(live) if sp]  # pad row
    assert live[0] == [0]  # ctx 1: one split, the rest empty
    if fused:  # the new column in exactly one split: the one holding ctx - 1
        assert owners == [min(int(c - 1) // 128, 3) if c > 0 else -1 for c in x["ctx"]]
    if bitmap:
        assert 1 not in live[4]  # row 4's split 1 lies wholly in a hole
    if feature == "window_100":
        assert live[2] == [1, 2]  # positions 200-299: the window starts mid-block


@pytest.mark.parametrize("feature", ["dense", "window_alibi_bitmap"])
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("G", [1, 4, 71])
@pytest.mark.parametrize("mode", MODES)
def test_split_model_matches_the_jax_kernel_and_oracle(mode, G, bs, feature):
    """Against paged_decode_attention (interpret mode) and
    paged_decode_attention_xla on the pools the JAX kernel wrote (fused
    modes), live rows only (the JAX package leaves pad rows as garbage)."""
    rng = np.random.default_rng(7 + G + bs)
    x = _case(rng, mode, G, bs)
    window, alibi, bitmap = FEATURES[feature]
    slopes = x["slopes"] if alibi else None
    allowed = x["allowed"] if bitmap else None
    j = lambda t: None if t is None else jnp.asarray(t.numpy())
    fused = "fused" in mode
    jpools = [j(p) for p in x["pools"]]
    scales = dict(k_scale=jpools[2], v_scale=jpools[3]) if len(jpools) > 2 else {}
    extra = dict(k_new=j(x["k_new"]), v_new=j(x["v_new"]), slots=j(x["slots"])) if fused else {}
    res = JP.paged_decode_attention(j(x["q"]), jpools[0], jpools[1], j(x["tbl"]), j(x["ctx"]),
                                    window=window, allowed_slots=j(allowed),
                                    alibi_slopes=j(slopes), **extra, **scales)
    if fused:
        jout, written = res[0], [torch.from_numpy(np.asarray(a)) for a in res[1:]]
    else:
        jout, written = res, x["pools"]
    S, bs_ = x["tbl"].shape[0], x["bs"]
    pos_allowed = None
    if allowed is not None:
        pos_allowed = allowed.bool().repeat_interleave(bs_, 1)
        if fused:
            pos_allowed[torch.arange(S), (x["ctx"].long() - 1).clamp(min=0)] = True
    oracle = JP.paged_decode_attention_xla(
        j(x["q"]), j(written[0]), j(written[1]), j(x["tbl"]), j(x["ctx"]),
        allowed=j(pos_allowed), window=window, alibi_slopes=j(slopes),
        k_scale=j(written[2]) if len(written) > 2 else None,
        v_scale=j(written[3]) if len(written) > 2 else None)
    k, v = _dense(x, written)
    plan = PP.decode_split_plan_for(S, k.shape[2], G, k.shape[3], x["span"], 4)
    got, _, _ = _split_model(x["q"], k, v, x["ctx"], plan, window, slopes, allowed, fused)
    live = x["ctx"].numpy() > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(jout)[live], **F32_TOL)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(oracle)[live], **F32_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_p_as_two_bf16_terms_stays_within_f32_rounding(mode):
    """The kernel's P V takes P as bf16(P) + bf16(P - bf16(P)) (~16 bits):
    the model run so stays within rtol 1e-5 of the f32 one, where P once
    rounded to bf16 (the TPU kernel's choice) does not."""
    rng = np.random.default_rng(3)
    x = _case(rng, mode, 4, 16)
    pools = [p.clone() for p in x["pools"]]
    _plain(mode, x, pools, 0, None, None)
    k, v = _dense(x, pools)
    plan = PP.decode_split_plan_for(6, k.shape[2], 4, k.shape[3], x["span"], 4)
    fused = "fused" in mode
    f32, _, _ = _split_model(x["q"], k, v, x["ctx"], plan, fused=fused)
    two, _, _ = _split_model(x["q"], k, v, x["ctx"], plan, fused=fused,
                             p_rounding=_p_two_bf16)
    one, _, _ = _split_model(x["q"], k, v, x["ctx"], plan, fused=fused,
                             p_rounding=lambda p: p.to(torch.bfloat16).float())
    torch.testing.assert_close(two, f32, **SPLIT_TOL)
    assert not torch.allclose(one, f32, **SPLIT_TOL)
    p = torch.rand(10000) * 2 - 1
    assert ((_p_two_bf16(p) - p).abs() <= 2.0 ** -16 * p.abs()).all()
