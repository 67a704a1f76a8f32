"""The W8A16 GEMM's design (csrc/int8_matmul.cu) on the CPU, where its plan
and its arithmetic can be followed in Python: a torch model of what the
kernel computes, held against the plain version and against the JAX
package's `_wmm` and `_lm_logits` on the same codes.

- The grid: `segments` (each CTA's contiguous range of the (tile,
  128-deep unit) units, cut at tile boundaries) covers every unit once,
  each tile's segments in CTA order and in k order; a CTA has at most two
  partial segments, its first in slot 2 g and its last in slot 2 g + 1;
  a cut tile ends in the first segment of the CTA that holds its last
  unit (the kernel's cta_of), which waits for the tile's other CTAs, all
  of lower index; the CTA ranges are those of the kernel's unit_start.
- The model (_kernel_model) runs the kernel's arithmetic: operands
  swapped (a tile is [128 channels] x [tn tokens], the channels as
  wgmma's M), TMA's zero fill past M, N and K, each unit's products
  added in f32 in unit order, a cut tile's partials added in CTA order
  by the CTA that ends it, the tile stored transposed into Y[token,
  channel], and the two epilogue roundings (bf16(bf16(sum) x bf16(s)),
  or f32(bf16(sum)) x s for the logits). Codes and x keep their natural
  k order: no permutation to undo.
- Tolerance: the model's f32 sums are the exact (f64) sums up to f32
  rounding of the sum order (1e-5 of the sum of |x| |q|); after the bf16
  roundings, which the model applies exactly as the kernel does, it
  equals the plain version in all but a few elements (a sum that lies
  within its f32 rounding of a bf16 rounding boundary), and there by one
  bf16 ulp (tests/test_torch_quant_weights.py's pin: rtol 8e-3, atol 1e-3
  of the largest |value|), as it does the jitted JAX _wmm and _lm_logits.
- A tile stored untransposed, a cut tile's partial left out or added out
  of CTA order, and a warpgroup given the next 64 channels, each planted
  in the model, are caught.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY
from deepspeed_tpu.inference import model as JM
from deepspeed_tpu.inference import quantization as JQ
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.inference import quantization as PQ
from deepspeed_tpu_torch.ops.cuda import int8_matmul as PI

H100_SMS = 132
BF16_RTOL, BF16_ATOL = 8e-3, 1e-3  # one bf16 ulp, and near zero (x the largest |value|)
SUM_RTOL = 1e-5  # f32 rounding of the sum order, of sum |x| |q|
# (M, N, K): tails in all three (N past a 128-channel tile, K past a
# 128-deep unit and a 64-deep half, M past a token tile), decode and
# prefill widths
SHAPES = [(1, 300, 208), (5, 256, 512), (8, 300, 1040), (33, 133, 208), (64, 256, 400),
          (130, 300, 208)]
# grids: one CTA, a few (tiles cut), one a tile, the plan's
GRIDS = [1, 3, 7, "tiles", "plan"]


def _plan(M, N, K, grid, tn=None):
    if grid == "plan":
        return PI.matmul_split_plan(M, N, K, H100_SMS)
    base = PI.matmul_split_plan_for(M, N, K, 1, tn)
    return PI.matmul_split_plan_for(M, N, K, base.tiles if grid == "tiles" else grid, tn)


def _inputs(M, N, K, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (N, K)).astype(np.int8)
    q[1, :2] = (127, -127)
    q[N // 2] = 0
    s = rng.uniform(2e-4, 2.2e-3, N).astype(np.float32)
    s[N // 2] = 1.0
    x = rng.normal(size=(M, K)).astype(np.float32)
    return (torch.from_numpy(x).bfloat16(), torch.from_numpy(q), torch.from_numpy(s))


def _tile_sums(x, q, plan, fault=None):
    """{tile: f32 sums [CH channels, tn tokens]} as the kernel forms them
    (fault: "partial_left_out", "partials_reversed" or "next_channels")."""
    M, K = x.shape
    N = q.shape[0]
    tn, CH, UK = plan.tn, PI.CH, PI.UK
    tok_tiles = -(-M // tn)
    Kp = plan.chunks * UK
    # TMA's zero fill past M, N and K
    xp = torch.zeros((tok_tiles * tn, Kp), dtype=torch.float64)
    xp[:M, :K] = x.double()
    qp = torch.zeros((-(-N // CH) * CH, Kp), dtype=torch.float64)
    qp[:N, :K] = q.double()  # the codes' bf16 is exact
    if fault == "next_channels":  # warpgroup 0 of each tile reads warpgroup 1's codes
        qp = qp.view(-1, 2, 64, Kp).clone()
        qp[:, 0] = qp[:, 1]
        qp = qp.view(-1, Kp)
    whole, parts = {}, {}
    for g, t, u0, u1, slot in PI.segments(plan):
        ct, tt = divmod(t, tok_tiles)
        a = qp[ct * CH:(ct + 1) * CH]  # wgmma's M: the tile's channels
        b = xp[tt * tn:(tt + 1) * tn]  # wgmma's N: its tokens
        acc = torch.zeros((CH, tn), dtype=torch.float32)
        for u in range(u0, u1):  # the units in order, each added in f32
            k = slice((u - t * plan.chunks) * UK, (u - t * plan.chunks + 1) * UK)
            acc = acc + (a[:, k] @ b[:, k].t()).float()
        if slot is None:
            whole[t] = acc
        else:
            parts.setdefault(t, []).append((g, acc))
    for t, segs in parts.items():  # the combine: CTA order, by the CTA that ends the tile
        segs = sorted(segs, key=lambda ga: ga[0])
        if fault == "partial_left_out":
            segs = segs[1:]
        if fault == "partials_reversed":
            segs = segs[::-1]
        v = torch.zeros_like(segs[0][1])
        for _, acc in segs:
            v = v + acc
        whole[t] = v
    return whole


def _kernel_model(x, q, s, out_f32, plan, fault=None):
    """Y [M, N] as the kernel computes it, and the f32 sums before the
    epilogue; fault "untransposed" stores each tile [channel][token]."""
    M, N = x.shape[0], q.shape[0]
    tn, CH = plan.tn, PI.CH
    tok_tiles = -(-M // tn)
    sums = torch.full((tok_tiles * tn, -(-N // CH) * CH), float("nan"))
    for t, acc in _tile_sums(x, q, plan, fault).items():
        ct, tt = divmod(t, tok_tiles)
        tile = acc.t()  # the transposed store: Y[token, channel]
        if fault == "untransposed":
            tile = acc.reshape(tn, CH)
        sums[tt * tn:(tt + 1) * tn, ct * CH:(ct + 1) * CH] = tile
    sums = sums[:M, :N]
    if out_f32:
        y = sums.bfloat16().float() * s
    else:
        y = (sums.bfloat16().float() * s.bfloat16().float()).bfloat16()
    return y, sums


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS + [H100_SMS])
@pytest.mark.parametrize("M,N,K", SHAPES + [(8, 12288, 4096), (64, 4096, 11008),
                                            (768, 4544, 18176)])
def test_segments_cover_each_unit_once_in_k_order(M, N, K, grid):
    plan = _plan(M, N, K, grid)
    segs = PI.segments(plan)
    covered = [u for _, _, u0, u1, _ in segs for u in range(u0, u1)]
    assert covered == list(range(plan.units))  # every unit once, CTA-major
    for g in range(plan.ctas):  # each CTA: the kernel's range, not empty
        mine = [(u0, u1) for c, _, u0, u1, _ in segs if c == g]
        assert mine[0][0] == PI.unit_start(g, plan.units, plan.ctas) < mine[-1][1]
        assert mine[-1][1] == PI.unit_start(g + 1, plan.units, plan.ctas)
    for t in range(plan.tiles):
        mine = [(g, u0, u1) for g, tt, u0, u1, _ in segs if tt == t]
        assert [g for g, _, _ in mine] == sorted({g for g, _, _ in mine})
        assert mine[0][1] == t * plan.chunks and mine[-1][2] == (t + 1) * plan.chunks
        assert all(a[2] == b[1] for a, b in zip(mine, mine[1:]))  # contiguous in k


@pytest.mark.parametrize("grid", [3, 7, 13, H100_SMS])
@pytest.mark.parametrize("M,N,K", [(8, 1024, 4096), (64, 300, 2816), (5, 133, 4560)])
def test_cut_tiles_slots_and_the_ending_cta(M, N, K, grid):
    plan = _plan(M, N, K, grid)
    segs = PI.segments(plan)
    assert plan.splits == any(slot is not None for *_, slot in segs)
    if plan.splits:
        assert plan.scratch_shape == (2 * plan.ctas, plan.tn, PI.CH)
    for g in range(plan.ctas):
        mine = [seg for seg in segs if seg[0] == g]
        slots = [seg[4] for seg in mine if seg[4] is not None]
        assert len(slots) == len(set(slots)) <= 2 and set(slots) <= {2 * g, 2 * g + 1}
        # a partial middle segment only where the range lies inside one tile
        assert all(seg[4] is None for seg in mine[1:-1])
        if mine[0][4] is not None:
            assert mine[0][4] == 2 * g
    for t in range(plan.tiles):
        mine = [seg for seg in segs if seg[1] == t]
        if len(mine) == 1:
            assert mine[0][4] is None
            continue
        ga = PI.cta_of(t * plan.chunks, plan.units, plan.ctas)
        gb = PI.cta_of((t + 1) * plan.chunks - 1, plan.units, plan.ctas)
        assert [seg[0] for seg in mine] == list(range(ga, gb + 1))
        # the ending CTA's own segment is its first: slot 2 gb
        assert mine[-1][4] == 2 * gb and mine[-1][2] == PI.unit_start(gb, plan.units, plan.ctas)
        # slot of CTA ga: 2 ga + 1 iff ga began in an earlier tile (the kernel's ga_mid)
        ga_mid = PI.unit_start(ga, plan.units, plan.ctas) < t * plan.chunks
        assert mine[0][4] == 2 * ga + ga_mid
        assert gb - ga == len(mine) - 1  # the arrivals the ending CTA waits for


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("M,N,K", SHAPES)
def test_model_matches_the_plain_version(M, N, K, grid, out_f32):
    x, q, s = _inputs(M, N, K)
    plan = _plan(M, N, K, grid)
    y, sums = _kernel_model(x, q, s, out_f32, plan)
    exact = x.double() @ q.double().t()
    scale = x.double().abs() @ q.double().abs().t()
    assert torch.isfinite(sums).all()
    assert ((sums.double() - exact).abs() <= SUM_RTOL * scale + 1e-30).all()
    plain = PI.int8_matmul_plain(x, q, s, out_f32)
    assert y.dtype == plain.dtype and y.shape == plain.shape == (M, N)
    _close(y.float(), plain.float())
    assert (y == plain).float().mean() >= 0.99  # the roundings are the same roundings
    assert (y[:, N // 2] == 0).all()  # the zero channel


@pytest.mark.parametrize("M,N,K", SHAPES)
def test_model_token_width_does_not_change_the_function(M, N, K):
    """Any token width (a wider tile than M needs, TMA's zero rows) and
    any grid give the same sums up to f32 rounding of the order."""
    x, q, s = _inputs(M, N, K, seed=1)
    ref = _kernel_model(x, q, s, False, _plan(M, N, K, "plan"))[1]
    for tn in PI.TOKEN_WIDTHS:
        if tn >= min(M, 128):
            for grid in (1, 5):
                got = _kernel_model(x, q, s, False, _plan(M, N, K, grid, tn))[1]
                torch.testing.assert_close(got, ref, rtol=SUM_RTOL, atol=1e-4)


@pytest.mark.parametrize("M,N,K", [(5, 300, 208), (33, 256, 400), (130, 300, 1040)])
def test_model_matches_jax_wmm_and_lm_logits(M, N, K):
    """The JAX package's _wmm (te,ef->tf: codes [K, N] there) and the tied
    _lm_logits (the [V, E] codes) on the same codes, jitted on the CPU."""
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.5, (K, N)).astype(np.float32)
    jw = jax.jit(lambda a: JQ.channel_quantize(a, 1))(jnp.asarray(w, jnp.bfloat16))
    pw = PQ.ChannelQuantWeight.from_codes(torch.from_numpy(np.array(jw.q)),
                                          torch.from_numpy(np.array(jw.scale)), 1,
                                          dtype_name="bfloat16")
    x = rng.normal(size=(M, K)).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    y, _ = _kernel_model(xt, pw.q, pw.scale, False, _plan(M, N, K, 3))
    want = jax.jit(lambda a: JM._wmm("te,ef->tf", a, jw))(jnp.asarray(x, jnp.bfloat16))
    _close(y.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the tied logits: embed [V, E] quantized per row, the f32 form
    V, E = N, K
    emb = jax.jit(lambda a: JQ.channel_quantize(a, 1, True))(
        jnp.asarray(rng.normal(0, 0.5, (V, E)).astype(np.float32), jnp.bfloat16))
    pemb = PQ.ChannelQuantWeight.from_codes(torch.from_numpy(np.array(emb.q)),
                                            torch.from_numpy(np.array(emb.scale)),
                                            scale_first=True, dtype_name="bfloat16")
    jc = JT.TransformerConfig(**dict(TINY, d_model=E, vocab_size=V, tie_embeddings=True,
                                     n_heads=1))
    logits, _ = _kernel_model(xt, pemb.q, pemb.scale, True, _plan(M, V, E, 7))
    want = jax.jit(lambda a: JM._lm_logits(a, {"embed": emb}, jc))(jnp.asarray(x, jnp.bfloat16))
    assert logits.dtype == torch.float32
    _close(logits.numpy(), np.asarray(want))


@pytest.mark.parametrize("fault", ["untransposed", "partial_left_out", "partials_reversed",
                                   "next_channels"])
def test_planted_faults_in_the_model_are_caught(fault):
    """A fault that changes the function is caught by the plain version's
    tolerance; the reversed combine changes only the f32 order, so it is
    caught by bits: the kernel adds in CTA order, for the same bits every
    launch."""
    M, N, K = 8, 256, 1040
    x, q, s = _inputs(M, N, K, seed=2)
    plan = _plan(M, N, K, 7)
    assert plan.splits
    good = _kernel_model(x, q, s, False, plan)[1]
    bad = _kernel_model(x, q, s, False, plan, fault)[1]
    if fault == "partials_reversed":
        sums = [_tile_sums(x, q, plan, f) for f in (None, fault)]
        assert any(not torch.equal(sums[0][t], sums[1][t]) for t in sums[0])
        return
    plain = PI.int8_matmul_plain(x, q, s).float()
    y = (bad.bfloat16().float() * s.bfloat16().float()).bfloat16().float()
    with pytest.raises(AssertionError):
        _close(y, plain)
    assert not torch.allclose(good, bad)
