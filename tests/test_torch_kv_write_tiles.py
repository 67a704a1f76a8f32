"""The tiled design of the int8 KV write (#6, csrc/paged_kv_write.cu) on the
CPU, where its layout and its arithmetic can be held in Python.

- The tiles: the [T, KV, D] rows are 2 T KV head slices in a flat order
  (a row's K heads, then its V heads), KV8_TILE of them a CTA, one slice
  a group of 16 lanes, its chunks of KV8_CHUNK[D] bf16 (a vector load: 8
  bytes at D 64, 16 at D 80, 96, 128 and 256) spread over the lanes
  (chunks l and l + 16 of lane l at D 256): the tiles cover every slice
  once, the last one partial where the slices do not fill it; a slice's
  chunks fill its 16 lanes (twice at D 256) but at D 80 (10 of them) and
  96 (12). `_divisor_magic`,
  the kernel's division of a slice index by 2 KV and of a slot by the
  block size, against Python's // over ranges of n up to 2^31 - 1.
- `_kernel_model`, the kernel's walk: tiles of slices, groups of 16 lanes
  of chunks, the amax as the max of the bits of |x| taken per lane and
  then by the shuffle tree across the group, the scale, the quotient, the
  conversion that rounds half to even and takes NaN to 0, a lane's codes
  stored as one word or two and the group's scale by its lane 0. It is
  held bit for bit against the plain write (paged_kv_write_quant_plain)
  and against the JAX package's _write_kv_quant (the interpret-mode
  Pallas paged_kv_write on the codes and paged_scale_write on the
  scales; KV 1, 2, 8 and 32 side by side in one call a head dim), codes
  and scales, at D 64, 80, 96, 128 and 256 and KV 1, 2, 8 and 32 with T not a
  multiple of a tile's rows, rows built as .5 ties, zeros,
  subnormals, a NaN, +inf, -inf and a NaN beside an inf, dropped (-1) and
  past-arena slots; and at two head counts whose row spans several tiles
  (against the plain write). The JAX CPU run flushes a subnormal scale to
  0 (and so to 1): those rows are held against JAX only where it keeps
  them, as tests/test_torch_paged_quant.py does. The quotient is the IEEE
  one here (f32 division on the CPU); that the kernel's short route gives
  the same codes is checked on the card over every (x, amax) pair
  (tests/test_torch_cuda.py, chip_smoke.py).
- The planted faults of chip_smoke.py's kv_write_design_checks (its
  `_emulated_write`: a stale tile, each scale written to the next head,
  the last tile left unwritten, at D 80 the amax of the first 64 columns,
  ties rounded away from zero, the NaN-dropping absmax) each change the
  pools the bit-exact check compares; without one the emulation is the
  model bit for bit.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import model as JM
from deepspeed_tpu_torch.ops.cuda import paged_attention as PP

LANES = 16  # a head slice's lane group in the kernel
# (T, KV) of chip_smoke.py's KV_WRITE_CASES and others
TILE_SHAPES = [(1024, 8), (2048, 32), (8192, 8), (2048, 1), (1, 1), (45, 2), (45, 130),
               (3968, 32), (2045, 1), (7, 68)]
T_ROWS, NBLK, BS = 45, 6, 16
PAST = (NBLK - 1) * BS + 3  # where slot NBLK * BS + 3 lands


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test here is a few ms of small tensor ops alone: one torch
    thread keeps a worker that shares the CPU with others from
    oversubscribing it (the setting is restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lane_chunks(D):
    """Chunks a lane takes: a slice's D / KV8_CHUNK[D] chunks over 16 lanes."""
    return -(-(D // PP.KV8_CHUNK[D]) // LANES)


def _tiles(T, KV):
    """[(first slice, slices)] of each CTA's tile."""
    n = 2 * T * KV
    return [(b, min(PP.KV8_TILE, n - b)) for b in range(0, n, PP.KV8_TILE)]


# ---------------------------------------------------------------------------
# the tiles and the divisions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_tiles_cover_every_slice_once(shape):
    T, KV = shape
    tiles = _tiles(T, KV)
    covered = np.concatenate([np.arange(b, b + n) for b, n in tiles])
    np.testing.assert_array_equal(covered, np.arange(2 * T * KV))
    assert all(n == PP.KV8_TILE for _, n in tiles[:-1]) and 0 < tiles[-1][1] <= PP.KV8_TILE
    # a 256-thread CTA: one slice a group of 16 lanes
    assert PP.KV8_TILE * LANES == 256


@pytest.mark.parametrize("D", sorted(PP.KV8_CHUNK))
def test_chunks_fill_the_lane_group(D):
    chunk, per_lane = PP.KV8_CHUNK[D], _lane_chunks(D)
    assert chunk * 2 in (8, 16)  # a chunk's load is one 8- or 16-byte vector
    assert D % chunk == 0 and LANES * (per_lane - 1) < D // chunk <= LANES * per_lane
    # D 80: 10 of the 16 lanes, D 96: 12; D 256: every lane twice
    assert D // chunk == LANES * per_lane or D in (80, 96)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 16, 64, 128, 130, 260, 1000, 2**20 + 1])
def test_divisor_magic(d):
    magic, shift = PP._divisor_magic(d)
    assert 0 < magic < 2**32
    r = np.random.default_rng(d)
    n = np.concatenate([np.arange(5000), r.integers(0, 2**31, 20000), [2**31 - 1, 2**31 - 2],
                        np.arange(1, 50) * d - 1, np.arange(1, 50) * d]).astype(np.uint64)
    got = ((n * np.uint64(magic)) >> np.uint64(32)) + n >> np.uint64(shift)
    np.testing.assert_array_equal(got, n // np.uint64(d))


# ---------------------------------------------------------------------------
# the kernel's arithmetic, step by step
# ---------------------------------------------------------------------------

def _bits(x):
    return x.float().view(torch.int32)


def _kernel_model(pools, k_new, v_new, slots):
    """What the int8 kernel writes, in its own order (see the module
    docstring), on copies of `pools` (codes, codes, scales, scales): every
    tile's slices at once, each with its lanes, each lane with its chunk."""
    cache_k, cache_v, k_scale, v_scale = (p.clone() for p in pools)
    T, KV, D = k_new.shape
    nblk, bs = cache_k.shape[:2]
    chunk, per_lane = PP.KV8_CHUNK[D], _lane_chunks(D)
    chunks, per_row = D // chunk, 2 * KV
    src = torch.stack([k_new, v_new], 1).reshape(T * per_row, D)  # the flat slice order
    # the slices of each CTA's tile, in tile order: group g takes base + g
    j = torch.cat([torch.arange(base, base + n) for base, n in _tiles(T, KV)])
    row, hh = j // per_row, j % per_row
    is_v, h = hh >= KV, hh % KV
    slot = slots[row].long()
    blk = (slot // bs).clamp(0, nblk - 1)
    dst = torch.where(slot >= 0, (blk * bs + slot % bs) * KV + h, -1)
    # the loads: chunk c in lane c % LANES, zeros for a dropped row and
    # for the chunks past the slice's
    x = torch.zeros(len(j), per_lane * LANES, chunk)
    live = dst >= 0
    x[live, :chunks] = src[j[live]].float().view(-1, chunks, chunk)
    # each lane's values: its chunks l, l + LANES, ...
    amax = (_bits(x) & 0x7FFFFFFF).amax(-1).view(len(j), per_lane, LANES).amax(1)
    lane_ids, o = torch.arange(LANES), LANES // 2
    while o:  # the shuffle tree
        amax = torch.maximum(amax, amax[:, lane_ids ^ o])
        o //= 2
    scale = amax[:, 0].view(torch.float32) * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = (x / scale[:, None, None]).round()
    code = torch.where(torch.isnan(q), torch.zeros_like(q), q).clamp(-127, 127).to(torch.int8)
    # the stores of lanes < chunks, and each group's lane 0's scale
    for v, codes, scales in ((False, cache_k, k_scale), (True, cache_v, v_scale)):
        m = live & (is_v == v)
        codes.view(-1, D)[dst[m]] = code[m, :chunks].reshape(-1, D)
        scales.view(-1)[dst[m]] = scale[m]
    return [cache_k, cache_v, k_scale, v_scale]


def _rows(rng, T, KV, D):
    """bf16 rows [T, KV, D]: unit normal, row 0 .5 ties (absmax 127: scale
    exactly 1), row 1 zeros, row 2 subnormal (absmax 5e-39), rows 3-6 as
    chip_smoke.py's _nonfinite_rows makes them (NaN, +inf, -inf, NaN
    beside +inf), and row T - 1 ties again (in the last, partial tile)."""
    x = rng.standard_normal((T, KV, D)).astype(np.float32)
    for r in (0, T - 1):
        x[r] = rng.integers(-126, 126, (KV, D)) + 0.5
        x[r, :, 0] = 127.0
    x[1] = 0.0
    x[2] = 3e-39
    x[2, :, ::3] = -5e-39
    t = torch.from_numpy(x).to(torch.bfloat16)
    return _chip_smoke()._nonfinite_rows(t, range(3, 7))


def _slots(rng, T=T_ROWS):
    """A permutation of the arena's blocks but the last, every 7th row
    dropped, and row 4 past the arena (its block id clamped to the last
    block, at flat slot PAST)."""
    slots = rng.permutation((NBLK - 1) * BS)[:T].astype(np.int32)
    slots[7::7] = -1
    slots[4] = NBLK * BS + 3
    return torch.from_numpy(slots)


def _case(rng, KV, D, slots):
    """Pools as quantize_kv_rows fills them and new K and V rows."""
    kf = torch.from_numpy(rng.standard_normal((NBLK * BS, KV, D)).astype(np.float32))
    qk, ks, qv, vs = PP.quantize_kv_rows(kf, kf.flip(0))
    pools = [qk.reshape(NBLK, BS, KV, D), qv.reshape(NBLK, BS, KV, D),
             ks.reshape(NBLK, BS, KV), vs.reshape(NBLK, BS, KV)]
    T = slots.shape[0]
    return pools, _rows(rng, T, KV, D), _rows(rng, T, KV, D).flip(0)


def _assert_pools_equal(got, want, skip_slots=()):
    """Codes and scales equal bit for bit, outside the flat slots `skip_slots`."""
    keep = torch.ones(NBLK * BS, dtype=torch.bool)
    keep[list(skip_slots)] = False
    for g, w in zip(got, want):
        g, w = g.reshape(NBLK * BS, -1)[keep], w.reshape(NBLK * BS, -1)[keep]
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), int((g != w).sum())


CASES = [(KV, D) for D in (64, 80, 96, 128, 256) for KV in (1, 2, 8, 32)] + [(130, 64),
                                                                           (68, 128)]


@pytest.mark.parametrize("KV,D", CASES)
def test_model_matches_plain(rng, KV, D):
    slots = _slots(rng)
    pools, kn, vn = _case(rng, KV, D, slots)
    got = _kernel_model(pools, kn, vn, slots)
    plain = [p.clone() for p in pools]
    PP.paged_kv_write_quant_plain(*plain, kn, vn, slots)
    _assert_pools_equal(got, plain)
    # a NaN makes its slice's scale 1 and its own code 0; an inf (row 4, at
    # PAST) the scale inf and every code 0
    k_codes, k_scales = got[0].view(-1, KV, D), got[2].view(-1, KV)
    nan_slot = int(slots[3])
    assert (k_scales[nan_slot] == 1).all() and not k_codes[nan_slot, 1:, 5].any()
    assert k_codes[nan_slot, 0, :8].tolist() == [0, -3, 0, 1, 2, -1, 0, 7]
    assert torch.isinf(k_scales[PAST]).all() and not k_codes[PAST].any()
    # the subnormal row kept its scale
    sub = k_scales[int(slots[2])]
    assert ((sub > 0) & (sub < torch.finfo(torch.float32).tiny)).all()


@pytest.mark.parametrize("D", [64, 80, 96, 128, 256])
def test_model_matches_jax(rng, D):
    """KV 1, 2, 8 and 32 at one head dim, against one run of the JAX
    package's write on their heads side by side (a slice's codes and scale
    depend on its own values alone, so 43 heads in one call are the four
    writes at once, with one compile of the interpret-mode kernels, under
    jit as the JAX engine runs it)."""
    slots = _slots(rng)
    cases = [_case(rng, KV, D, slots) for KV in (1, 2, 8, 32)]
    pools = [torch.cat([c[0][k] for c in cases], 2) for k in range(4)]
    kn, vn = (torch.cat([c[i] for c in cases], 1) for i in (1, 2))
    want = jax.jit(JM._write_kv_quant)(*(jnp.asarray(a.float().numpy()
                                                    if a.dtype == torch.bfloat16 else a.numpy())
                                         for a in (*pools, kn, vn, slots)))
    want = [torch.from_numpy(np.array(w)) for w in want]
    flushed = float(want[2].reshape(NBLK * BS, -1)[int(slots[2]), 0]) == 1.0
    h0 = 0
    for c_pools, c_kn, c_vn in cases:
        KV = c_kn.shape[1]
        got = _kernel_model(c_pools, c_kn, c_vn, slots)
        _assert_pools_equal(got, [w[:, :, h0:h0 + KV] for w in want],
                            skip_slots=[int(slots[2])] if flushed else ())
        h0 += KV


FAULTS = [None, "stale_tile", "scale_to_the_next_head", "last_tile_left_unwritten",
          "ties_away_from_zero", "nan_dropping_absmax", "amax_first_64_columns"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_change_the_pools(rng, fault):
    """Each of chip_smoke.py's planted faults moves some code or scale away
    from the kernel's (the model's); without one its emulation is the
    model bit for bit."""
    C = _chip_smoke()
    KV, D = 3, 80
    slots = _slots(rng)
    pools, kn, vn = _case(rng, KV, D, slots)
    tiles = _tiles(T_ROWS, KV)
    assert tiles[-1][1] < PP.KV8_TILE  # the last tile is partial
    got = _kernel_model(pools, kn, vn, slots)
    if fault == "stale_tile":
        emulated = C._emulated_write(PP, pools, *C._stale_tile_rows(kn, vn, PP.KV8_TILE), slots)
    elif fault == "scale_to_the_next_head":
        emulated = C._emulated_write(PP, pools, kn, vn, slots, scale_shift=True)
    elif fault == "last_tile_left_unwritten":
        emulated = C._emulated_write(PP, pools, kn, vn, slots, skip_from=tiles[-1][0])
    else:
        emulated = C._emulated_write(PP, pools, kn, vn, slots, fault)
    assert (C._pools_off(got, emulated) > 0) == (fault is not None)
