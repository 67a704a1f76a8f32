"""Paged-KV kernels of the serving path: the cache write and decode
attention, each a hand-written CUDA kernel beside its plain PyTorch
version.

Counterpart of deepspeed_tpu/ops/pallas/paged_attention.py. Cache layout
is the reference's: per layer, K and V arenas of [num_blocks, block_size,
KV_heads, head_dim]; "block i of sequence s" lives at cache[table[s, i]]
and token position p of that sequence at flat slot
table[s, p // bs] * bs + p % bs.

Wrappers: for tensors on the CPU they run the plain version; for CUDA
tensors they launch the kernel (csrc/paged_kv_write.cu,
csrc/paged_decode.cu) or raise. Each keeps `launches`, the number of
kernel launches it made (the decode wrappers also `window_launches`, those
in the sliding-window mode, `alibi_launches`, those in the ALiBi mode,
`sparse_launches`, those with a layout bitmap, and `wide_group_launches`,
those with more than 8 query heads per KV head; the decode wrappers and
both writes `d80_launches`, `d96_launches` and `d256_launches`, those at
head_dim 80, 96 and 256; every wrapper `f32_launches`, those on f32 q or
rows). Kernels take bf16 or f32 (an f32 serving engine: q, new rows and
non-int8 pools all f32, its own sources csrc/paged_decode_f32.cu and
csrc/paged_kv_write_f32.cu, the f32 write into f32 pages the bf16
write's byte mover; a mixed dtype raises), head dims 64, 80, 96, 128 and
256 (Phi-2: 80, GPT-NeoX-20B: 96, GPT-J-6B: 256) and any whole query group
(Falcon-7B: 71 query heads over one KV head); the plain versions take any
float dtype and compute attention in f32.

Sliding window (`window` > 0, every decode mode): row s attends to the
positions ctx - window <= p < ctx of its context (ctx counts the new
token); window = 0, or any window >= ctx, is the full context.

ALiBi (`alibi_slopes`: [H] f32, every decode mode, Bloom-class): the score
of q head h at context position p gains slope_h * p, the ABSOLUTE key
position, as in the TPU kernel and paged_decode_attention_xla. For the one
query of a row (at position ctx - 1) that is slope_h * (p - (ctx - 1)) up
to a constant softmax cancels, but the two forms round differently (the
bias reaches ~1,700 at ctx ~ 2,000), so kernel and plain versions keep the
reference's form.

Block-sparse layouts (`allowed_slots`: [S, NB] int32, every decode mode):
row s attends to the positions of table slot j only when
allowed_slots[s, j] != 0 (the layout row of the row's query position at
cache-block granularity, exact when the layout block is a multiple of the
cache block); the fused modes attend their new token at ctx - 1 whatever
the bitmap says, as the TPU kernels do. A row with no allowed live
position outputs zeros. The plain version of the attention also takes
`allowed` [S, NB * bs], a per-position mask: the JAX package's
paged_decode_attention_xla route for layouts finer than the cache block.

int8 KV (the JAX package's kv_cache_dtype="int8"): the arenas hold int8
codes and each carries a [NBLK, bs, KV] f32 scale pool, one scale per
(token slot, KV head), so a block's scales live at k_scale[block].
quantize_kv_rows is the one rounding rule; the kernels' quantizer
(csrc/kv_quant.cuh) repeats it bit for bit. A code dequantizes as
code * scale in f32, rounded to q's dtype before it meets q or P (no
rounding for f32 q).

The caches are updated IN PLACE (the JAX package donates the arenas and
gets them back aliased): the write and the fused decode return the same
tensors they were given.

Split-K (`decode_split_plan`): the decode kernel runs one CTA per (row, KV
head, split of the context), each holding the KV head's whole query group,
where S x KV alone would leave the card idle; the splits' f32 partials are
added in split order (no float atomics: the same bits every run) by the
last CTA of each (row, KV head) to arrive, in the same launch.
"""

import functools
import math
from typing import NamedTuple, Tuple

import torch

from . import build
from ._common import check_cuda_args, check_shape, count_launch, ptr, stream_of, zero_counts

_BF16 = torch.bfloat16
_I32 = torch.int32
_I8 = torch.int8
_F32 = torch.float32
_DECODE_HEAD_DIMS = (64, 80, 96, 128, 256)
# the counters of every decode wrapper
_DECODE_MODES = ("window", "alibi", "sparse", "wide_group", "d80", "d96", "d256", "f32")
# the element types of q, the new KV rows and non-int8 pools: bf16 (the
# bf16 sources) or f32 (the `_f32` sources)
_SERVE_DTYPES = (_BF16, _F32)
# query heads a CTA of the f32 decode kernel (csrc/paged_decode_f32.cu GCH)
F32_GROUP_CTA = 64


def serve_dtype(what, t):
    """The element type the serving kernels run `t` (q or the new KV rows)
    in: bf16 or f32; anything else raises TypeError. Pure: reads the dtype
    only."""
    if t.dtype not in _SERVE_DTYPES:
        raise TypeError(f"{what}: {t.dtype}; the kernels take bf16 or f32")
    return t.dtype


def library_name(source, dtype):
    """The library of kernel source `source` for element type `dtype`."""
    return source + "_f32" if dtype == _F32 else source


# int8 KV quantization: scale = amax * (1/127) as a MULTIPLY by the f32
# of the double 1/127 (how the JAX package spells it, so that no compiler
# turns it into a division that rounds differently), code =
# clamp(round_half_even(x / scale), -127, 127) with a true division
KV_QUANT_MAX = 127.0
_KV_QUANT_INV = 1.0 / 127.0


# ---------------------------------------------------------------------------
# int8 KV quantization
# ---------------------------------------------------------------------------

def _quantize(x):
    xf = x.float()
    scale = xf.abs().amax(dim=-1) * torch.tensor(_KV_QUANT_INV, dtype=_F32)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    code = torch.round(xf / scale[..., None]).clamp(-KV_QUANT_MAX, KV_QUANT_MAX)
    return code.to(_I8), scale


def quantize_kv_rows(k, v):
    """Quantize new KV rows [T, KV, D] -> (k codes int8 [T, KV, D], k
    scales f32 [T, KV], v codes, v scales): one scale per (row, head), the
    head's absmax / 127. Counterpart of the JAX package's quantize_kv_rows;
    the kernels' in-kernel quantizer (csrc/kv_quant.cuh) matches it bit
    for bit, so a token's codes do not depend on which path wrote it."""
    qk, ks = _quantize(k)
    qv, vs = _quantize(v)
    return qk, ks, qv, vs


def dequantize(codes, scale, dtype):
    """codes [..., D] int8 and scales [...] f32 -> code * scale in f32,
    rounded to `dtype` (q's dtype), as the TPU kernel's fused dequant."""
    return (codes.float() * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# paged KV write
# ---------------------------------------------------------------------------

def _scatter_rows(arena, rows, flat_slots):
    """arena [NBLK, bs, ...] <- rows [T, ...] at flat slots [T], in place;
    slots < 0 dropped, block ids clamped to the arena."""
    NBLK, bs = arena.shape[:2]
    keep = flat_slots >= 0
    slot = flat_slots[keep].long()
    idx = (slot // bs).clamp(max=NBLK - 1) * bs + slot % bs
    arena.view(NBLK * bs, *arena.shape[2:])[idx] = rows[keep].to(arena.dtype)


def paged_kv_write_plain(cache_k, cache_v, k_new, v_new, flat_slots):
    """Scatter [T, KV, D] rows into [NBLK, bs, KV, D] caches at flat slots
    [T], in place. Slots < 0 are dropped; a slot past the arena has its
    block id clamped to the last block, as the kernel and the TPU kernel
    (_arena_block) do. The JAX package's _write_kv_xla drops such a slot
    instead; the two agree on every slot inside the arena."""
    _scatter_rows(cache_k, k_new, flat_slots)
    _scatter_rows(cache_v, v_new, flat_slots)
    return cache_k, cache_v


def paged_kv_write_quant_plain(cache_k, cache_v, k_scale, v_scale, k_new, v_new,
                               flat_slots):
    """Quantize [T, KV, D] rows (quantize_kv_rows) and scatter the int8
    codes into the code pools [NBLK, bs, KV, D] and the f32 scales into
    the scale pools [NBLK, bs, KV] at flat slots [T], in place, with the
    drop and clamp rules of paged_kv_write_plain. The JAX package's
    single-device _write_kv_quant (paged_kv_write on the codes,
    paged_scale_write on the scales). Returns the four pools."""
    qk, ks, qv, vs = quantize_kv_rows(k_new, v_new)
    for arena, rows in ((cache_k, qk), (cache_v, qv), (k_scale, ks), (v_scale, vs)):
        _scatter_rows(arena, rows, flat_slots)
    return cache_k, cache_v, k_scale, v_scale


def paged_kv_write(cache_k, cache_v, k_new, v_new, flat_slots):
    """Write new KV rows into the paged arenas in place (kernel:
    csrc/paged_kv_write.cu, which moves a row's bytes: bf16 or f32).
    cache_k/cache_v [NBLK, bs, KV, D] and k_new/v_new [T, KV, D], all bf16
    or all f32, flat_slots [T] int32 (-1 = dropped row). A slot past the
    arena lands in the last block, as in the plain version. Returns
    (cache_k, cache_v)."""
    if not cache_k.is_cuda:
        return paged_kv_write_plain(cache_k, cache_v, k_new, v_new, flat_slots)
    what = "paged_kv_write"
    NBLK, bs, KV, D = cache_k.shape
    T = flat_slots.shape[0]
    dt = serve_dtype(what, k_new)
    tensors = {"cache_k": cache_k, "cache_v": cache_v, "k_new": k_new, "v_new": v_new,
               "flat_slots": flat_slots}
    dtypes = {"cache_k": dt, "cache_v": dt, "k_new": dt, "v_new": dt, "flat_slots": _I32}
    check_cuda_args(what, tensors, dtypes, aligned=("cache_k", "cache_v", "k_new", "v_new"))
    check_shape(what, "cache_v", cache_v, cache_k.shape)
    check_shape(what, "k_new", k_new, (T, KV, D))
    check_shape(what, "v_new", v_new, (T, KV, D))
    row_bytes = KV * D * dt.itemsize
    if row_bytes % 16:
        raise ValueError(f"{what}: a [KV, D] row of {row_bytes} bytes is not a multiple of 16")
    if T == 0:
        return cache_k, cache_v
    lib = build.load("paged_kv_write")
    err = lib.paged_kv_write(ptr(cache_k), ptr(cache_v), ptr(k_new), ptr(v_new),
                             ptr(flat_slots), T, NBLK, bs, row_bytes, stream_of(cache_k))
    build.check(lib, err, what)
    count_launch(paged_kv_write, head_dim=D, dtype=dt)
    return cache_k, cache_v


zero_counts(paged_kv_write, "d80", "d96", "d256", "f32")


def _check_scales(what, cache_k, k_scale, v_scale):
    check_shape(what, "k_scale", k_scale, cache_k.shape[:3])
    check_shape(what, "v_scale", v_scale, cache_k.shape[:3])


# The int8 write's tiles (csrc/paged_kv_write.cu): the [T, KV, D] rows are
# 2 * T * KV head slices in a flat order (a row's K heads, then its V
# heads), KV8_TILE of them a CTA of 256 threads, one slice a group of 16
# lanes, the slice's chunks of KV8_CHUNK[D] bf16 (8 bytes at D 64, 16 at D
# 80, 96, 128 and 256) spread over its lanes: lane l takes chunks l, l +
# 16, ... (two at D 256)
KV8_TILE = 16
KV8_CHUNK = {64: 4, 80: 8, 96: 8, 128: 8, 256: 8}


@functools.lru_cache(maxsize=None)
def _divisor_magic(d):
    """(magic, shift) with n // d == (umulhi(n, magic) + n) >> shift for
    every 0 <= n < 2^31 (the int8 write divides by 2 * KV and the block
    size so; umulhi(n, magic) <= n keeps the sum under 2^32)."""
    shift = (d - 1).bit_length()
    return (2**32 * (2**shift - d)) // d + 1, shift


def quantizer_route_check(device) -> dict:
    """Run kv_quant_check (csrc/paged_kv_write.cu) on the card: every
    (x, amax) pair of bf16 values the int8 quantizer can meet, its code by
    the short division route against the IEEE division's. Returns pairs
    (tried), codes_off (pairs whose codes differ) and first_off ((amax bits,
    x bits) of the least such pair, or None)."""
    out = torch.tensor([0, 0, -1], dtype=torch.int64, device=device)
    lib = build.load("paged_kv_write")
    build.check(lib, lib.kv_quant_check(ptr(out), stream_of(out)), "kv_quant_check")
    n, off, first = out.tolist()
    return {"pairs": n, "codes_off": off,
            "first_off": None if off == 0 else [(first >> 16) & 0x7FFF, first & 0xFFFF]}


def paged_kv_write_int8(cache_k, cache_v, k_scale, v_scale, k_new, v_new, flat_slots):
    """Quantize new KV rows and write codes and scales into the int8 pools
    in place, in one launch (kernel: csrc/paged_kv_write.cu; f32 rows
    csrc/paged_kv_write_f32.cu). cache_k/cache_v [NBLK, bs, KV, D] int8,
    k_scale/v_scale [NBLK, bs, KV] f32, k_new/v_new [T, KV, D] both bf16 or
    both f32, flat_slots [T] int32 (-1 = dropped row; a slot past the arena
    lands in the last block).
    Codes and scales are bit-identical to paged_kv_write_quant_plain's,
    NaN and inf included: a NaN in a (row, head) slice makes its scale 1
    and its own code 0; an inf without a NaN makes the scale inf and every
    code of the slice 0 (x / inf, and inf / inf taken as NaN, round to 0);
    a subnormal amax keeps its subnormal scale. Returns the four pools."""
    if not cache_k.is_cuda:
        return paged_kv_write_quant_plain(cache_k, cache_v, k_scale, v_scale, k_new, v_new,
                                          flat_slots)
    what = "paged_kv_write_int8"
    NBLK, bs, KV, D = cache_k.shape
    T = flat_slots.shape[0]
    dt = serve_dtype(what, k_new)
    tensors = {"cache_k": cache_k, "cache_v": cache_v, "k_scale": k_scale, "v_scale": v_scale,
               "k_new": k_new, "v_new": v_new, "flat_slots": flat_slots}
    dtypes = {"cache_k": _I8, "cache_v": _I8, "k_scale": _F32, "v_scale": _F32,
              "k_new": dt, "v_new": dt, "flat_slots": _I32}
    check_cuda_args(what, tensors, dtypes,
                    aligned=("cache_k", "cache_v", "k_scale", "v_scale", "k_new", "v_new"))
    check_shape(what, "cache_v", cache_v, cache_k.shape)
    _check_scales(what, cache_k, k_scale, v_scale)
    check_shape(what, "k_new", k_new, (T, KV, D))
    check_shape(what, "v_new", v_new, (T, KV, D))
    if D not in _DECODE_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D}; the kernel is built for {_DECODE_HEAD_DIMS}")
    if T == 0:
        return cache_k, cache_v, k_scale, v_scale
    lib = build.load(library_name("paged_kv_write", dt))
    pools = (ptr(cache_k), ptr(cache_v), ptr(k_scale), ptr(v_scale), ptr(k_new), ptr(v_new),
             ptr(flat_slots))
    if dt == _F32:
        err = lib.paged_kv_write_int8_f32(*pools, T, NBLK, bs, KV, D, stream_of(cache_k))
    else:
        err = lib.paged_kv_write_int8(*pools, T, NBLK, bs, KV, D, *_divisor_magic(2 * KV),
                                      *_divisor_magic(bs), stream_of(cache_k))
    build.check(lib, err, what)
    count_launch(paged_kv_write_int8, head_dim=D, dtype=dt)
    return cache_k, cache_v, k_scale, v_scale


zero_counts(paged_kv_write_int8, "d80", "d96", "d256", "f32")


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def paged_decode_attention_plain(q, k_cache, v_cache, block_table, ctx_lens,
                                 k_scale=None, v_scale=None, window: int = 0,
                                 alibi_slopes=None, allowed_slots=None, allowed=None):
    """Attention of one query token per row over its paged context, in f32:
    row s attends to positions < ctx_lens[s] of its table (and, window > 0,
    >= ctx_lens[s] - window); alibi_slopes [H] bias the score of position p
    by slope_h * p; allowed_slots [S, NB] (nonzero = attended) restricts
    each row to the positions of its allowed table slots, allowed [S, NB *
    bs] (bool) to its allowed positions. q [S, H, D];
    caches [NBLK, bs, KV, D]; block_table [S, NB]; ctx_lens [S]. Rows with
    ctx 0, or with no allowed live position, output zeros. Counterpart of
    the JAX package's paged_decode_attention_xla (which gathers the same
    dense context).
    k_scale/v_scale [NBLK, bs, KV] given: the caches hold int8 codes, each
    dequantized to q's dtype (`dequantize`) before the products.
    Returns [S, H, D] in q's dtype."""
    S, H, D = q.shape
    NBLK, bs, KV, _ = k_cache.shape
    G = H // KV
    tbl = block_table.long().clamp(0, NBLK - 1)
    k = k_cache[tbl].reshape(S, -1, KV, D)  # [S, NB*bs, KV, D]
    v = v_cache[tbl].reshape(S, -1, KV, D)
    if k_scale is not None:
        k = dequantize(k, k_scale[tbl].reshape(S, -1, KV), q.dtype)
        v = dequantize(v, v_scale[tbl].reshape(S, -1, KV), q.dtype)
    k, v = k.float(), v.float()
    pos = torch.arange(k.shape[1], device=q.device)[None, :]
    live = pos < ctx_lens[:, None]  # [S, NB*bs]
    if window > 0:
        live &= pos >= ctx_lens[:, None] - window
    if allowed_slots is not None:
        live &= (allowed_slots != 0).repeat_interleave(bs, dim=1)
    if allowed is not None:
        live &= allowed.bool()
    # never let a dead slot (unwritten, stale, possibly NaN) reach a sum
    k = k.masked_fill(~live[:, :, None, None], 0.0)
    v = v.masked_fill(~live[:, :, None, None], 0.0)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    logits = torch.einsum("shd,skhd->shk", q.float(), k) / D ** 0.5
    if alibi_slopes is not None:
        logits = logits + alibi_slopes.float().reshape(H)[None, :, None] * pos.float()
    logits = logits.masked_fill(~live[:, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(live.any(-1)[:, None, None], probs, torch.zeros_like(probs))
    return torch.einsum("shk,skhd->shd", probs, v).to(q.dtype)


def paged_decode_fused_plain(q, k_cache, v_cache, block_table, ctx_lens,
                             k_new, v_new, slots, k_scale=None, v_scale=None,
                             window: int = 0, alibi_slopes=None, allowed_slots=None):
    """Fused-mode reference: write each row's new K/V into its slot, then
    attend over positions < ctx (which include the new token, at position
    ctx - 1, ALiBi-biased there), the last `window` of them when window > 0,
    those of the table slots allowed_slots [S, NB] allows when given (and
    the new token's, whatever the bitmap says).
    Returns (out, k_cache, v_cache), the caches updated in place. With
    k_scale/v_scale (int8 pools) the new rows are quantized on the way in
    (paged_kv_write_quant_plain), so attention sees their round-tripped
    value, as the TPU kernel's does; returns (out, k_cache, v_cache,
    k_scale, v_scale)."""
    allowed = None
    if allowed_slots is not None:
        bs = k_cache.shape[1]
        allowed = (allowed_slots != 0).repeat_interleave(bs, dim=1)
        rows = torch.arange(q.shape[0], device=q.device)
        allowed[rows, (ctx_lens.long() - 1).clamp(0, allowed.shape[1] - 1)] = True
    if k_scale is None:
        paged_kv_write_plain(k_cache, v_cache, k_new, v_new, slots)
        out = paged_decode_attention_plain(q, k_cache, v_cache, block_table, ctx_lens,
                                           window=window, alibi_slopes=alibi_slopes,
                                           allowed=allowed)
        return out, k_cache, v_cache
    paged_kv_write_quant_plain(k_cache, v_cache, k_scale, v_scale, k_new, v_new, slots)
    out = paged_decode_attention_plain(q, k_cache, v_cache, block_table, ctx_lens,
                                       k_scale, v_scale, window, alibi_slopes, allowed=allowed)
    return out, k_cache, v_cache, k_scale, v_scale


def decode_dtypes(what, q, quant: bool, fused: bool) -> dict:
    """The dtype each argument of a decode launch must have: q's (bf16 or
    f32) for q, the new rows and non-int8 pools, int8 pools with f32
    scales. Pure: reads q's dtype only."""
    dt = serve_dtype(what, q)
    pool = _I8 if quant else dt
    dtypes = {"q": dt, "k_cache": pool, "v_cache": pool, "block_table": _I32, "ctx_lens": _I32,
              "k_scale": _F32, "v_scale": _F32, "alibi_slopes": _F32, "allowed_slots": _I32}
    if fused:
        dtypes.update(k_new=dt, v_new=dt, slots=_I32)
    return dtypes


def _check_decode(what, q, k_cache, v_cache, block_table, ctx_lens,
                  k_new=None, v_new=None, slots=None, k_scale=None, v_scale=None,
                  alibi_slopes=None, allowed_slots=None):
    S, H, D = q.shape
    NBLK, bs, KV, Dc = k_cache.shape
    dtypes = decode_dtypes(what, q, k_scale is not None, k_new is not None)
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "block_table": block_table, "ctx_lens": ctx_lens}
    if k_new is not None:
        tensors.update(k_new=k_new, v_new=v_new, slots=slots)
    if k_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
        _check_scales(what, k_cache, k_scale, v_scale)
    if alibi_slopes is not None:
        tensors.update(alibi_slopes=alibi_slopes)
        check_shape(what, "alibi_slopes", alibi_slopes, (H,))
    if allowed_slots is not None:
        tensors.update(allowed_slots=allowed_slots)
        check_shape(what, "allowed_slots", allowed_slots, tuple(block_table.shape))
    check_cuda_args(what, tensors, dtypes, aligned=("k_cache", "v_cache") + (
        ("q", "k_new", "v_new") if q.dtype == _F32 else ()))
    if Dc != D or D not in _DECODE_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} (cache {Dc}); the kernel is "
                         f"built for {_DECODE_HEAD_DIMS}")
    if H % KV:
        raise ValueError(f"{what}: {H} query heads are not a multiple of {KV} KV heads")
    check_shape(what, "v_cache", v_cache, k_cache.shape)
    if block_table.dim() != 2 or block_table.shape[0] != S:
        raise ValueError(f"{what}: block_table has shape {tuple(block_table.shape)}, "
                         f"expected [{S}, NB]")
    check_shape(what, "ctx_lens", ctx_lens, (S,))
    if k_new is not None:
        check_shape(what, "k_new", k_new, (S, KV, D))
        check_shape(what, "v_new", v_new, (S, KV, D))
        check_shape(what, "slots", slots, (S,))


# The split-K plan of the decode kernel (csrc/paged_decode.cu). A CTA takes
# one (row, KV head, split) and holds the KV head's group (up to
# MAX_GROUP_CTA query heads, in 16-row slices; a larger group takes one CTA
# per 128). A split is a run of split_len absolute context positions,
# whole TILE-column tiles. The plan reads shapes only (never ctx_lens,
# which would stall the host on the card, nor the window, the slopes or
# the bitmap), so a split that holds no live position of its row exits at
# once. No split where the unsplit grid already holds SPLIT_WAVES CTAs an
# SM. Else the count aims at TARGET_CTAS CTAs an SM, with at least
# MIN_SPLIT_WORK tile-slices a split (a CTA's fixed cost, its partial's
# write and the combine's read of it, against its tiles' work: a wide
# group's tiles are 5 slices deep at Falcon-7B, a narrow one's 1), and at
# most MAX_SPLITS. Measured on the H100 (port_timing.py splits, PERF.md).
TILE = 64
SLICE = 16
MAX_GROUP_CTA = 128
MAX_SPLITS = 64
SPLIT_WAVES, TARGET_CTAS, MIN_SPLIT_WORK = 2, 8, 8


class DecodeSplit(NamedTuple):
    """`n` splits of `split_len` context positions (a multiple of TILE;
    split c holds positions [c * split_len, (c + 1) * split_len) of the
    span, the last cut at the span, none empty of it), `ctas` in the grid,
    and `scratch_shape`, the f32 partials [S, KV, n * G * (D + 2)] (O, m
    and l of each split and query head; () when nothing is split)."""
    n: int
    split_len: int
    ctas: int
    scratch_shape: Tuple[int, ...]

    @property
    def scratch_bytes(self) -> int:
        return 4 * math.prod(self.scratch_shape) if self.scratch_shape else 0


def decode_split_plan_for(S, KV, G, D, span, n) -> DecodeSplit:
    """The plan of about `n` splits over a span of `span` positions: whole
    tiles each, ceil(tiles / n) of them, so that none is empty."""
    tiles = max(1, -(-span // TILE))
    n = max(1, min(n, tiles, MAX_SPLITS))
    size = -(-tiles // n)
    n = -(-tiles // size)
    ctas = S * KV * -(-G // MAX_GROUP_CTA) * n
    return DecodeSplit(n, size * TILE, ctas, (S, KV, n * G * (D + 2)) if n > 1 else ())


@functools.lru_cache(maxsize=None)
def decode_split_plan(S, KV, G, D, span, sm_count) -> DecodeSplit:
    """The split the decode kernel takes for S rows over KV heads of G query
    heads at head_dim D, with tables of `span` = NB * block_size positions,
    on a card of `sm_count` SMs (see the constants above; cached: a decode
    step asks once a layer)."""
    units = S * KV * -(-G // MAX_GROUP_CTA)
    n = 1
    if units < SPLIT_WAVES * sm_count:
        tiles = max(1, -(-span // TILE))
        slices = -(-min(G, MAX_GROUP_CTA) // SLICE)
        n = max(1, min(-(-TARGET_CTAS * sm_count // units),
                       tiles // -(-MIN_SPLIT_WORK // slices)))
    return decode_split_plan_for(S, KV, G, D, span, n)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# (device index, stream) -> the split kernel's f32 partials and int32
# arrival counters, allocated by the first launch that needs them (grown by
# a larger one) and reused after: launches on one stream run in order, and
# each has added its partials and reset its counters to 0 before the next
# starts. A decode step thus allocates nothing beside its output.
_WORKSPACE = {}
# workspaces a larger one replaced: a CUDA graph captured before the growth
# still launches on their pointers, so they are never freed
_RETIRED = []


def _capturing(device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _workspace(device, stream, n_part, n_counters):
    """The workspace of `stream`. Under a CUDA graph capture it must exist
    at its size already: memory allocated during a capture belongs to the
    graph's pool, and counters zeroed there would be zeroed only when that
    graph replays. The engine runs each program once on its capture stream
    before capturing it."""
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < n_counters:
        if _capturing(device):
            raise RuntimeError(
                "paged decode: the split workspace of the capturing stream is missing or too "
                "small; run the program once on that stream before capturing it")
        if ws is not None:
            _RETIRED.append(ws)
        ws = (torch.empty(n_part, dtype=_F32, device=device),
              torch.zeros(max(n_counters, 4096), dtype=_I32, device=device))
        _WORKSPACE[key] = ws
    return ws


def _launch_decode(what, wrapper, window, alibi_slopes, allowed_slots, q, k_cache, v_cache,
                   block_table, ctx_lens, k_new=None, v_new=None, slots=None, k_scale=None,
                   v_scale=None):
    """Launch csrc/paged_decode.cu (f32 q: csrc/paged_decode_f32.cu) in the
    mode its arguments select, split by `decode_split_plan` (the f32
    partials and arrival counters in this stream's `_workspace`; the
    combine runs in the same launch), and count the launch on `wrapper`.
    Returns the output [S, H, D]."""
    S, H, D = q.shape
    NBLK, bs, KV, _ = k_cache.shape
    out = torch.empty_like(q)
    if S == 0:
        return out
    NB = block_table.shape[1]
    plan = decode_split_plan(S, KV, H // KV, D, NB * bs, _sm_count(q.device.index))
    stream = stream_of(q)
    f32 = q.dtype == _F32
    part = counters = None
    if plan.n > 1:
        per_cta = F32_GROUP_CTA if f32 else MAX_GROUP_CTA
        part, counters = _workspace(q.device, stream, math.prod(plan.scratch_shape),
                                    S * KV * -(-(H // KV) // per_cta))
    lib = build.load(library_name("paged_decode", q.dtype))
    opt = lambda t: None if t is None else ptr(t)
    err = (lib.paged_decode_f32 if f32 else lib.paged_decode)(
        ptr(out), ptr(q), ptr(k_cache), ptr(v_cache), opt(k_scale), opt(v_scale),
        ptr(block_table), ptr(ctx_lens), opt(k_new), opt(v_new), opt(slots),
        opt(alibi_slopes), opt(allowed_slots), opt(part), opt(counters),
        int(k_new is not None), int(k_scale is not None), S, H, KV, D, NBLK, bs, NB,
        int(window), plan.n, plan.split_len, 1.0 / D ** 0.5, stream)
    build.check(lib, err, what)
    count_launch(wrapper, window, alibi_slopes is not None, allowed_slots is not None,
                 group=H // KV, head_dim=D, dtype=q.dtype)
    return out


def paged_decode_attention(q, k_cache, v_cache, block_table, ctx_lens, window: int = 0,
                           alibi_slopes=None, allowed_slots=None):
    """Plain-mode paged decode attention (kernel: csrc/paged_decode.cu,
    FUSED=false): row s attends to cache positions < ctx_lens[s] (the last
    `window` of them when window > 0; ALiBi-biased by the [H] f32
    `alibi_slopes` when given; only those of the table slots the [S, NB]
    int32 `allowed_slots` bitmap allows, when given). Used when a decode
    row set is not
    all single tokens (chunked continuation, the suffix of a prefix-cache
    hit), after a separate paged_kv_write. q [S, H, D] and caches [NBLK,
    bs, KV, D] both bf16 or both f32, block_table [S, NB] int32, ctx_lens [S] int32 (0 = pad
    row, zeros out). Returns [S, H, D]."""
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_cache, v_cache, block_table, ctx_lens,
                                            window=window, alibi_slopes=alibi_slopes,
                                            allowed_slots=allowed_slots)
    what = "paged_decode_attention"
    _check_decode(what, q, k_cache, v_cache, block_table, ctx_lens, alibi_slopes=alibi_slopes,
                  allowed_slots=allowed_slots)
    return _launch_decode(what, paged_decode_attention, window, alibi_slopes, allowed_slots, q,
                          k_cache, v_cache, block_table, ctx_lens)


zero_counts(paged_decode_attention, *_DECODE_MODES)


def paged_decode_attention_int8(q, k_cache, v_cache, block_table, ctx_lens, k_scale,
                                v_scale, window: int = 0, alibi_slopes=None,
                                allowed_slots=None):
    """paged_decode_attention over int8 pools (kernel: csrc/paged_decode.cu,
    FUSED=false, QUANT=true): the codes are dequantized in the attention
    loop with their [NBLK, bs, KV] f32 scales (window, alibi_slopes and
    allowed_slots as in paged_decode_attention; a disallowed block's codes
    and scales are never read). Used after
    paged_kv_write_int8 for chunked continuations and prefix-hit suffixes.
    q [S, H, D] bf16 or f32 (codes dequantized to f32 then, never rounded
    to bf16), caches [NBLK, bs, KV, D] int8. Returns [S, H, D]."""
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_cache, v_cache, block_table, ctx_lens,
                                            k_scale, v_scale, window, alibi_slopes,
                                            allowed_slots)
    what = "paged_decode_attention_int8"
    _check_decode(what, q, k_cache, v_cache, block_table, ctx_lens, k_scale=k_scale,
                  v_scale=v_scale, alibi_slopes=alibi_slopes, allowed_slots=allowed_slots)
    return _launch_decode(what, paged_decode_attention_int8, window, alibi_slopes,
                          allowed_slots, q, k_cache, v_cache, block_table, ctx_lens,
                          k_scale=k_scale, v_scale=v_scale)


zero_counts(paged_decode_attention_int8, *_DECODE_MODES)


def paged_decode_fused(q, k_cache, v_cache, block_table, ctx_lens,
                       k_new, v_new, slots, window: int = 0, alibi_slopes=None,
                       allowed_slots=None):
    """Fused single-token decode (kernel: csrc/paged_decode.cu, FUSED=true):
    write each row's new K/V [S, KV, D] into its flat slot [S] AND attend
    over the cache positions < ctx-1 plus the new token, in one launch.
    Rows must be distinct sequences; ctx INCLUDES the new token; slot -1
    marks a pad row (nothing written); window > 0 attends to the last
    `window` positions only; alibi_slopes [H] f32 bias each score by
    slope_h * its position (the new token's is ctx - 1); allowed_slots
    [S, NB] int32 restricts the cache positions to the allowed table slots
    (the new token is attended whatever it says). Returns (out [S, H, D],
    k_cache, v_cache) with the arenas updated in place."""
    if not q.is_cuda:
        return paged_decode_fused_plain(q, k_cache, v_cache, block_table, ctx_lens,
                                        k_new, v_new, slots, window=window,
                                        alibi_slopes=alibi_slopes,
                                        allowed_slots=allowed_slots)
    what = "paged_decode_fused"
    _check_decode(what, q, k_cache, v_cache, block_table, ctx_lens, k_new, v_new, slots,
                  alibi_slopes=alibi_slopes, allowed_slots=allowed_slots)
    out = _launch_decode(what, paged_decode_fused, window, alibi_slopes, allowed_slots, q,
                         k_cache, v_cache, block_table, ctx_lens, k_new, v_new, slots)
    return out, k_cache, v_cache


zero_counts(paged_decode_fused, *_DECODE_MODES)


def paged_decode_fused_int8(q, k_cache, v_cache, block_table, ctx_lens, k_new, v_new,
                            slots, k_scale, v_scale, window: int = 0, alibi_slopes=None,
                            allowed_slots=None):
    """paged_decode_fused over int8 pools (kernel: csrc/paged_decode.cu,
    FUSED=true, QUANT=true): each row's new K/V [S, KV, D] (q's dtype, bf16
    or f32) is
    quantized in the kernel (codes and scales bit-identical to
    quantize_kv_rows), written into its flat slot of the code and scale
    pools, and attended as its dequantized value, in one launch. The JAX
    package's int8 fused mode of paged_decode_attention (its
    paged_decode_fused is bf16 only; window, alibi_slopes and
    allowed_slots as in paged_decode_fused). Returns (out [S, H, D],
    k_cache, v_cache, k_scale, v_scale), the pools updated in place."""
    if not q.is_cuda:
        return paged_decode_fused_plain(q, k_cache, v_cache, block_table, ctx_lens, k_new,
                                        v_new, slots, k_scale, v_scale, window, alibi_slopes,
                                        allowed_slots)
    what = "paged_decode_fused_int8"
    _check_decode(what, q, k_cache, v_cache, block_table, ctx_lens, k_new, v_new, slots,
                  k_scale, v_scale, alibi_slopes, allowed_slots)
    out = _launch_decode(what, paged_decode_fused_int8, window, alibi_slopes, allowed_slots, q,
                         k_cache, v_cache, block_table, ctx_lens, k_new, v_new, slots, k_scale,
                         v_scale)
    return out, k_cache, v_cache, k_scale, v_scale


zero_counts(paged_decode_fused_int8, *_DECODE_MODES)
