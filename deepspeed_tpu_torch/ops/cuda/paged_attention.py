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
kernel launches it made. Kernels take bf16; the plain versions take any
float dtype and compute attention in f32.

The caches are updated IN PLACE (the JAX package donates the arenas and
gets them back aliased): the write and the fused decode return the same
tensors they were given.
"""

import torch

from . import build
from ._common import check_cuda_args, check_shape, ptr, stream_of

_BF16 = torch.bfloat16
_I32 = torch.int32
_DECODE_HEAD_DIMS = (64, 128)
_DECODE_MAX_GROUP = 8


# ---------------------------------------------------------------------------
# paged KV write
# ---------------------------------------------------------------------------

def paged_kv_write_plain(cache_k, cache_v, k_new, v_new, flat_slots):
    """Scatter [T, KV, D] rows into [NBLK, bs, KV, D] caches at flat slots
    [T], in place. Slots < 0 are dropped; a slot past the arena has its
    block id clamped to the last block, as the kernel and the TPU kernel
    (_arena_block) do. The JAX package's _write_kv_xla drops such a slot
    instead; the two agree on every slot inside the arena."""
    NBLK, bs, KV, D = cache_k.shape
    keep = flat_slots >= 0
    slot = flat_slots[keep].long()
    idx = (slot // bs).clamp(max=NBLK - 1) * bs + slot % bs
    cache_k.view(NBLK * bs, KV, D)[idx] = k_new[keep].to(cache_k.dtype)
    cache_v.view(NBLK * bs, KV, D)[idx] = v_new[keep].to(cache_v.dtype)
    return cache_k, cache_v


def paged_kv_write(cache_k, cache_v, k_new, v_new, flat_slots):
    """Write new KV rows into the paged arenas in place (kernel:
    csrc/paged_kv_write.cu). cache_k/cache_v [NBLK, bs, KV, D] bf16,
    k_new/v_new [T, KV, D] bf16, flat_slots [T] int32 (-1 = dropped row).
    A slot past the arena lands in the last block, as in the plain version.
    Returns (cache_k, cache_v)."""
    if not cache_k.is_cuda:
        return paged_kv_write_plain(cache_k, cache_v, k_new, v_new, flat_slots)
    what = "paged_kv_write"
    NBLK, bs, KV, D = cache_k.shape
    T = flat_slots.shape[0]
    check_cuda_args(
        what,
        {"cache_k": cache_k, "cache_v": cache_v, "k_new": k_new, "v_new": v_new,
         "flat_slots": flat_slots},
        {"cache_k": _BF16, "cache_v": _BF16, "k_new": _BF16, "v_new": _BF16,
         "flat_slots": _I32},
        aligned=("cache_k", "cache_v", "k_new", "v_new"))
    check_shape(what, "cache_v", cache_v, cache_k.shape)
    check_shape(what, "k_new", k_new, (T, KV, D))
    check_shape(what, "v_new", v_new, (T, KV, D))
    if (KV * D * 2) % 16:
        raise ValueError(f"{what}: a [KV, D] row of {KV * D * 2} bytes is not a "
                         "multiple of 16")
    if T == 0:
        return cache_k, cache_v
    lib = build.load("paged_kv_write")
    err = lib.paged_kv_write(ptr(cache_k), ptr(cache_v), ptr(k_new), ptr(v_new),
                             ptr(flat_slots), T, NBLK, bs, KV * D * 2,
                             stream_of(cache_k))
    build.check(lib, err, what)
    paged_kv_write.launches += 1
    return cache_k, cache_v


paged_kv_write.launches = 0


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def paged_decode_attention_plain(q, k_cache, v_cache, block_table, ctx_lens):
    """Attention of one query token per row over its paged context, in f32:
    row s attends to positions < ctx_lens[s] of its table. q [S, H, D];
    caches [NBLK, bs, KV, D]; block_table [S, NB]; ctx_lens [S]. Rows with
    ctx 0 are padding and output zeros. Counterpart of the JAX package's
    paged_decode_attention_xla (which gathers the same dense context).
    Returns [S, H, D] in q's dtype."""
    S, H, D = q.shape
    NBLK, bs, KV, _ = k_cache.shape
    G = H // KV
    tbl = block_table.long().clamp(0, NBLK - 1)
    k = k_cache[tbl].reshape(S, -1, KV, D).float()  # [S, NB*bs, KV, D]
    v = v_cache[tbl].reshape(S, -1, KV, D).float()
    live = (torch.arange(k.shape[1], device=q.device)[None, :]
            < ctx_lens[:, None])  # [S, NB*bs]
    # never let a dead slot (unwritten, stale, possibly NaN) reach a sum
    k = k.masked_fill(~live[:, :, None, None], 0.0)
    v = v.masked_fill(~live[:, :, None, None], 0.0)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    logits = torch.einsum("shd,skhd->shk", q.float(), k) / D ** 0.5
    logits = logits.masked_fill(~live[:, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where((ctx_lens > 0)[:, None, None], probs, torch.zeros_like(probs))
    return torch.einsum("shk,skhd->shd", probs, v).to(q.dtype)


def paged_decode_fused_plain(q, k_cache, v_cache, block_table, ctx_lens,
                             k_new, v_new, slots):
    """Fused-mode reference: write each row's new K/V into its slot, then
    attend over positions < ctx (which include the new token).
    Returns (out, k_cache, v_cache), the caches updated in place."""
    paged_kv_write_plain(k_cache, v_cache, k_new, v_new, slots)
    out = paged_decode_attention_plain(q, k_cache, v_cache, block_table, ctx_lens)
    return out, k_cache, v_cache


def _check_decode(what, q, k_cache, v_cache, block_table, ctx_lens,
                  k_new=None, v_new=None, slots=None):
    S, H, D = q.shape
    NBLK, bs, KV, Dc = k_cache.shape
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "block_table": block_table, "ctx_lens": ctx_lens}
    dtypes = {"q": _BF16, "k_cache": _BF16, "v_cache": _BF16,
              "block_table": _I32, "ctx_lens": _I32}
    if k_new is not None:
        tensors.update(k_new=k_new, v_new=v_new, slots=slots)
        dtypes.update(k_new=_BF16, v_new=_BF16, slots=_I32)
    check_cuda_args(what, tensors, dtypes, aligned=("k_cache", "v_cache"))
    if Dc != D or D not in _DECODE_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} (cache {Dc}); the kernel is "
                         f"built for {_DECODE_HEAD_DIMS}")
    if H % KV or H // KV > _DECODE_MAX_GROUP:
        raise ValueError(f"{what}: {H} query heads over {KV} KV heads; need a "
                         f"whole group of at most {_DECODE_MAX_GROUP}")
    check_shape(what, "v_cache", v_cache, k_cache.shape)
    if block_table.dim() != 2 or block_table.shape[0] != S:
        raise ValueError(f"{what}: block_table has shape {tuple(block_table.shape)}, "
                         f"expected [{S}, NB]")
    check_shape(what, "ctx_lens", ctx_lens, (S,))
    if k_new is not None:
        check_shape(what, "k_new", k_new, (S, KV, D))
        check_shape(what, "v_new", v_new, (S, KV, D))
        check_shape(what, "slots", slots, (S,))


def _launch_decode(what, fused, q, k_cache, v_cache, block_table, ctx_lens,
                   k_new=None, v_new=None, slots=None):
    S, H, D = q.shape
    NBLK, bs, KV, _ = k_cache.shape
    out = torch.empty_like(q)
    if S == 0:
        return out
    lib = build.load("paged_decode")
    null = None
    err = lib.paged_decode(
        ptr(out), ptr(q), ptr(k_cache), ptr(v_cache), ptr(block_table),
        ptr(ctx_lens),
        ptr(k_new) if fused else null, ptr(v_new) if fused else null,
        ptr(slots) if fused else null,
        int(fused), S, H, KV, D, NBLK, bs, block_table.shape[1],
        1.0 / D ** 0.5, stream_of(q))
    build.check(lib, err, what)
    return out


def paged_decode_attention(q, k_cache, v_cache, block_table, ctx_lens):
    """Plain-mode paged decode attention (kernel: csrc/paged_decode.cu,
    FUSED=false): row s attends to cache positions < ctx_lens[s]. Used when
    a decode row set is not all single tokens (chunked continuation, the
    suffix of a prefix-cache hit), after a separate paged_kv_write.
    q [S, H, D] bf16, caches [NBLK, bs, KV, D] bf16, block_table [S, NB]
    int32, ctx_lens [S] int32 (0 = pad row, zeros out). Returns [S, H, D]."""
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_cache, v_cache, block_table, ctx_lens)
    what = "paged_decode_attention"
    _check_decode(what, q, k_cache, v_cache, block_table, ctx_lens)
    out = _launch_decode(what, False, q, k_cache, v_cache, block_table, ctx_lens)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_fused(q, k_cache, v_cache, block_table, ctx_lens,
                       k_new, v_new, slots):
    """Fused single-token decode (kernel: csrc/paged_decode.cu, FUSED=true):
    write each row's new K/V [S, KV, D] into its flat slot [S] AND attend
    over the cache positions < ctx-1 plus the new token, in one launch.
    Rows must be distinct sequences; ctx INCLUDES the new token; slot -1
    marks a pad row (nothing written). Returns (out [S, H, D], k_cache,
    v_cache) with the arenas updated in place."""
    if not q.is_cuda:
        return paged_decode_fused_plain(q, k_cache, v_cache, block_table, ctx_lens,
                                        k_new, v_new, slots)
    what = "paged_decode_fused"
    _check_decode(what, q, k_cache, v_cache, block_table, ctx_lens, k_new, v_new, slots)
    out = _launch_decode(what, True, q, k_cache, v_cache, block_table, ctx_lens,
                         k_new, v_new, slots)
    paged_decode_fused.launches += 1
    return out, k_cache, v_cache


paged_decode_fused.launches = 0
