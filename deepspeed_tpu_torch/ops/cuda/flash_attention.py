"""Causal flash-attention forward: a hand-written CUDA kernel beside its
plain PyTorch version.

Counterpart of deepspeed_tpu/ops/pallas/flash_attention.py (`_flash_fwd`,
reached through `flash_attention` / `flash_attention_with_lse`). Layout is
the reference's public one: q [B, S, H, D], k/v [B, S, KV, D] with GQA
groups of H // KV contiguous query heads per KV head (never repeated in
memory by the kernel). Returns o [B, S, H, D] and lse [B, H, S] f32.

The wrapper runs the plain version for CPU tensors and launches the
kernel (csrc/flash_fwd.cu, bf16) for CUDA tensors or raises; `launches`
counts its kernel launches.
"""

import torch

from . import build
from ._common import check_cuda_args, check_shape, ptr, stream_of

_HEAD_DIMS = (64, 128)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, KV * n_rep, D], each KV head repeated for
    its group of query heads."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def flash_attention_plain(q, k, v):
    """Dense causal attention computed in f32 (the counterpart of the JAX
    package's _xla_attention, ops/attention.py). Returns (o in q's dtype,
    lse [B, H, S] f32)."""
    B, S, H, D = q.shape
    n_rep = H // k.shape[2]
    kf = _repeat_kv(k, n_rep).float()
    vf = _repeat_kv(v, n_rep).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / D ** 0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)  # [B, H, S]
    probs = torch.exp(logits - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return o.to(q.dtype), lse


def flash_attention(q, k, v):
    """Causal attention (kernel: csrc/flash_fwd.cu). q [B, S, H, D] bf16,
    k/v [B, S, KV, D] bf16, all contiguous. Returns (o [B, S, H, D] bf16,
    lse [B, H, S] f32)."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v)
    what = "flash_attention"
    B, S, H, D = q.shape
    KV = k.shape[2]
    check_cuda_args(what, {"q": q, "k": k, "v": v},
                    {"q": torch.bfloat16, "k": torch.bfloat16, "v": torch.bfloat16},
                    aligned=("q", "k", "v"))
    check_shape(what, "k", k, (B, S, KV, D))
    check_shape(what, "v", v, (B, S, KV, D))
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D}; the kernel is built for {_HEAD_DIMS}")
    if KV == 0 or H % KV:
        raise ValueError(f"{what}: {H} query heads are not a multiple of {KV} KV heads")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B * S == 0:
        return o, lse
    lib = build.load("flash_fwd")
    err = lib.flash_fwd(ptr(o), ptr(lse), ptr(q), ptr(k), ptr(v), B, S, H, KV, D,
                        1.0 / D ** 0.5, stream_of(q))
    build.check(lib, err, what)
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
