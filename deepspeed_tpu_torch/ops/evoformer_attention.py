"""Memory-efficient evoformer (MSA / triangle) attention.

Counterpart of deepspeed_tpu/ops/evoformer_attention.py, DeepSpeed's
DS4Sci_EvoformerAttention surface: q/k/v [*, N_seq, N_res, H, D] and up to
two broadcastable biases. The memory problem it solves: the N_res^2
logits of every (sequence, head), with two bias adds, explode for long
proteins.

- `ds4sci_evoformer_attention` routes inputs that meet the DS4Sci contract
  (rank 5, bias1 [B, S, 1, 1, N], bias2 [B, 1, H, N, N]) through
  `EvoformerAttention` (ops/cuda/evoformer_attention.py): the fused
  forward and backward kernels on the GPU, their plain versions on the
  CPU. Unlike the JAX package it needs no tile-divisible N: the CUDA
  kernels mask a ragged last tile. Everything else, and `use_kernel=False`,
  takes the chunked path below, on every device, as in the JAX package.
- `evoformer_attention` is that chunked path: exact online-softmax
  attention over key chunks, each chunk under `torch.utils.checkpoint` (in
  place of the JAX package's `lax.scan` under `jax.checkpoint`), so the
  backward recomputes a chunk's logits instead of keeping them: O(N_res *
  chunk) live logits. N <= chunk_size takes one dense step.
"""

from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .cuda.evoformer_attention import EvoformerAttention


def evoformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        biases: Sequence[Optional[torch.Tensor]] = (),
                        chunk_size: int = 512) -> torch.Tensor:
    """q/k/v: [..., N, H, D]; biases: broadcastable to [..., H, N, N] (e.g.
    an MSA mask [.., 1, 1, N] and a pair bias [.., H, N, N]). Returns
    [..., N, H, D]: exact softmax(q k^T / sqrt(d) + sum of biases) v,
    computed in key chunks with an online softmax, never materialising
    [N, N] unless N <= chunk_size."""
    *lead, N, H, D = q.shape
    scale = 1.0 / np.sqrt(D)
    qT, kT, vT = (x.movedim(-2, -3) for x in (q, k, v))  # [..., H, N, D]

    if N <= chunk_size:
        logits = torch.einsum("...qd,...kd->...qk", qT, kT) * scale
        for b in biases:
            if b is not None:
                logits = logits + b
        p = torch.softmax(logits.float(), dim=-1)
        out = torch.einsum("...qk,...kd->...qd", p.to(q.dtype), vT)
        return out.movedim(-3, -2)

    if N % chunk_size:
        raise ValueError(f"chunk_size={chunk_size} must divide N={N} (pick a divisor)")

    def chunk(x, c):
        return x[..., c * chunk_size:(c + 1) * chunk_size, :]

    def body(m, l, acc, c):
        lo, hi = c * chunk_size, (c + 1) * chunk_size
        logits = torch.einsum("...qd,...kd->...qk", qT, chunk(kT, c)).float() * scale
        for b in biases:
            if b is not None:  # a bias over keys is sliced, a broadcast one kept
                logits = logits + (b[..., lo:hi] if b.shape[-1] == N else b).float()
        m_new = torch.maximum(m, logits.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l_new = l * corr + p.sum(-1)
        acc_new = acc * corr[..., None] + torch.einsum("...qk,...kd->...qd", p,
                                                        chunk(vT, c).float())
        return m_new, l_new, acc_new

    m = torch.full((*lead, H, N), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((*lead, H, N), dtype=torch.float32, device=q.device)
    acc = torch.zeros((*lead, H, N, D), dtype=torch.float32, device=q.device)
    for c in range(N // chunk_size):
        m, l, acc = checkpoint(body, m, l, acc, c, use_reentrant=False)
    out = (acc / l[..., None]).to(q.dtype)
    return out.movedim(-3, -2)


def ds4sci_evoformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               biases: Sequence[Optional[torch.Tensor]] = (),
                               use_kernel: bool = True, chunk_size: int = 512) -> torch.Tensor:
    """The DS4Sci_EvoformerAttention surface: q/k/v [B, S, N, H, D], up to
    two biases, [B, S, 1, 1, N] per-key mask and [B, 1, H, N, N] pair.

    use_kernel=True routes the forward and the backward through the fused
    kernels (#7-#10) when the inputs meet that contract; anything off it
    takes the chunked `evoformer_attention` (exact, O(N * chunk))."""
    b1 = biases[0] if len(biases) > 0 else None
    b2 = biases[1] if len(biases) > 1 else None
    fits = False
    if use_kernel and q.dim() == 5:
        B, S, N, H, _ = q.shape
        fits = ((b1 is None or tuple(b1.shape) == (B, S, 1, 1, N))
                and (b2 is None or tuple(b2.shape) == (B, 1, H, N, N)))
    if not fits:
        return evoformer_attention(q, k, v, biases, chunk_size=chunk_size)
    return EvoformerAttention.apply(q, k, v, b1, b2)
