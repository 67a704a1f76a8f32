"""The grouped (ragged) GEMM of dropless MoE serving: a hand-written CUDA
kernel (csrc/grouped_gemm.cu) beside its plain PyTorch version.

    out = grouped_gemm(xs, w, counts)   # [A, N] bf16

xs [A, K] bf16 holds the expert-sorted assignment rows in contiguous
segments, counts [X] int32 (on the device) their lengths, w [X, K, N] bf16
the expert weights: out[a] = xs[a] @ w[e(a)], e(a) the segment of row a,
summed in f32. Rows past sum(counts) are zero. It stands in for
jax.lax.ragged_dot (deepspeed_tpu/moe/dropless.py:134 grouped_mm), XLA's
and no pallas_call, so it is a kernel the port adds.

The kernel finds each segment's offset on the device (an exclusive scan of
counts in every CTA) and its grid is sized by the bound ceil(A / 64) + X
row tiles times the column tiles, so nothing is read on the host and the
launch can be captured in a CUDA graph; a CTA whose tile lies past the
segments exits. Empty segments take no tile.

The plain version is the JAX package's "dense" oracle: a masked scan over
the experts, each expert's product over every row kept where the row lies
in its segment. The wrapper runs it for tensors on the CPU and launches the
kernel for CUDA tensors (bf16, K and N multiples of 8) or raises; it keeps
`launches`, the number of kernel launches it made.
"""

import torch

from . import build
from ._common import check_cuda_args, check_shape, count_launch, ptr, stream_of, zero_counts

# the kernel's row tile (csrc/grouped_gemm.cu BM): its grid takes
# ceil(A / BM) + X row tiles, a bound on what the segments take (each
# segment's last tile may be partial)
BM = 64


def grouped_gemm_plain(xs: torch.Tensor, w: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The masked scan (the JAX package's grouped_mm impl="dense"): for each
    expert the product of every row, kept where the row lies in its
    segment, added to a zero accumulator in xs's dtype."""
    counts = counts.to(device=xs.device, dtype=torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(xs.shape[0], device=xs.device)
    acc = xs.new_zeros((xs.shape[0], w.shape[-1]))
    for e in range(w.shape[0]):
        seg = ((pos >= offsets[e]) & (pos < offsets[e] + counts[e]))[:, None]
        acc = acc + torch.where(seg, xs @ w[e].to(xs.dtype), 0)
    return acc


def grouped_gemm(xs: torch.Tensor, w: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """xs [A, K] @ w[e] [K, N] over the segments of counts [X] (kernel:
    csrc/grouped_gemm.cu; see the module docstring) -> [A, N] bf16."""
    if not xs.is_cuda:
        return grouped_gemm_plain(xs, w, counts)
    what = "grouped_gemm"
    A, K = xs.shape
    X, _, N = w.shape
    check_cuda_args(what, {"xs": xs, "w": w, "counts": counts},
                    {"xs": torch.bfloat16, "w": torch.bfloat16, "counts": torch.int32},
                    aligned=("xs", "w"))
    check_shape(what, "w", w, (X, K, N))
    check_shape(what, "counts", counts, (X,))
    if K % 8 or N % 8:
        raise ValueError(f"{what}: K = {K}, N = {N}; the kernel takes multiples of 8")
    out = torch.zeros((A, N), dtype=torch.bfloat16, device=xs.device)
    if A == 0 or N == 0 or X == 0:
        return out
    lib = build.load("grouped_gemm")
    err = lib.grouped_gemm(ptr(out), ptr(xs), ptr(w), ptr(counts), A, K, N, X, stream_of(xs))
    build.check(lib, err, what)
    count_launch(grouped_gemm)
    return out


zero_counts(grouped_gemm)
