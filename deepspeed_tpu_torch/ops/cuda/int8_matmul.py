"""The W8A16 GEMM of the per-channel int8 serving path: a hand-written
CUDA kernel (csrc/int8_matmul.cu) beside its plain PyTorch version.

    y = int8_matmul(x, codes, scale)              # [M, N] in x's dtype
    y = int8_matmul(x, codes, scale, out_f32=True)  # [M, N] f32 (logits)

x [M, K] activations, codes [N, K] int8 (one output channel a row, K
contiguous: inference/quantization.py ChannelQuantWeight's layout), scale
[N] f32. The function is the JAX package's `_wmm` and `_lm_logits` on a
ChannelQuantWeight (deepspeed_tpu/inference/model.py:198, :216): the
product of x with the codes in x's dtype, then times the scale in x's
dtype (two roundings in bf16), or, for the logits, that product in f32
times the f32 scale.

The wrapper runs the plain version for tensors on the CPU and launches the
kernel for CUDA tensors (bf16 x, K a multiple of 16) or raises; it keeps
`launches`, the number of kernel launches it made. Where the output tiles
alone would leave the card idle (decode's few rows), the kernel splits K
(`matmul_split_plan`); the f32 partials and the arrival counters live in
the stream's workspace (paged_attention._workspace: allocated outside any
CUDA graph capture, never freed while a graph may hold it), and the last
CTA of each tile adds them in split order, so two launches give the same
bits.
"""

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from ._common import check_cuda_args, check_shape, count_launch, ptr, stream_of, zero_counts
from .paged_attention import _sm_count, _workspace

# the kernel's tiles (csrc/int8_matmul.cu): 128 output columns a CTA, a
# ring of STAGES slices of the contraction, each BK deep
BN, BK, STAGES = 128, 128, 3
# the shared memory one SM gives its CTAs (H100: 227 KB)
SM_SHARED_BYTES = 232448
# split K into as many ranges as keep the grid within one wave of resident
# CTAs, at most MAX_SPLITS, each at least MIN_SPLIT_CHUNKS slices deep, and
# the partials' bytes (written once, read once) at most half the codes'
# (K >= PARTIAL_RATIO x M x splits). At decode widths (M <= 64), codes of
# at most SMALL_CODE_BYTES (the flagship's products: the 50 MB L2 holds
# them several times over) take 16-row CTAs and splits down to one slice:
# their re-reads and partials stay in L2, and the latency of a CTA's chain
# of slices is what costs. Set by sweeps of rows a CTA and split counts at
# the flagship's and Llama-2-7B's decode products on the H100 (PERF.md):
# a second, partial wave cost more than the splits it added.
MAX_SPLITS, MIN_SPLIT_CHUNKS, PARTIAL_RATIO = 8, 4, 16
SMALL_CODE_BYTES = 8 << 20


class MatmulPlan(NamedTuple):
    """`bm` rows a CTA; `n` splits of `split_len` (a multiple of BK) along
    K, none empty; `ctas` in the grid; `scratch_shape`, the f32 partials
    [n, M, N] (() when K is not split); `tiles`, the arrival counters
    needed."""
    bm: int
    n: int
    split_len: int
    ctas: int
    tiles: int
    scratch_shape: Tuple[int, ...]

    @property
    def scratch_bytes(self) -> int:
        return 4 * math.prod(self.scratch_shape) if self.scratch_shape else 0


def block_rows(M: int, small: bool = False) -> int:
    """Rows a CTA: the least of 16, 32, 64, 128 that holds M (128 above);
    16 up to M 64 for small codes (see above)."""
    for bm in (16, 32, 64):
        if M <= bm:
            return 16 if small else bm
    return 128


def resident_ctas(bm: int) -> int:
    """CTAs of `bm` rows one SM holds at once: its shared memory over the
    ring's (the kernel's Cfg<BM>::SMEM; registers allow more)."""
    return SM_SHARED_BYTES // (STAGES * (bm * (BK + 8) * 2 + BN * BK))


def matmul_split_plan_for(M: int, N: int, K: int, n: int,
                          bm: Optional[int] = None) -> MatmulPlan:
    """The plan of about `n` splits: whole slices each, ceil(slices / n)
    of them, so that none is empty; `bm` rows a CTA (default block_rows)."""
    bm = bm or block_rows(M)
    chunks = max(1, -(-K // BK))
    n = max(1, min(n, chunks))
    size = -(-chunks // n)
    n = -(-chunks // size)
    tiles = -(-M // bm) * -(-N // BN)
    return MatmulPlan(bm, n, size * BK, tiles * n, tiles, (n, M, N) if n > 1 else ())


@functools.lru_cache(maxsize=None)
def matmul_split_plan(M: int, N: int, K: int, sm_count: int) -> MatmulPlan:
    """The split the kernel takes for [M, K] x [N, K]^T on a card of
    `sm_count` SMs (see the constants above; cached: a decode step asks
    with the same shapes every layer)."""
    small = N * K <= SMALL_CODE_BYTES and M <= 64  # a decode step's small product
    bm = block_rows(M, small)
    tiles = -(-M // bm) * -(-N // BN)
    chunks = max(1, -(-K // BK))
    n = min(resident_ctas(bm) * sm_count // tiles, MAX_SPLITS,
            chunks if small else min(chunks // MIN_SPLIT_CHUNKS, K // (PARTIAL_RATIO * M)))
    return matmul_split_plan_for(M, N, K, max(1, n), bm)


def int8_matmul_plain(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                      out_f32: bool = False) -> torch.Tensor:
    """_wmm's torch form: (x @ codes^T in x's dtype) * scale in x's dtype;
    out_f32: the product cast to f32 times the f32 scale (_lm_logits)."""
    y = x @ codes.to(x.dtype).t()
    if out_f32:
        return y.float() * scale
    return y * scale.to(x.dtype)


def int8_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                out_f32: bool = False) -> torch.Tensor:
    """x [M, K] @ codes [N, K]^T with per-column scales [N] (kernel:
    csrc/int8_matmul.cu; see the module docstring). Returns [M, N] bf16,
    or f32 with out_f32."""
    if not x.is_cuda:
        return int8_matmul_plain(x, codes, scale, out_f32)
    what = "int8_matmul"
    M, K = x.shape
    N = codes.shape[0]
    check_cuda_args(what, {"x": x, "codes": codes, "scale": scale},
                    {"x": torch.bfloat16, "codes": torch.int8, "scale": torch.float32},
                    aligned=("x", "codes"))
    check_shape(what, "codes", codes, (N, K))
    check_shape(what, "scale", scale, (N,))
    if K == 0 or K % 16:
        raise ValueError(f"{what}: K = {K}; the kernel takes a positive multiple of 16")
    out = torch.empty((M, N), dtype=torch.float32 if out_f32 else torch.bfloat16,
                      device=x.device)
    if M == 0 or N == 0:
        return out
    plan = matmul_split_plan(M, N, K, _sm_count(x.device.index))
    stream = stream_of(x)
    part = counters = None
    if plan.n > 1:
        part, counters = _workspace(x.device, stream, math.prod(plan.scratch_shape), plan.tiles)
    lib = build.load("int8_matmul")
    opt = lambda t: None if t is None else ptr(t)
    err = lib.int8_matmul(ptr(out), ptr(x), ptr(codes), ptr(scale), opt(part), opt(counters),
                          M, N, K, plan.bm, plan.n, plan.split_len, int(out_f32), stream)
    build.check(lib, err, what)
    count_launch(int8_matmul)
    return out


zero_counts(int8_matmul)
