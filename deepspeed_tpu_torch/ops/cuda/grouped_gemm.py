"""The grouped (ragged) GEMM of dropless MoE serving: a hand-written CUDA
kernel (csrc/grouped_gemm.cu) in two operand forms, each beside its plain
PyTorch version.

    out = grouped_gemm(xs, w, counts)                    # [A, N] bf16
    out = grouped_gemm_int8(xs, codes, scale, counts)    # [A, N] bf16

xs [A, K] bf16 holds the expert-sorted assignment rows in contiguous
segments, counts [X] int32 (on the device) their lengths; out[a] = xs[a] @
w[e(a)], e(a) the segment of row a, summed in f32. Rows past sum(counts)
are zero. The weights are a bf16 stack w [X, K, N], or a groupwise int8 one
(inference/quantization.py QuantizedWeight, bits 8): codes [X, K, N] and f32
scales [X, K, groups], each weight bf16_rn(f32(code) * scale) with the
scale of its k row and its N / groups columns, the value
ops/quantization.py dequantize_groupwise writes. It stands in for
jax.lax.ragged_dot (deepspeed_tpu/moe/dropless.py:134 grouped_mm) on the
stacks the JAX package dequantizes "transiently at use", XLA's and no
pallas_call, so it is a kernel the port adds.

The kernel (see its header) runs on wgmma with the operands swapped: 128
weight columns a CTA as wgmma's M, `tn` rows of one segment as its N (16
at decode, 128 at prefill: `token_width`), fed by a TMA ring that a
producer warp keeps full; the int8 form converts the codes into bf16 boxes
in shared memory on the way. Each CTA finds its segment's offset on the
device (a scan of counts) and the grid's row tiles are the bound
ceil(A / tn) + min(X, A) - 1, so nothing is read on the host and the
launch can be captured in a CUDA graph; a CTA whose tile lies past the
segments exits. Where too few tiles are live to fill the card, the
contraction is split (`grouped_plan`): f32 partials and arrival counters
live in the stream's workspace (paged_attention._workspace), and the last
CTA of a tile adds the splits in k order, so two launches give the same
bits.

The plain versions are the JAX package's "dense" oracle: a masked scan over
the experts, each expert's product over every row kept where the row lies
in its segment (the int8 form's on the stack dequantized first). The
wrappers run them for tensors on the CPU and launch the kernel for CUDA
tensors or raise; each keeps `launches`, the number of kernel launches it
made.
"""

import functools
from typing import NamedTuple

import torch

from ..quantization import dequantize_groupwise
from . import build
from ._common import check_cuda_args, check_shape, count_launch, ptr, stream_of, zero_counts
from .paged_attention import _sm_count, _workspace

# The kernel's tiles (csrc/grouped_gemm.cu Cfg): CH weight columns a CTA
# (two consumer warpgroups of 64) by `tn` rows of one segment; a ring stage
# is BK contraction rows.
CH = 128
BK = 64
TOKEN_WIDTHS = (16, 128)
# ring stages by (form, token width) and CTAs an SM by token width
# (Cfg<Q8, TN, STAGES, MINB>): the int8 stages are smaller (codes), so more
STAGES = {("bf16", 16): 5, ("bf16", 128): 6, ("int8", 16): 9, ("int8", 128): 8}
CTAS_PER_SM = {16: 2, 128: 1}
# split K where the row tiles that any routing must compute, times the
# column tiles, are fewer than the SMs: into enough ranges of the
# contraction for SPLIT_FILL[form] waves of them, each at least
# MIN_SPLIT_CHUNKS chunks of BK deep. A bf16 CTA streams its weights ~3x as
# fast as an int8 one converts them, so the bf16 form splits less
# (`port_timing.py grouped`'s sweep, PERF.md)
SPLIT_FILL = {"bf16": 1, "int8": 2}
MIN_SPLIT_CHUNKS = 4


def token_width(A: int, X: int) -> int:
    """Rows a tile: 16 where the segments average at most 32 rows (decode,
    and the scan path's T-row segments at decode widths), else 128."""
    return TOKEN_WIDTHS[0] if -(-A // max(X, 1)) <= 32 else TOKEN_WIDTHS[1]


def smem_bytes(tn: int, int8: bool) -> int:
    """Dynamic shared memory a CTA takes (Cfg::SMEM): the ring of stages
    (the weight tile, the xs box, the int8 form's scales), its mbarriers,
    alignment slack."""
    w = BK * CH if int8 else 2 * BK * 64 * 2
    stage = -(-(w + tn * 128 + (2 * BK * 4 if int8 else 0)) // 1024) * 1024
    n = STAGES["int8" if int8 else "bf16", tn]
    return n * stage + 2 * n * 8 + 1024


class GroupedPlan(NamedTuple):
    """`tn` rows a tile; the grid: `row_tiles` (the bound on the tiles the
    segments take) x `col_tiles` x `splits` ranges of the `chunks` BK-deep
    chunks of the contraction; `scratch_floats`, the f32 partial tiles
    where splits > 1 (else 0)."""
    tn: int
    splits: int
    row_tiles: int
    col_tiles: int
    chunks: int

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.col_tiles

    @property
    def scratch_floats(self) -> int:
        return self.splits * self.tiles * self.tn * CH if self.splits > 1 else 0

    def split_range(self, s: int):
        """The chunks [first, end) of split s (the kernel's kc0, kc1)."""
        return s * self.chunks // self.splits, (s + 1) * self.chunks // self.splits


@functools.lru_cache(maxsize=None)
def grouped_plan(A: int, K: int, N: int, X: int, sm_count: int,
                 int8: bool = False) -> GroupedPlan:
    """The plan the kernel takes for A rows over X experts' [K, N]
    weights (int8: the int8 form's) on a card of `sm_count` SMs. The
    active experts live on the device, so the split counts the tiles any
    routing computes at least, ceil(A / tn) row tiles (cached: a layer
    asks with the same shapes)."""
    tn = token_width(A, X)
    row_tiles = max(0, -(-A // tn) + min(X, A) - 1)
    col_tiles = -(-N // CH)
    chunks = max(1, -(-K // BK))
    least = max(1, -(-A // tn) * col_tiles)
    splits = 1
    if least < sm_count:
        fill = SPLIT_FILL["int8" if int8 else "bf16"]
        splits = max(1, min(-(-fill * sm_count // least), chunks // MIN_SPLIT_CHUNKS))
    return GroupedPlan(tn, splits, row_tiles, col_tiles, chunks)


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


def grouped_gemm_int8_plain(xs: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                            counts: torch.Tensor,
                            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The stack dequantized to `dtype` (dequantize_groupwise: the value the
    kernel makes), then the masked scan in xs's dtype."""
    return grouped_gemm_plain(xs, dequantize_groupwise(codes, scale, dtype), counts)


def _launch(what, wrapper, xs, w, counts, scale=None):
    """Plan, workspace and launch of either form; counts the launch on
    `wrapper`. Returns out [A, N] bf16 (rows past the segments zero)."""
    A, K = xs.shape
    X, _, N = w.shape
    out = torch.zeros((A, N), dtype=torch.bfloat16, device=xs.device)
    if A == 0 or N == 0 or X == 0:
        return out
    plan = grouped_plan(A, K, N, X, _sm_count(xs.device.index), scale is not None)
    stream = stream_of(xs)
    part = counters = None
    if plan.splits > 1:
        part, counters = _workspace(xs.device, stream, plan.scratch_floats, plan.tiles)
    lib = build.load("grouped_gemm")
    opt = lambda t: None if t is None else ptr(t)
    if scale is None:
        err = lib.grouped_gemm(ptr(out), ptr(xs), ptr(w), ptr(counts), opt(part), opt(counters),
                               A, K, N, X, plan.tn, plan.splits, stream)
    else:
        err = lib.grouped_gemm_int8(ptr(out), ptr(xs), ptr(w), ptr(scale), ptr(counts),
                                    opt(part), opt(counters), A, K, N, X, scale.shape[-1],
                                    plan.tn, plan.splits, stream)
    build.check(lib, err, what)
    count_launch(wrapper)
    return out


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
    return _launch(what, grouped_gemm, xs, w, counts)


def grouped_gemm_int8(xs: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                      counts: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """xs [A, K] @ the groupwise int8 stack (codes [X, K, N], scale [X, K,
    groups]) over the segments of counts [X], each weight dequantized to
    `dtype` (kernel: csrc/grouped_gemm.cu, which makes bf16 weights) ->
    [A, N] in xs's dtype (bf16 on the card)."""
    if not xs.is_cuda:
        return grouped_gemm_int8_plain(xs, codes, scale, counts, dtype)
    what = "grouped_gemm_int8"
    A, K = xs.shape
    X, _, N = codes.shape
    check_cuda_args(what, {"xs": xs, "codes": codes, "scale": scale, "counts": counts},
                    {"xs": torch.bfloat16, "codes": torch.int8, "scale": torch.float32,
                     "counts": torch.int32}, aligned=("xs", "codes"))
    if dtype != torch.bfloat16:
        raise TypeError(f"{what}: the kernel dequantizes to bfloat16, not {dtype}")
    check_shape(what, "codes", codes, (X, K, N))
    groups = scale.shape[-1] if scale.dim() == 3 else 0
    check_shape(what, "scale", scale, (X, K, groups))
    check_shape(what, "counts", counts, (X,))
    if K % 8 or groups == 0 or N % groups or (N // groups) % 64:
        raise ValueError(f"{what}: K = {K}, N = {N}, {groups} scale groups a row; the kernel "
                         "takes K a multiple of 8 and groups of a multiple of 64 columns that "
                         "divide N")
    return _launch(what, grouped_gemm_int8, xs, codes, counts, scale)


zero_counts(grouped_gemm)
zero_counts(grouped_gemm_int8)
