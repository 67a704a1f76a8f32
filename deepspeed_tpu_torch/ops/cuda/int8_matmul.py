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
times the f32 scale. No `pallas_call` is replaced: XLA fuses the int8 ->
bf16 convert into the dot on the TPU.

The kernel (see its header) runs on wgmma with the operands swapped: 128
output channels a tile as wgmma's M, the tokens as its N (`tn`: 8, 16,
32 or 64, the least that holds M, at decode, where the codes' bytes bound
it; tiles of 128 tokens at prefill, where the tensor cores do), fed by a
TMA ring that a producer warpgroup keeps full, the codes converted to
bf16 once, in registers. `matmul_split_plan` gives the token width and
the grid: at most one wave of CTAs, each a contiguous, equal range of the
(tile, 128-deep slice) units, so a tile may be cut between CTAs; the f32
partials and the arrival counters of cut tiles live in the stream's
workspace (paged_attention._workspace: allocated outside any CUDA graph
capture, never freed while a graph may hold it), and the CTA that ends a
tile adds them in CTA order, so two launches give the same bits.

The wrapper runs the plain version for tensors on the CPU and launches the
kernel for CUDA tensors (bf16 x, K a multiple of 16) or raises; it keeps
`launches`, the number of kernel launches it made.
"""

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from ._common import check_cuda_args, check_shape, count_launch, ptr, stream_of, zero_counts
from .paged_attention import _sm_count, _workspace

# The kernel's tiles (csrc/int8_matmul.cu Cfg): CH output channels (two
# consumer warpgroups of one m64 tile) by `tn` token rows; a unit is UK
# contraction columns, one ring stage; the ring holds as many stages as
# shared memory allows, at most MAX_STAGES (Cfg keeps the same rule).
CH = 128
UK = 128
TOKEN_WIDTHS = (8, 16, 32, 64, 128)  # decode: the least that holds M; past 64 rows, 128
SM_SHARED_BYTES = 232448  # the shared memory a CTA may take (H100: 227 KB)
MAX_STAGES = 6
FIXED_BYTES = 1024 + 2 * MAX_STAGES * 8  # beside the ring: alignment slack, mbarriers
# The grid (matmul_split_plan; PERF.md has the sweeps that set these). At
# decode widths one balanced wave, tiles cut as the units fall, but at 32
# and 64 tokens (partial slots of 16-32 KB) at least DECODE_MIN_UNITS units
# a CTA. At prefill one CTA a tile where that fills the waves to at least
# WAVE_FILL, or where the tiles are fewer than the SMs and shallower than
# PREFILL_SPLIT_CHUNKS units (a cut tile's 64 KB partial slots cost more
# than the idle SMs); else one balanced wave.
DECODE_MIN_UNITS = 4
WAVE_FILL = 0.95
PREFILL_SPLIT_CHUNKS = 16


def stage_bytes(tn: int) -> int:
    """One ring stage: the codes [CH][UK] int8 and X [tn][UK] bf16."""
    return CH * UK + 2 * tn * UK


def wgmma_stages(tn: int) -> int:
    return min(MAX_STAGES, (SM_SHARED_BYTES - FIXED_BYTES) // stage_bytes(tn))


def wgmma_smem(tn: int) -> int:
    """Dynamic shared memory a CTA of token width tn takes (Cfg::SMEM)."""
    st = wgmma_stages(tn)
    return st * stage_bytes(tn) + 2 * st * 8 + 1024


class MatmulPlan(NamedTuple):
    """`tn` token rows a tile (CH channels), `stages` in the ring; `ctas`
    CTAs in the grid, each a contiguous range of the `units` (tile,
    UK-deep slice), tile-major; `tiles` output tiles, `chunks` units a
    tile; `scratch_shape`, the f32 partial slots [2 x ctas, tn, CH] where
    some tile is cut between CTAs (else ())."""
    tn: int
    stages: int
    ctas: int
    tiles: int
    chunks: int
    scratch_shape: Tuple[int, ...]

    @property
    def units(self) -> int:
        return self.tiles * self.chunks

    @property
    def splits(self) -> bool:
        return bool(self.scratch_shape)

    @property
    def scratch_bytes(self) -> int:
        return 4 * math.prod(self.scratch_shape) if self.scratch_shape else 0


def token_width(M: int) -> int:
    """Token rows a tile: the least that holds M, 128 past 64 rows."""
    return next((tn for tn in TOKEN_WIDTHS if M <= tn), TOKEN_WIDTHS[-1])


def unit_start(g: int, units: int, ctas: int) -> int:
    """The first unit of CTA g (the kernel's unit_start)."""
    return g * units // ctas


def cta_of(u: int, units: int, ctas: int) -> int:
    """The CTA whose range holds unit u (the kernel's cta_of)."""
    return ((u + 1) * ctas + units - 1) // units - 1


def segments(plan: MatmulPlan):
    """[(cta, tile, first unit, end unit, partial slot or None)] in CTA
    order: each CTA's range cut at tile boundaries; a segment that is not
    a whole tile writes slot 2 x cta (the CTA's first segment) or 2 x cta
    + 1 (its last)."""
    out = []
    for g in range(plan.ctas):
        ub, ue = unit_start(g, plan.units, plan.ctas), unit_start(g + 1, plan.units, plan.ctas)
        u = ub
        while u < ue:
            t = u // plan.chunks
            end = min(ue, (t + 1) * plan.chunks)
            whole = u == t * plan.chunks and end == (t + 1) * plan.chunks
            out.append((g, t, u, end, None if whole else 2 * g + (u > ub)))
            u = end
    return out


def _splits_tiles(units: int, chunks: int, ctas: int) -> bool:
    if units % ctas == 0:
        return (units // ctas) % chunks != 0
    return any(unit_start(g, units, ctas) % chunks for g in range(1, ctas))


def matmul_split_plan_for(M: int, N: int, K: int, ctas: int,
                          tn: Optional[int] = None) -> MatmulPlan:
    """The plan of `ctas` CTAs (at most the units) at token width tn
    (default token_width(M))."""
    tn = tn or token_width(M)
    if tn not in TOKEN_WIDTHS:
        raise ValueError(f"int8_matmul: no kernel for {tn} token rows")
    tiles = -(-N // CH) * -(-M // tn)
    chunks = max(1, -(-K // UK))
    ctas = max(1, min(ctas, tiles * chunks))
    split = _splits_tiles(tiles * chunks, chunks, ctas)
    return MatmulPlan(tn, wgmma_stages(tn), ctas, tiles, chunks,
                      (2 * ctas, tn, CH) if split else ())


@functools.lru_cache(maxsize=None)
def matmul_split_plan(M: int, N: int, K: int, sm_count: int) -> MatmulPlan:
    """The plan the kernel takes for [M, K] x [N, K]^T on a card of
    `sm_count` SMs (see the rules above; cached: a decode step asks with
    the same shapes every layer)."""
    tn = token_width(M)
    tiles = -(-N // CH) * -(-M // tn)
    units = tiles * max(1, -(-K // UK))
    if tn <= 64:
        return matmul_split_plan_for(M, N, K, min(sm_count, max(
            1, units // (DECODE_MIN_UNITS if tn >= 32 else 1))), tn)
    fill = tiles / (-(-tiles // sm_count) * sm_count)
    if fill >= WAVE_FILL or (tiles < sm_count and units < PREFILL_SPLIT_CHUNKS * tiles):
        return matmul_split_plan_for(M, N, K, tiles, tn)
    return matmul_split_plan_for(M, N, K, sm_count, tn)


def int8_matmul_plain(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                      out_f32: bool = False) -> torch.Tensor:
    """_wmm's torch form: (x @ codes^T in x's dtype) * scale in x's dtype;
    out_f32: the product cast to f32 times the f32 scale (_lm_logits)."""
    y = x @ codes.to(x.dtype).t()
    if out_f32:
        return y.float() * scale
    return y * scale.to(x.dtype)


def encode_ns(x: torch.Tensor, codes: torch.Tensor, iters: int = 1000) -> float:
    """Host nanoseconds a call spends on its two tensor maps (the codes'
    found in the kernel's table, x's encoded), the mean of `iters`."""
    M, K = x.shape
    plan = matmul_split_plan(M, codes.shape[0], K, _sm_count(x.device.index))
    ns = build.load("int8_matmul").int8_matmul_encode_ns(ptr(x), ptr(codes), M, codes.shape[0],
                                                         K, plan.tn, iters)
    if ns < 0:
        raise RuntimeError("int8_matmul: a tensor map failed to encode")
    return ns / iters


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
    if plan.splits:
        part, counters = _workspace(x.device, stream, math.prod(plan.scratch_shape), plan.tiles)
    lib = build.load("int8_matmul")
    opt = lambda t: None if t is None else ptr(t)
    err = lib.int8_matmul(ptr(out), ptr(x), ptr(codes), ptr(scale), opt(part), opt(counters),
                          M, N, K, plan.tn, plan.ctas, int(out_f32), stream)
    build.check(lib, err, what)
    count_launch(int8_matmul)
    return out


zero_counts(int8_matmul)
