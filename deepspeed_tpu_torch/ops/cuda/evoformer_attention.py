"""Evoformer (DS4Sci) attention, forward and backward: hand-written CUDA
kernels beside their plain PyTorch versions, joined by a
`torch.autograd.Function`.

Counterpart of deepspeed_tpu/ops/pallas/evoformer_attention.py:
`_evo_kernel` (kernel #7, csrc/evoformer_fwd.cu), `_evo_bwd_dq_kernel`
(#8) and `_evo_bwd_dkv_kernel` (#9, both in csrc/evoformer_bwd.cu),
`_evo_bwd_db2_kernel` (#10, csrc/evoformer_db2.cu), and the custom VJP
that ties them together
(deepspeed_tpu/ops/evoformer_attention.py `_evo_fused`). The layout is
the reference's public one:

    q, k, v, o, do  [B, S, N, H, D]   (batch, sequences, residues, heads)
    bias1           [B, S, 1, 1, N]   per-key bias (the MSA mask), or None
    bias2           [B, 1, H, N, N]   pair bias, shared by the sequences, or None
    lse, delta      [G, N] f32, G = B * S * H in (b, s, h) order

The kernels read q, k, v and do in place in that layout; no transposed
copy is made. For CUDA tensors the wrappers launch the kernels (bf16, head
dims 32 and 64) or raise; for CPU tensors they run the plain versions,
which compute the same recompute-from-lse math densely in f32, with P
rounded to the inputs' dtype before P V and P and dS before their backward
products, as the kernels (and the TPU kernels) round them: a no-op in f32.
Every kernel wrapper carries `launches`, raised by one per launch.

#7-#10 split the sequence axis across CTAs where the grid would not keep
the card busy: `fwd_run_plan` (#7) and `bwd_run_plan` (#8, #9: each CTA
walks a run of sequences with its part of bias2 resident) and
`db2_split_plan` (#10: each CTA sums a chunk of sequences; a second pass
adds the chunks in order).
"""

import functools
import math
from typing import NamedTuple, Tuple

import torch

from . import build
from ._common import (bwd_mismatch, check_cuda_args, check_shape, count_launch,  # noqa: F401
                      ptr, stream_of)

_HEAD_DIMS = (32, 64)
_BF16 = torch.bfloat16
_F32 = torch.float32


def _logits(q, k, bias1, bias2):
    """f32 logits [B, S, H, Nq, Nk]: q k^T * scale + bias1 + bias2, added in
    that order as the reference kernel adds them. q [B, S, Nq, H, D], k
    [B, S, Nk, H, D], bias1 [B, S, 1, 1, Nk], bias2 [B, 1, H, Nq, Nk]."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bsqhd,bskhd->bshqk", q.float(), k.float()) * scale
    if bias1 is not None:
        s = s + bias1.float()
    if bias2 is not None:
        s = s + bias2.float()
    return s


def evoformer_fwd_plain(q, k, v, bias1=None, bias2=None):
    """Dense evoformer attention in f32: softmax(q k^T / sqrt(D) + bias1 +
    bias2) v. P is rounded to v's dtype before P V (as kernel #7 does; a
    no-op in f32). Returns (o [B, S, N, H, D] in q's dtype, lse [G, N]
    f32)."""
    B, S, N, H, _ = q.shape
    s = _logits(q, k, bias1, bias2)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)  # the reference kernel's guard
    o = torch.einsum("bshqk,bskhd->bsqhd", p.to(v.dtype).float(), v.float())
    o = o / l.squeeze(-1).transpose(2, 3)[..., None]
    lse = (m + torch.log(l)).reshape(B * S * H, N)
    return o.to(q.dtype), lse


def _delta(o, do):
    """rowsum(dO * O) in f32, [B, S, N, H, D] -> [G, N] (the reference
    computes it with XLA outside its kernels, evoformer_attention.py:288)."""
    B, S, N, H, _ = o.shape
    return (do.float() * o.float()).sum(-1).transpose(2, 3).contiguous().reshape(B * S * H, N)


def _bwd_plain(q, k, v, bias1, bias2, lse, delta, do):
    """Dense f32 backward from the saved lse and delta over q, do [B, S,
    Nq, H, D] and k, v [B, S, Nk, H, D] (Nq and Nk may differ, so a tile
    of the full problem can be taken alone). P and dS are rounded to the
    inputs' dtype before their products, as kernels #8 and #9 round them;
    the row sums and db2 add the unrounded f32 dS. Returns dq, dk, dv (the
    inputs' dtypes), dsum [G, Nk] f32 (the sum of dS over queries) and
    db2 [B, 1, H, Nq, Nk] in bias2's dtype, or None without bias2."""
    B, S, Nq, H, D = q.shape
    scale = 1.0 / D ** 0.5
    p = torch.exp(_logits(q, k, bias1, bias2) - lse.reshape(B, S, H, Nq, 1))
    dof = do.float()
    dp = torch.einsum("bsqhd,bskhd->bshqk", dof, v.float())
    ds = p * (dp - delta.reshape(B, S, H, Nq, 1))
    pr, dsr = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.einsum("bshqk,bskhd->bsqhd", dsr, k.float()) * scale
    dk = torch.einsum("bshqk,bsqhd->bskhd", dsr, q.float()) * scale
    dv = torch.einsum("bshqk,bsqhd->bskhd", pr, dof)
    dsum = ds.sum(3).reshape(B * S * H, -1)
    db2 = None if bias2 is None else ds.sum(1, keepdim=True).to(bias2.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dsum, db2


def _db1(dsum, bias1):
    """bias1's gradient from the per-(g, key) row sums: bias1 broadcasts
    over queries and heads, so it is the sum of dsum over heads (a torch
    sum outside the kernels, as the reference leaves it to XLA)."""
    B, S, _, _, N = bias1.shape
    return dsum.reshape(B, S, -1, N).sum(2).reshape(B, S, 1, 1, N).to(bias1.dtype)


def evoformer_bwd_plain(q, k, v, bias1, bias2, o, lse, do):
    """The plain version of the evoformer backward (what kernels #8-#10
    compute tile by tile): dense f32 recompute of P from lse, with delta =
    rowsum(dO * O) in f32. Returns (dq, dk, dv, db1, db2); db1 / db2 are
    None where the bias is."""
    dq, dk, dv, dsum, db2 = _bwd_plain(q, k, v, bias1, bias2, lse, _delta(o, do), do)
    return dq, dk, dv, None if bias1 is None else _db1(dsum, bias1), db2


def _check_args(what, tensors):
    """CUDA, bf16 (lse / delta f32), contiguous, 16-byte aligned, and the
    contract's shapes; a head dim the kernels were built for."""
    B, S, N, H, D = tensors["q"].shape
    tensors = {n: t for n, t in tensors.items() if t is not None}
    dtypes = {n: (_F32 if n in ("lse", "delta") else _BF16) for n in tensors}
    check_cuda_args(what, tensors, dtypes,
                    aligned=tuple(n for n in tensors if n not in ("bias1", "bias2")))
    shapes = {"bias1": (B, S, 1, 1, N), "bias2": (B, 1, H, N, N), "lse": (B * S * H, N),
              "delta": (B * S * H, N)}
    for name, t in tensors.items():
        check_shape(what, name, t, shapes.get(name, (B, S, N, H, D)))
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D}; the kernels are built for {_HEAD_DIMS}")


def _dims(q):
    B, S, N, H, D = q.shape
    return B, S, N, H, D, 1.0 / D ** 0.5


# The sequence split of kernels #7-#10. A CTA of #7 or #8 owns 128 query
# rows of one (b, h) and walks a run of sequences, a CTA of #9 128 key rows;
# a CTA of #10 owns a 128 x 64 tile of db2 and sums a chunk of sequences.
# All hold one CTA an SM. A
# grid of at least SPLIT_WAVES waves of unsplit CTAs (each walking all S)
# is not split: its tail is at most a fraction of a wave in several. Else
# the plan takes the count of runs that minimises waves x (sequences per
# CTA + RUN_SETUP), RUN_SETUP being a CTA's fixed cost in sequences (the
# bias2 band or tile, filling the ring, the partial's write), with runs of
# at least MIN_RUN sequences: #10's f32 scratch then stays under a quarter
# of one f32 [G, N, N] logits tensor.
BM, BK = 128, 64  # a CTA's query rows (#7, #8, #10) or keys (#9), and keys (#10)
SPLIT_WAVES, RUN_SETUP, MIN_RUN = 4, 1, 4


class SeqSplit(NamedTuple):
    """A split of the S sequences: `n` runs (#7-#9) or chunks (#10) of
    ceil(S / n) sequences, `runs[c]` = (first, end) of run c (contiguous,
    in order, the last possibly shorter, none empty), `ctas` in the grid,
    and `scratch_shape`, #10's [n, B H, N, N] f32 partial sums (() when
    nothing is split, and always for #7-#9)."""
    n: int
    runs: Tuple[Tuple[int, int], ...]
    ctas: int
    scratch_shape: Tuple[int, ...]

    @property
    def scratch_bytes(self) -> int:
        return 4 * math.prod(self.scratch_shape) if self.scratch_shape else 0


@functools.lru_cache(maxsize=None)
def _split(units, S, sm_count):
    """(n, runs) for `units` CTAs a run on `sm_count` SMs (one CTA an SM)."""
    n = 1
    if units < SPLIT_WAVES * sm_count and S >= 2 * MIN_RUN:
        cost = lambda k: (-(-units * k // sm_count) * (-(-S // k) + RUN_SETUP), k)
        n = min(range(1, S // MIN_RUN + 1), key=cost)
    size = -(-S // n)
    n = -(-S // size)  # no run left empty: run c starts at c * size
    return n, tuple((c * size, min(S, (c + 1) * size)) for c in range(n))


def fwd_run_plan(B, S, N, H, sm_count) -> SeqSplit:
    """The runs of kernel #7 on a card of `sm_count` SMs: B * H *
    ceil(N / 128) CTAs per run, each loading its 128 x N band of bias2 once
    for the run's sequences."""
    units = B * H * -(-N // BM)
    n, runs = _split(units, S, sm_count)
    return SeqSplit(n, runs, n * units, ())


def bwd_run_plan(B, S, N, H, D, sm_count) -> SeqSplit:
    """The runs of kernels #8 (dq: 128 query rows a CTA) and #9 (dk, dv:
    128 key rows a CTA) on a card of `sm_count` SMs, each CTA loading its
    band of bias2 once for the run's sequences. At both head dims their
    grids are #7's, B * H * ceil(N / 128) CTAs per run, so the runs are
    `fwd_run_plan`'s. Every sequence's outputs are computed alone, so the
    run count changes no bits."""
    return fwd_run_plan(B, S, N, H, sm_count)


def db2_split_plan(B, S, N, H, D, sm_count) -> SeqSplit:
    """The chunks of kernel #10 on a card of `sm_count` SMs: B * H *
    ceil(N / 128) * ceil(N / 64) CTAs per chunk, each summing its chunk's
    sequences into an f32 tile; with more than one chunk, the partials
    [n, B H, N, N] f32 that the combining pass adds in chunk order."""
    units = B * H * -(-N // BM) * -(-N // BK)
    n, runs = _split(units, S, sm_count)
    return SeqSplit(n, runs, n * units, (n, B * H, N, N) if n > 1 else ())


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def evoformer_fwd(q, k, v, bias1=None, bias2=None):
    """Evoformer attention forward (kernel #7: csrc/evoformer_fwd.cu, its
    sequences in the runs of `fwd_run_plan`). q, k, v [B, S, N, H, D] bf16,
    bias1 [B, S, 1, 1, N] / bias2 [B, 1, H, N, N] bf16 or None, all
    contiguous. Returns (o [B, S, N, H, D] bf16, lse [G, N] f32). CPU
    tensors take the plain version."""
    if not q.is_cuda:
        return evoformer_fwd_plain(q, k, v, bias1, bias2)
    what = "evoformer_fwd"
    _check_args(what, {"q": q, "k": k, "v": v, "bias1": bias1, "bias2": bias2})
    B, S, N, H, D, scale = _dims(q)
    o = torch.empty_like(q)
    lse = torch.empty((B * S * H, N), dtype=_F32, device=q.device)
    if o.numel() == 0:
        return o, lse
    plan = fwd_run_plan(B, S, N, H, _sm_count(q.device))
    lib = build.load("evoformer_fwd")
    err = lib.evoformer_fwd(ptr(o), ptr(lse), ptr(q), ptr(k), ptr(v),
                            None if bias1 is None else ptr(bias1),
                            None if bias2 is None else ptr(bias2), B, S, N, H, D, plan.n,
                            scale, stream_of(q))
    build.check(lib, err, what)
    count_launch(evoformer_fwd)
    return o, lse


evoformer_fwd.launches = 0


def _bwd_args(what, q, k, v, bias1, bias2, do, lse, delta):
    _check_args(what, {"q": q, "k": k, "v": v, "bias1": bias1, "bias2": bias2, "do": do,
                       "lse": lse, "delta": delta})
    return (ptr(q), ptr(k), ptr(v), None if bias1 is None else ptr(bias1),
            None if bias2 is None else ptr(bias2), ptr(do), ptr(lse), ptr(delta))


def _bwd_runs(what, q, n_runs):
    """The run count of #8 / #9: `bwd_run_plan`'s, or `n_runs` where given
    (any count from 1 to S gives the same bits)."""
    B, S, N, H, D = q.shape
    if n_runs is None:
        return bwd_run_plan(B, S, N, H, D, _sm_count(q.device)).n
    if not 1 <= n_runs <= S:
        raise ValueError(f"{what}: n_runs {n_runs} outside 1..{S}")
    return n_runs


def evoformer_bwd_dq(q, k, v, bias1, bias2, do, lse, delta, n_runs=None):
    """dq of evoformer attention (kernel #8: csrc/evoformer_bwd.cu, its
    sequences in the runs of `bwd_run_plan`, or in `n_runs` runs where
    given) from the forward's lse and delta = rowsum(dO * O) [G, N] f32;
    other arguments as `evoformer_fwd`, do like q. Returns dq [B, S, N, H,
    D] bf16. CPU tensors take the plain version."""
    if not q.is_cuda:
        return _bwd_plain(q, k, v, bias1, bias2, lse, delta, do)[0]
    what = "evoformer_bwd_dq"
    args = _bwd_args(what, q, k, v, bias1, bias2, do, lse, delta)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    runs = _bwd_runs(what, q, n_runs)
    B, S, N, H, D, scale = _dims(q)
    lib = build.load("evoformer_bwd")
    err = lib.evoformer_bwd_dq(ptr(dq), *args, B, S, N, H, D, runs, scale, stream_of(q))
    build.check(lib, err, what)
    count_launch(evoformer_bwd_dq)
    return dq


evoformer_bwd_dq.launches = 0


def evoformer_bwd_dkv(q, k, v, bias1, bias2, do, lse, delta, n_runs=None):
    """dk, dv and the per-(g, key) row sums of dS (kernel #9:
    csrc/evoformer_bwd.cu; bias1's gradient is their sum over heads,
    `_db1`). Arguments as `evoformer_bwd_dq`. Returns (dk, dv [B, S, N, H,
    D] bf16, dsum [G, N] f32). CPU tensors take the plain version."""
    if not q.is_cuda:
        return _bwd_plain(q, k, v, bias1, bias2, lse, delta, do)[1:4]
    what = "evoformer_bwd_dkv"
    args = _bwd_args(what, q, k, v, bias1, bias2, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty_like(lse)
    if dk.numel() == 0:
        return dk, dv, dsum
    runs = _bwd_runs(what, q, n_runs)
    B, S, N, H, D, scale = _dims(q)
    lib = build.load("evoformer_bwd")
    err = lib.evoformer_bwd_dkv(ptr(dk), ptr(dv), ptr(dsum), *args, B, S, N, H, D, runs, scale,
                                stream_of(q))
    build.check(lib, err, what)
    count_launch(evoformer_bwd_dkv)
    return dk, dv, dsum


evoformer_bwd_dkv.launches = 0


def evoformer_bwd_db2(q, k, v, bias1, bias2, do, lse, delta):
    """bias2's gradient, the sum of dS over the S sequences (kernel #10:
    csrc/evoformer_db2.cu). Each CTA sums its 128 x 64 tile over a chunk of
    the sequences (`db2_split_plan`); with more than one chunk, into an f32
    scratch that this wrapper allocates and a second kernel adds in chunk
    order, rounding once (no atomics: the same bits every run). The
    combining pass counts under this wrapper's `launches`, so a forward and
    backward still counts each of the four evoformer names once. bias2 is
    required; other arguments as `evoformer_bwd_dq`. Returns db2 [B, 1, H,
    N, N] in bias2's dtype. CPU tensors take the plain version."""
    if bias2 is None:
        raise ValueError("evoformer_bwd_db2: bias2 is None, so it has no gradient")
    if not q.is_cuda:
        return _bwd_plain(q, k, v, bias1, bias2, lse, delta, do)[4]
    what = "evoformer_bwd_db2"
    args = _bwd_args(what, q, k, v, bias1, bias2, do, lse, delta)
    db2 = torch.empty_like(bias2)
    if db2.numel() == 0:
        return db2
    B, S, N, H, D, scale = _dims(q)
    plan = db2_split_plan(B, S, N, H, D, _sm_count(q.device))
    part = (torch.empty(plan.scratch_shape, dtype=_F32, device=q.device)
            if plan.scratch_shape else None)
    lib = build.load("evoformer_db2")
    err = lib.evoformer_bwd_db2(ptr(db2), None if part is None else ptr(part), *args, B, S, N,
                                H, D, plan.n, scale, stream_of(q))
    build.check(lib, err, what)
    count_launch(evoformer_bwd_db2)
    return db2


evoformer_bwd_db2.launches = 0


def evoformer_attention_bwd(q, k, v, bias1, bias2, o, lse, do, need_db1=True, need_db2=True):
    """(dq, dk, dv, db1, db2) from the forward's residuals: kernels #8, #9
    and, when bias2's gradient is needed, #10 for CUDA tensors (delta and
    bias1's head sum computed with torch around them, as the reference
    computes them with XLA); the plain version for CPU tensors. db1 / db2
    are None where the bias is absent or its gradient not needed."""
    need_db1 = need_db1 and bias1 is not None
    need_db2 = need_db2 and bias2 is not None
    if not q.is_cuda:
        dq, dk, dv, db1, db2 = evoformer_bwd_plain(q, k, v, bias1, bias2, o, lse, do)
        return dq, dk, dv, db1 if need_db1 else None, db2 if need_db2 else None
    delta = _delta(o, do)
    args = (q, k, v, bias1, bias2, do, lse, delta)
    dq = evoformer_bwd_dq(*args)
    dk, dv, dsum = evoformer_bwd_dkv(*args)
    db1 = _db1(dsum, bias1) if need_db1 else None
    db2 = evoformer_bwd_db2(*args) if need_db2 else None
    return dq, dk, dv, db1, db2


class EvoformerAttention(torch.autograd.Function):
    """Evoformer attention with its backward (the reference's `_evo_fused`
    custom VJP). forward(q, k, v, bias1, bias2) -> o, with either bias
    None; it saves q, k, v, the biases, o and lse. An absent bias, or one
    that needs no gradient, gets None back: no zero placeholders."""

    @staticmethod
    def forward(ctx, q, k, v, bias1, bias2):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        bias1 = None if bias1 is None else bias1.contiguous()
        bias2 = None if bias2 is None else bias2.contiguous()
        o, lse = evoformer_fwd(q, k, v, bias1, bias2)
        ctx.save_for_backward(q, k, v, bias1, bias2, o, lse)
        ctx.set_materialize_grads(False)
        return o

    @staticmethod
    def backward(ctx, do):
        if do is None:
            return None, None, None, None, None
        q, k, v, bias1, bias2, o, lse = ctx.saved_tensors
        return evoformer_attention_bwd(q, k, v, bias1, bias2, o, lse, do.contiguous(),
                                       need_db1=ctx.needs_input_grad[3],
                                       need_db2=ctx.needs_input_grad[4])
