"""Causal flash attention, forward and backward, with an optional sliding
window: hand-written CUDA kernels beside their plain PyTorch versions,
joined by a `torch.autograd.Function`.

Counterpart of deepspeed_tpu/ops/pallas/flash_attention.py: `_flash_fwd`
(kernel #1, csrc/flash_fwd.cu) and `_flash_bwd`'s `_bwd_dq_kernel` (#2)
and `_bwd_dkv_kernel` (#3, both csrc/flash_bwd.cu), and the custom VJP
that ties them together. Layout is the reference's public one: q, o, dq
[B, S, H, D], k, v, dk, dv [B, S, KV, D] with GQA groups of H // KV
contiguous query heads per KV head (never repeated in memory by the
kernels), lse and delta [B, H, S] f32.

`flash_attention(q, k, v)` is differentiable on every device. Its forward
saves q, k, v, o and lse (the residuals of the reference's
`_flash_fwd_rule`); its backward recomputes the probabilities from lse.
For CUDA tensors both directions launch the kernels (bf16 or f16) or
raise; for CPU tensors they run the plain versions (`flash_attention_plain`,
`flash_attention_bwd_plain`), which do the same recompute-from-lse math
densely in f32 (P and dS rounded to the inputs' dtype where the kernels
round them). Every kernel wrapper carries `launches`, raised by one
per launch of its kernel, `window_launches`, raised by one per launch in
the sliding-window mode, `alibi_launches`, in the ALiBi mode,
`wide_group_launches`, with more than 8 query heads per KV head
(Falcon-7B: 71 over one), `d80_launches`, at head_dim 80 (Phi-2), and
`d96_launches` and `d256_launches`, at head_dim 96 (GPT-NeoX-20B) and 256
(GPT-J-6B), and `f16_launches`, on f16 operands (the forward also
`f32_launches`, on f32 operands).

Element types: q, k, v (and dO) are all bf16 or all f16 (fp16
mixed-precision training: the same kernels built with DS_F16, libraries
`flash_fwd+DS_F16` and `flash_bwd+DS_F16`, in every mode the bf16 ones
have); lse, delta and the ALiBi slopes stay f32, and o, dq, dk, dv come
back in the inputs' type. Mixed types raise. The forward also takes f32
(an f32 serving engine's prefill: csrc/flash_fwd_f32.cu, an FFMA kernel of
its own, library `flash_fwd_f32`, every mode); the backward kernels do not
yet (ROADMAP B6's training half): on CUDA they raise for f32, and the
autograd Function raises at its forward, before any launch, when f32
inputs need a gradient.

Kernel #3 sums each KV head's dk and dv over its group of query heads in
registers; where its grid would leave SMs idle it splits the group into
chunks (`dkv_split_plan`) whose f32 partials a second pass adds in chunk
order (the scratch comes from `torch.empty`; no atomics either way).

Head dims: all three kernels take 64, 80, 96, 128 and 256 (at 256 kernel
#3 runs 64-key CTAs of two warpgroups, one on dV and one on dK, and its
group split counts 64-key blocks). A CUDA tensor of another head dim
raises.

Sliding window (`window` > 0, Mistral-class; the reference's token-exact
mode): query row r attends to key column c iff r - window < c <= r.
window = 0 is plain causal attention; any window >= S gives the causal
result bit for bit (the same tiles and entries).

ALiBi (`alibi`: [H] f32 slopes, Bloom-class): the score of query row r and
key column c of q head h gains slope_h * (c - r) after the 1/sqrt(D) scale
and before the mask, as in the reference's kernel and _xla_attention. It
composes with the window. With GQA the slope is that of the q head, not
of its KV head. The backward recomputes P with the same bias (in dk and
dv, each q head of a group with its own slope); the slopes carry no
gradient (architectural constants, as in the reference's rule).

Not ported yet (ROADMAP B3, with the non-causal mode): the lse cotangent
of `flash_attention_with_lse` (`delta_adjust`, used only by ring
attention): a loss that reaches lse raises in the backward.
"""

import math
from typing import NamedTuple, Tuple

import torch

from . import build
from ._common import (BWD_FLOOR, BWD_ROW_ATOL, BWD_RTOL, F16_ERR_RMS, F16_FLOOR,  # noqa: F401
                      F16_ROW_ATOL, F16_RTOL, bwd_mismatch, check_cuda_args, check_shape,
                      count_launch, ptr, stream_of, zero_counts)

# head dims the kernels are built for, forward and backward (80: Phi-2;
# 96: GPT-NeoX-20B; 256: GPT-J-6B)
_HEAD_DIMS = (64, 80, 96, 128, 256)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, KV * n_rep, D], each KV head repeated for
    its group of query heads."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def _causal_logits(q, k, window: int = 0, alibi=None):
    """f32 scaled logits [B, H, S, S] with the causal mask applied (-inf);
    window > 0 also masks the columns c <= r - window of row r; alibi [H]
    adds slope_h * (c - r) before the mask."""
    B, S, H, D = q.shape
    kf = _repeat_kv(k, H // k.shape[2]).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / D ** 0.5
    if alibi is not None:
        pos = torch.arange(S, device=q.device)
        rel = (pos[None, :] - pos[:, None]).float()  # [S, S]: c - r
        logits = logits + alibi.float().reshape(H)[None, :, None, None] * rel
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    if window > 0:
        mask = mask.triu(1 - window)
    return logits.masked_fill(~mask, float("-inf"))


def flash_attention_plain(q, k, v, window: int = 0, alibi=None):
    """Dense causal attention computed in f32 (the counterpart of the JAX
    package's _xla_attention, ops/attention.py), banded to `window` when
    it is > 0, ALiBi-biased by the [H] slopes `alibi` when given. Returns
    (o in q's dtype, lse [B, H, S] f32)."""
    logits = _causal_logits(q, k, window, alibi)
    lse = torch.logsumexp(logits, dim=-1)  # [B, H, S]
    probs = torch.exp(logits - lse[..., None])
    vf = _repeat_kv(v, q.shape[2] // k.shape[2]).float()
    o = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return o.to(q.dtype), lse


def _delta(o, do):
    """rowsum(dO * O) in f32, [B, S, H, D] -> [B, H, S] (the reference
    computes it with XLA outside its kernels, flash_attention.py:406)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_plain(q, k, v, lse, delta, do, window: int = 0, alibi=None, sums: bool = False):
    """Dense f32 backward from the saved lse and delta: returns dq, dk, dv
    in the inputs' dtypes, the GQA heads of each group summed into their
    KV head; P recomputed with the ALiBi bias of the [H] slopes `alibi`
    when given. P and dS are rounded to the inputs' dtype before their
    products, as the reference kernel does (`ds.astype(k.dtype)`) and as
    kernels #2 and #3 do for the tensor cores: a no-op in f32, bf16 or f16
    rounding for bf16 or f16 inputs (an f16 |dS| past 65504 becomes inf).
    With `sums`, returns (dq, dk, dv) in f32 before their final rounding
    and dS [B, H, S, S] in f32 before its rounding instead (the distance
    of each from f16's overflow: the fp16 overflow checks)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / D ** 0.5
    p = torch.exp(_causal_logits(q, k, window, alibi) - lse[..., None].float())  # masked -> 0
    dof = do.float()
    vf = _repeat_kv(v, G).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds32 = p * (dp - delta[..., None].float()) * scale
    p, ds = p.to(q.dtype).float(), ds32.to(q.dtype).float()
    if not sums:
        del ds32
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _repeat_kv(k, G).float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, S, KV, G, D).sum(3)
    dv = dv.reshape(B, S, KV, G, D).sum(3)
    if sums:
        return dq, dk, dv, ds32
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, window: int = 0, alibi=None):
    """The plain version of the flash backward: dense f32 recompute of the
    probabilities from lse (what kernels #2 and #3 compute tile by tile),
    ALiBi-biased by `alibi` when given, P and dS rounded to the inputs'
    dtype as the kernels round them. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    return _bwd_plain(q, k, v, lse, _delta(o, do), do, window, alibi)


_BF16 = torch.bfloat16
_F16 = torch.float16
_F32 = torch.float32
# the kernels' element types -> the library suffix of each source's build
_BUILDS = {_BF16: "", _F16: "+DS_F16"}
_ROW_STATS = ("lse", "delta")  # f32 [B, H, S] beside the element-type tensors
_F32_TRAINING = ("the f32 backward kernels are not ported yet (ROADMAP B6's training "
                 "half: #2/#3 in f32 with the f32 training config)")


def _elem_dtype(what, q):
    """The element type the kernels take for q: bf16 or f16, and for the
    forward f32 (its own source, `flash_fwd_f32`); f32 in the backward
    raises (ROADMAP B6's training half). Pure: reads q's dtype only."""
    if q.dtype == _F32 and what == "flash_fwd":
        return _F32
    if q.dtype == _F32:
        raise TypeError(f"{what}: q has dtype {q.dtype}; {_F32_TRAINING}")
    if q.dtype not in _BUILDS:
        raise TypeError(f"{what}: q has dtype {q.dtype}; the kernels take bf16 or f16 "
                        "(and the forward f32)")
    return q.dtype


def library_name(name, dtype):
    """The kernel library of source `name` for element type `dtype`: the
    source's build (`+DS_F16` for f16), or its f32 source `<name>_f32`."""
    return name + "_f32" if dtype == _F32 else name + _BUILDS[dtype]


def _library(name, dtype):
    return build.load(library_name(name, dtype))


def check_no_f32_grad(dtype, on_cuda: bool, needs_grad: bool):
    """The autograd Function's guard, before any launch: f32 inputs on the
    card that need a gradient raise (no f32 backward kernel yet)."""
    if dtype == _F32 and on_cuda and needs_grad:
        raise TypeError(f"flash_attention: f32 inputs that need a gradient; {_F32_TRAINING}")


# f16's rounding edge: an f32 value of magnitude 65520 or more rounds to inf
F16_EDGE = 65520.0


def f16_overflow_scales(q, k, v, o, lse, do, window: int = 0, alibi=None,
                        margin: float = 2.0 ** -10, steps: int = 24):
    """The powers of two by which the fp16 overflow checks scale an f16 dO
    (exactly, as a loss scale does): (s_over, s_below, stats). At s_over
    some entries of the plain backward's f32 dS reach F16_EDGE, so their
    f16 rounding is inf; at s_below no dS entry and no output sum does, so
    every gradient is finite. At both, every dS entry and every finite
    output sum lies more than `margin` (relative) from the edge, so no
    overflow decision turns on the order of a kernel's f32 sums. Raises
    if no such pair exists within `steps` doublings of dO."""
    def probe(s):
        dos = (do.float() * s).to(do.dtype)
        if not torch.isfinite(dos).all():
            return None
        dq, dk, dv, ds = _bwd_plain(q, k, v, lse, _delta(o, dos), dos, window, alibi,
                                    sums=True)
        near = False
        for x in (ds, dq, dk, dv):
            r = x.abs()[torch.isfinite(x)] / F16_EDGE
            near |= bool(((r > 1 - margin) & (r < 1 + margin)).any())
        top = (ds.abs().max() / F16_EDGE).item()
        outs_finite = all(bool((torch.isfinite(x) & (x.abs() < F16_EDGE)).all())
                          for x in (dq, dk, dv))
        return {"scale": s, "ds_max_over_edge": top, "near_edge": near,
                "outputs_finite": outs_finite, "ds_over": int((ds.abs() >= F16_EDGE).sum())}

    probes = [probe(2.0 ** i) for i in range(steps)]
    over = next((i for i, p in enumerate(probes)
                 if p is not None and p["ds_over"] and not p["near_edge"]), None)
    if over is None:
        raise ValueError(f"no dO scale up to 2^{steps - 1} overflows f16's dS clear of the edge")
    below = next((i for i in range(over - 1, -1, -1)
                  if probes[i] is not None and not probes[i]["ds_over"]
                  and probes[i]["outputs_finite"] and not probes[i]["near_edge"]), None)
    if below is None:
        raise ValueError("no dO scale below the overflow keeps every output finite")
    return 2.0 ** over, 2.0 ** below, {"over": probes[over], "below": probes[below]}


def _check_attention_args(what, tensors, dtypes, q, k):
    B, S, H, D = q.shape
    KV = k.shape[2]
    check_cuda_args(what, tensors, dtypes,
                    aligned=tuple(n for n in tensors if n not in _ROW_STATS))
    for name, t in tensors.items():
        if name in _ROW_STATS:
            check_shape(what, name, t, (B, H, S))
        elif name in ("k", "v", "dk", "dv"):
            check_shape(what, name, t, (B, S, KV, D))
        else:
            check_shape(what, name, t, (B, S, H, D))
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D}; the kernel is built for {_HEAD_DIMS}")
    if KV == 0 or H % KV:
        raise ValueError(f"{what}: {H} query heads are not a multiple of {KV} KV heads")


def _check_slopes(what, q, alibi):
    """ALiBi slopes: [H] f32 on q's card, contiguous."""
    if alibi is not None:
        check_cuda_args(what, {"q": q, "alibi": alibi}, {"q": q.dtype, "alibi": _F32})
        check_shape(what, "alibi", alibi, (q.shape[2],))


def flash_fwd(q, k, v, window: int = 0, alibi=None):
    """Causal attention forward (kernel #1: csrc/flash_fwd.cu), banded to
    `window` when it is > 0, ALiBi-biased by `alibi` ([H] f32 slopes, one
    per q head) when given. q [B, S, H, D], k/v [B, S, KV, D], all bf16
    or all f16, contiguous. Returns (o [B, S, H, D] in q's dtype, lse [B,
    H, S] f32). f32 q, k, v take the f32 kernel (csrc/flash_fwd_f32.cu).
    CPU tensors take the plain version."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, window, alibi)
    what = "flash_fwd"
    dt = _elem_dtype(what, q)
    _check_attention_args(what, {"q": q, "k": k, "v": v}, {"q": dt, "k": dt, "v": dt}, q, k)
    _check_slopes(what, q, alibi)
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=_F32, device=q.device)
    if B * S == 0:
        return o, lse
    lib = _library("flash_fwd", dt)
    fn = lib.flash_fwd_f32 if dt == _F32 else lib.flash_fwd
    err = fn(ptr(o), ptr(lse), ptr(q), ptr(k), ptr(v), None if alibi is None else ptr(alibi),
             B, S, H, k.shape[2], D, int(window), 1.0 / D ** 0.5, stream_of(q))
    build.check(lib, err, what)
    count_launch(flash_fwd, window, alibi is not None, group=H // k.shape[2], head_dim=D,
                 dtype=dt)
    return o, lse


_FLASH_MODES = ("window", "alibi", "wide_group", "d80", "d96", "d256", "f16")
zero_counts(flash_fwd, *_FLASH_MODES, "f32")


def _launch_bwd(what, q, k, v, do, lse, delta, window, alibi, outs):
    """Check the arguments of a backward kernel and launch it into `outs`
    (dq, or dk and dv with the group split of `dkv_split_plan` and its f32
    scratch); returns False, launching nothing, for an empty batch or
    sequence."""
    dt = _elem_dtype(what, q)
    _check_attention_args(what, {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                                 "delta": delta},
                          {"q": dt, "k": dt, "v": dt, "do": dt, "lse": _F32, "delta": _F32},
                          q, k)
    _check_slopes(what, q, alibi)
    B, S, H, D = q.shape
    KV = k.shape[2]
    if B * S == 0:
        return False
    ptrs = [*(ptr(t) for t in outs), ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
            None if alibi is None else ptr(alibi)]
    ints = [B, S, H, KV, D, int(window)]
    if what == "flash_bwd_dkv":
        plan = dkv_split_plan(B, S, H, KV, D,
                              torch.cuda.get_device_properties(q.device).multi_processor_count)
        part = (torch.empty(plan.scratch_shape, dtype=_F32, device=q.device)
                if plan.n_chunks > 1 else None)
        ptrs.append(None if part is None else ptr(part))
        ints.append(plan.n_chunks)
    lib = _library("flash_bwd", dt)
    err = getattr(lib, what)(*ptrs, *ints, 1.0 / D ** 0.5, stream_of(q))
    build.check(lib, err, what)
    return True


def flash_bwd_dq(q, k, v, do, lse, delta, window: int = 0, alibi=None):
    """dq of causal attention (kernel #2: csrc/flash_bwd.cu), banded to
    `window` when it is > 0, ALiBi-biased by `alibi` ([H] f32 slopes) when
    given, from the forward's lse and delta = rowsum(dO * O): q, do [B, S,
    H, D], k, v [B, S, KV, D], all bf16 or all f16, lse, delta [B, H, S]
    f32, all contiguous. Returns dq [B, S, H, D] in q's dtype. CPU tensors
    take the plain version."""
    if not q.is_cuda:
        return _bwd_plain(q, k, v, lse, delta, do, window, alibi)[0]
    dq = torch.empty_like(q)
    if _launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta, window, alibi, (dq,)):
        count_launch(flash_bwd_dq, window, alibi is not None, group=q.shape[2] // k.shape[2],
                     head_dim=q.shape[3], dtype=q.dtype)
    return dq


zero_counts(flash_bwd_dq, *_FLASH_MODES)


# Kernel #3's group split: where B * KV * ceil(S / key_block) CTAs would
# leave SMs idle, each group of q heads is cut into chunks (one CTA per key
# block and chunk) until the grid holds SPLIT_WAVES CTAs an SM.
SPLIT_WAVES = 4


def dkv_key_block(D) -> int:
    """Keys a CTA of kernel #3 owns when its group is split (and at D 256
    always): 128 (two warpgroups of 64 keys), 64 at head dim 256 (one
    64-key block, its two warpgroups on dV and dK)."""
    return 64 if D > 128 else 128


class DkvSplit(NamedTuple):
    """The group split of kernel #3 (`dkv_split_plan`): `n_chunks` CTAs
    per (key block, batch, KV head); `chunks[c]` = (first, end) of chunk
    c's q heads within the group (contiguous, in order, ceil(G /
    n_chunks) each, the last possibly fewer); `scratch_shape` = [n_chunks,
    2, B, S, KV, D] f32, the chunks' partial dk and dv that the combine
    pass adds in chunk order (() when the group is not split)."""
    n_chunks: int
    chunks: Tuple[Tuple[int, int], ...]
    scratch_shape: Tuple[int, ...]

    @property
    def scratch_bytes(self) -> int:
        return 4 * math.prod(self.scratch_shape) if self.scratch_shape else 0


def dkv_split_plan(B, S, H, KV, D, sm_count) -> DkvSplit:
    """The split kernel #3 takes on a card of `sm_count` SMs: none (one
    chunk) when B * KV * ceil(S / dkv_key_block(D)) fills the card or the
    group is one head; else about SPLIT_WAVES * sm_count CTAs, the chunk
    count then cut to ceil(G / ceil(G / wanted)) so that no chunk is empty
    (the kernel gives chunk c heads c * ceil(G / n) onwards)."""
    G = H // KV
    blocks = B * KV * -(-S // dkv_key_block(D))
    n = 1
    if blocks < sm_count and G > 1:
        wanted = min(G, -(-SPLIT_WAVES * sm_count // blocks))
        n = -(-G // -(-G // wanted))
    size = -(-G // n)
    chunks = tuple((c * size, min(G, (c + 1) * size)) for c in range(n))
    return DkvSplit(n, chunks, (n, 2, B, S, KV, D) if n > 1 else ())


def flash_bwd_dkv(q, k, v, do, lse, delta, window: int = 0, alibi=None):
    """dk and dv of causal attention (kernel #3: csrc/flash_bwd.cu), each
    KV head's gradient summed over its group of query heads, each q head
    with its own ALiBi slope: in the kernel's registers, or where the
    group is split (`dkv_split_plan`) per chunk into an f32 scratch that a
    second pass adds in chunk order (no atomics either way: the same bits
    every run). Arguments as `flash_bwd_dq`. Returns (dk, dv) [B, S, KV,
    D] in q's dtype. CPU tensors take the plain version."""
    if not q.is_cuda:
        return _bwd_plain(q, k, v, lse, delta, do, window, alibi)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, window, alibi, (dk, dv)):
        count_launch(flash_bwd_dkv, window, alibi is not None, group=q.shape[2] // k.shape[2],
                     head_dim=q.shape[3], dtype=q.dtype)
    return dk, dv


zero_counts(flash_bwd_dkv, *_FLASH_MODES)


def flash_attention_bwd(q, k, v, o, lse, do, window: int = 0, alibi=None):
    """(dq, dk, dv) of causal attention from the forward's residuals: the
    two backward kernels for CUDA tensors (delta computed here, as the
    reference computes it outside its kernels), the plain version for CPU
    tensors."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, o, lse, do, window, alibi)
    delta = _delta(o, do)
    return ((flash_bwd_dq(q, k, v, do, lse, delta, window, alibi),)
            + flash_bwd_dkv(q, k, v, do, lse, delta, window, alibi))


class FlashAttention(torch.autograd.Function):
    """Causal flash attention with its backward (the reference's
    `_flash` custom VJP). forward(q, k, v, window, alibi) -> (o, lse).
    The backward takes the window and the ALiBi slopes the forward took;
    neither carries a gradient (the reference returns zeros for the
    slopes). The lse output carries none yet: a cotangent reaching it
    raises (ROADMAP B3). f32 CUDA inputs that need a gradient raise here,
    before the forward launches (ROADMAP B6's training half)."""

    @staticmethod
    def forward(ctx, q, k, v, window, alibi):
        check_no_f32_grad(q.dtype, q.is_cuda, any(ctx.needs_input_grad[:3]))
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v, window, alibi)
        ctx.save_for_backward(q, k, v, o, lse, alibi)
        ctx.window = window
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        if dlse is not None:
            raise NotImplementedError(
                "a gradient through flash_attention's lse (the reference's "
                "delta_adjust, used by ring attention) is not ported yet "
                "(ROADMAP B3, with the non-causal mode)")
        if do is None:
            return None, None, None, None, None
        q, k, v, o, lse, alibi = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.window,
                                   alibi) + (None, None)


def flash_attention(q, k, v, window: int = 0, alibi=None):
    """Causal attention: q [B, S, H, D], k/v [B, S, KV, D] (bf16 or f16 on
    the GPU; f32 without a gradient), banded to the last `window` positions when window > 0, biased
    by the [H] ALiBi slopes `alibi` when given (a tensor, array or list;
    pass an f32 tensor on q's device to spare a copy per call).
    Differentiable in q, k and v. Returns (o [B, S, H, D], lse [B, H, S]
    f32)."""
    if alibi is not None:
        alibi = torch.as_tensor(alibi, dtype=_F32, device=q.device).reshape(q.shape[2])
    return FlashAttention.apply(q, k, v, int(window), alibi)
