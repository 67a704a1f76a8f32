"""Causal flash attention, forward and backward: hand-written CUDA kernels
beside their plain PyTorch versions, joined by a `torch.autograd.Function`.

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
For CUDA tensors both directions launch the kernels (bf16) or raise; for
CPU tensors they run the plain versions (`flash_attention_plain`,
`flash_attention_bwd_plain`), which do the same recompute-from-lse math
densely in f32 (P and dS rounded to the inputs' dtype where the kernels
round them). Every kernel wrapper carries `launches`, raised by one
per launch of its kernel.

Not in this slice (ROADMAP B2): sliding windows, ALiBi and the lse
cotangent of `flash_attention_with_lse` (`delta_adjust`, used only by
ring attention): a loss that reaches lse raises in the backward.
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


def _causal_logits(q, k):
    """f32 scaled logits [B, H, S, S] with the causal mask applied (-inf)."""
    B, S, H, D = q.shape
    kf = _repeat_kv(k, H // k.shape[2]).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / D ** 0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    return logits.masked_fill(~mask, float("-inf"))


def flash_attention_plain(q, k, v):
    """Dense causal attention computed in f32 (the counterpart of the JAX
    package's _xla_attention, ops/attention.py). Returns (o in q's dtype,
    lse [B, H, S] f32)."""
    logits = _causal_logits(q, k)
    lse = torch.logsumexp(logits, dim=-1)  # [B, H, S]
    probs = torch.exp(logits - lse[..., None])
    vf = _repeat_kv(v, q.shape[2] // k.shape[2]).float()
    o = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return o.to(q.dtype), lse


def _delta(o, do):
    """rowsum(dO * O) in f32, [B, S, H, D] -> [B, H, S] (the reference
    computes it with XLA outside its kernels, flash_attention.py:406)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_plain(q, k, v, lse, delta, do):
    """Dense f32 backward from the saved lse and delta: returns dq, dk, dv
    in the inputs' dtypes, the GQA heads of each group summed into their
    KV head. P and dS are rounded to the inputs' dtype before their
    products, as the reference kernel does (`ds.astype(k.dtype)`) and as
    kernels #2 and #3 do for the tensor cores: a no-op in f32, bf16
    rounding for bf16 inputs."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / D ** 0.5
    p = torch.exp(_causal_logits(q, k) - lse[..., None].float())  # masked -> 0
    dof = do.float()
    vf = _repeat_kv(v, G).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None].float()) * scale
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _repeat_kv(k, G).float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, S, KV, G, D).sum(3)
    dv = dv.reshape(B, S, KV, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """The plain version of the flash backward: dense f32 recompute of the
    probabilities from lse (what kernels #2 and #3 compute tile by tile),
    P and dS rounded to the inputs' dtype as the kernels round them.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    return _bwd_plain(q, k, v, lse, _delta(o, do), do)


# Tolerance of a backward kernel's gradient against the plain backward on
# the same bf16 inputs (which rounds P and dS as the kernels do). What is
# left between the two: the f32 summation order, which may flip the bf16 rounding of a few P or dS entries (each
# flip moves a gradient row by 2^-8 of one of its terms, at most ~2^-6 of
# the row's RMS for unit-normal inputs), and the bf16 rounding of the
# result (one ulp: 2^-7 relative). Per element: 2^-7 of |plain| + 2^-5 of
# the plain row's RMS over the head dimension + 2^-10 of the tensor's RMS
# (rows whose exact value is 0, such as dq of the first query, hold only
# rounding noise). The atol follows each row's own scale, so a late row,
# whose gradient is ~sqrt(S) times smaller than an early one, is held as
# tightly as an early one.
BWD_RTOL, BWD_ROW_ATOL, BWD_FLOOR = 2.0 ** -7, 2.0 ** -5, 2.0 ** -10


def bwd_mismatch(got, ref):
    """Compare a backward kernel's gradient `got` with the plain version
    `ref` ([..., D], the same shape) under the tolerance above. Returns a
    dict: n_over (elements beyond it, non-finite ones included),
    worst_ratio (largest |got - ref| / limit), max_abs_err, err_rms,
    ref_rms, ref_max."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    rms = ref.square().mean().sqrt()
    limit = (BWD_RTOL * ref.abs() + BWD_ROW_ATOL * ref.square().mean(-1, keepdim=True).sqrt()
             + BWD_FLOOR * rms).clamp_min(torch.finfo(torch.float32).tiny)
    over = (err > limit) | ~torch.isfinite(got)
    return {"n_over": int(over.sum()), "worst_ratio": (err / limit).max().item(),
            "max_abs_err": err.max().item(), "err_rms": err.square().mean().sqrt().item(),
            "ref_rms": rms.item(), "ref_max": ref.abs().max().item()}


def _check_attention_args(what, tensors, dtypes, q, k):
    B, S, H, D = q.shape
    KV = k.shape[2]
    check_cuda_args(what, tensors, dtypes,
                    aligned=tuple(n for n, t in tensors.items() if t.dtype == torch.bfloat16))
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            check_shape(what, name, t, (B, H, S))
        elif name in ("k", "v", "dk", "dv"):
            check_shape(what, name, t, (B, S, KV, D))
        else:
            check_shape(what, name, t, (B, S, H, D))
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D}; the kernel is built for {_HEAD_DIMS}")
    if KV == 0 or H % KV:
        raise ValueError(f"{what}: {H} query heads are not a multiple of {KV} KV heads")


_BF16 = torch.bfloat16
_F32 = torch.float32


def flash_fwd(q, k, v):
    """Causal attention forward (kernel #1: csrc/flash_fwd.cu). q [B, S, H,
    D] bf16, k/v [B, S, KV, D] bf16, all contiguous. Returns (o [B, S, H,
    D] bf16, lse [B, H, S] f32). CPU tensors take the plain version."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v)
    what = "flash_fwd"
    _check_attention_args(what, {"q": q, "k": k, "v": v},
                          {"q": _BF16, "k": _BF16, "v": _BF16}, q, k)
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=_F32, device=q.device)
    if B * S == 0:
        return o, lse
    lib = build.load("flash_fwd")
    err = lib.flash_fwd(ptr(o), ptr(lse), ptr(q), ptr(k), ptr(v), B, S, H, k.shape[2], D,
                        1.0 / D ** 0.5, stream_of(q))
    build.check(lib, err, what)
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0

_BWD_DTYPES = {"q": _BF16, "k": _BF16, "v": _BF16, "do": _BF16, "lse": _F32, "delta": _F32}


def flash_bwd_dq(q, k, v, do, lse, delta):
    """dq of causal attention (kernel #2: csrc/flash_bwd.cu) from the
    forward's lse and delta = rowsum(dO * O): q, do [B, S, H, D] bf16, k,
    v [B, S, KV, D] bf16, lse, delta [B, H, S] f32, all contiguous.
    Returns dq [B, S, H, D] bf16. CPU tensors take the plain version."""
    if not q.is_cuda:
        return _bwd_plain(q, k, v, lse, delta, do)[0]
    what = "flash_bwd_dq"
    _check_attention_args(what, {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                                 "delta": delta}, _BWD_DTYPES, q, k)
    B, S, H, D = q.shape
    dq = torch.empty_like(q)
    if B * S == 0:
        return dq
    lib = build.load("flash_bwd")
    err = lib.flash_bwd_dq(ptr(dq), ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                           B, S, H, k.shape[2], D, 1.0 / D ** 0.5, stream_of(q))
    build.check(lib, err, what)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta):
    """dk and dv of causal attention (kernel #3: csrc/flash_bwd.cu), each
    KV head's gradient summed over its group of query heads inside the
    kernel (no atomics: the same bits every run). Arguments as
    `flash_bwd_dq`. Returns (dk, dv) [B, S, KV, D] bf16. CPU tensors take
    the plain version."""
    if not q.is_cuda:
        return _bwd_plain(q, k, v, lse, delta, do)[1:]
    what = "flash_bwd_dkv"
    _check_attention_args(what, {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                                 "delta": delta}, _BWD_DTYPES, q, k)
    B, S, H, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if B * S == 0:
        return dk, dv
    lib = build.load("flash_bwd")
    err = lib.flash_bwd_dkv(ptr(dk), ptr(dv), ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse),
                            ptr(delta), B, S, H, k.shape[2], D, 1.0 / D ** 0.5, stream_of(q))
    build.check(lib, err, what)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv) of causal attention from the forward's residuals: the
    two backward kernels for CUDA tensors (delta computed here, as the
    reference computes it outside its kernels), the plain version for CPU
    tensors."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, o, lse, do)
    delta = _delta(o, do)
    return (flash_bwd_dq(q, k, v, do, lse, delta),) + flash_bwd_dkv(q, k, v, do, lse, delta)


class FlashAttention(torch.autograd.Function):
    """Causal flash attention with its backward (the reference's
    `_flash` custom VJP). forward(q, k, v) -> (o, lse); the lse output
    carries no gradient in this slice (a cotangent reaching it raises)."""

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        if dlse is not None:
            raise NotImplementedError(
                "a gradient through flash_attention's lse (the reference's "
                "delta_adjust, used by ring attention) is not ported yet "
                "(ROADMAP B2)")
        if do is None:
            return None, None, None
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, do.contiguous())


def flash_attention(q, k, v, window: int = 0, alibi=None):
    """Causal attention, differentiable in q, k and v: q [B, S, H, D], k/v
    [B, S, KV, D] (bf16 on the GPU). Returns (o [B, S, H, D], lse [B, H, S]
    f32). The reference's sliding-window and ALiBi modes are not ported."""
    if window or alibi is not None:
        raise NotImplementedError("flash attention's sliding-window and ALiBi modes are "
                                  "not ported yet (ROADMAP B2)")
    return FlashAttention.apply(q, k, v)
