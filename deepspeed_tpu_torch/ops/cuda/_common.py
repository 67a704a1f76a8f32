"""Argument checks and the kernel-vs-plain tolerance shared by the kernel
wrappers."""

from typing import Sequence

import torch


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_dtypes(what: str, tensors: dict, dtypes: dict) -> None:
    """Every named tensor must have its dtype (on any device: the wrappers'
    dtype routing, testable without a card)."""
    for name, t in tensors.items():
        if t.dtype != dtypes[name]:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}, expected {dtypes[name]}")


def check_cuda_args(what: str, tensors: dict, dtypes: dict,
                    aligned: Sequence[str] = ()) -> None:
    """Every tensor must lie on one CUDA device, be contiguous and have its
    dtype; the ones named in `aligned` are read or written as 16-byte
    vectors and must start on a 16-byte boundary."""
    device = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, expected a CUDA tensor")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, others on {device}")
        check_dtypes(what, {name: t}, dtypes)
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if name in aligned and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary")


# the launch modes a wrapper may count besides `launches`: mode -> the
# wrapper attribute that counts it (ops/cuda/__init__.py names them
# "<name>[<mode>]")
MODE_COUNTERS = {"window": "window_launches", "alibi": "alibi_launches",
                 "sparse": "sparse_launches", "wide_group": "wide_group_launches",
                 "d80": "d80_launches", "d96": "d96_launches", "d256": "d256_launches",
                 "f16": "f16_launches", "f32": "f32_launches"}
# a launch whose KV heads each serve more query heads than this runs in the
# wide-group mode (Falcon-7B: 71 over one)
WIDE_GROUP = 8


def zero_counts(wrapper, *modes: str) -> None:
    """Give a wrapper its `launches` and the counters of `modes`
    (MODE_COUNTERS keys), all at 0."""
    wrapper.launches = 0
    for mode in modes:
        setattr(wrapper, MODE_COUNTERS[mode], 0)


def count_launch(wrapper, window: int = 0, alibi: bool = False, sparse: bool = False,
                 group: int = 1, head_dim: int = 0, dtype: torch.dtype = torch.bfloat16) -> None:
    """Count one kernel launch on its wrapper: `launches`, and
    `window_launches` when it ran in the sliding-window mode,
    `alibi_launches` when in the ALiBi mode, `sparse_launches` when with a
    block-sparse layout bitmap, `wide_group_launches` when a KV head
    served more than WIDE_GROUP query heads, `d80_launches`,
    `d96_launches` and `d256_launches` at head_dim 80, 96 and 256,
    `f16_launches` when its operands were f16 and `f32_launches` when
    they were f32 (`dtype`; each mode it ran in)."""
    wrapper.launches += 1
    hits = {"window": window > 0, "alibi": alibi, "sparse": sparse,
            "wide_group": group > WIDE_GROUP, "d80": head_dim == 80, "d96": head_dim == 96,
            "d256": head_dim == 256, "f16": dtype == torch.float16,
            "f32": dtype == torch.float32}
    for mode, hit in hits.items():
        if hit:
            attr = MODE_COUNTERS[mode]
            setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def check_shape(what: str, name: str, t: torch.Tensor, shape: Sequence[int]) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


# Tolerance of a kernel's output against its plain version on the same
# bf16 inputs, where the plain version rounds P and dS to bf16 where the
# kernel does (the flash backward, the evoformer forward and backward).
# What is left between the two: the f32 summation order, which may flip
# the bf16 rounding of a few P or dS entries (each flip moves an output
# row by 2^-8 of one of its terms, at most ~2^-6 of the row's RMS for
# unit-normal inputs), and the bf16 rounding of the result (one ulp: 2^-7
# relative). Per element: 2^-7 of |plain| + 2^-5 of the plain row's RMS
# over the last axis (the head dimension for o, dq, dk and dv, the keys
# for the bias gradients) + 2^-10 of the tensor's RMS (rows whose exact
# value is 0, such as flash dq of the first query, hold only rounding
# noise). The atol follows each row's own scale, so a row whose values are
# many times smaller than another's is held as tightly.
BWD_RTOL, BWD_ROW_ATOL, BWD_FLOOR = 2.0 ** -7, 2.0 ** -5, 2.0 ** -10
# The same tolerance for f16 outputs (a plain version that rounds P and dS
# to f16 where the kernel does), every term scaled by the ratio of the two
# types' unit roundoffs, 2^-11 / 2^-8 = 2^-3: one f16 ulp (2^-10
# relative), 2^-8 of the row's RMS (a flipped f16 rounding of P or dS moves
# a row by 2^-11 of one of its terms), 2^-13 of the tensor's RMS. The
# elementwise limit alone sees a kernel that rounds P or dS to bf16 only in
# the tails of a large tensor (those roundings move a row by ~2^-9.3 of its
# RMS, under the 2^-8 row term), so f16 outputs are also held to an error
# RMS of at most 2^-10 of the plain output's RMS (F16_ERR_RMS): the f16
# output rounding alone leaves ~2^-12.3, bf16 roundings of P or dS
# ~2^-9.3.
F16_RTOL, F16_ROW_ATOL, F16_FLOOR, F16_ERR_RMS = 2.0 ** -10, 2.0 ** -8, 2.0 ** -13, 2.0 ** -10


def bwd_mismatch(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Compare a kernel's output `got` with the plain version's `ref` (the
    same shape) under the tolerance above, rows taken over the last axis:
    the bf16 coefficients, or the f16 ones (and the F16_ERR_RMS bound)
    when `ref` is f16. Returns a dict: n_over (elements beyond it,
    non-finite ones included), worst_ratio (largest |got - ref| / limit),
    max_abs_err, err_rms, ref_rms, ref_max, rms_over (the f16 RMS bound
    exceeded; False for bf16) and passed (no element over and no rms_over)."""
    f16 = ref.dtype == torch.float16
    rtol, row_atol, floor = ((F16_RTOL, F16_ROW_ATOL, F16_FLOOR) if f16
                             else (BWD_RTOL, BWD_ROW_ATOL, BWD_FLOOR))
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    rms = ref.square().mean().sqrt()
    limit = (rtol * ref.abs() + row_atol * ref.square().mean(-1, keepdim=True).sqrt()
             + floor * rms).clamp_min(torch.finfo(torch.float32).tiny)
    over = (err > limit) | ~torch.isfinite(got)
    err_rms = err.square().mean().sqrt().item()
    n_over = int(over.sum())
    rms_over = f16 and not err_rms <= F16_ERR_RMS * rms.item()
    return {"n_over": n_over, "worst_ratio": (err / limit).max().item(),
            "max_abs_err": err.max().item(), "err_rms": err_rms,
            "ref_rms": rms.item(), "ref_max": ref.abs().max().item(), "rms_over": rms_over,
            "passed": n_over == 0 and not rms_over}
