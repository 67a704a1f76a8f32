"""Argument checks shared by the kernel wrappers."""

from typing import Sequence

import torch


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
        if t.dtype != dtypes[name]:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}, expected {dtypes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if name in aligned and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary")


def check_shape(what: str, name: str, t: torch.Tensor, shape: Sequence[int]) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
