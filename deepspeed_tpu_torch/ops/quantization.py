"""Block and group quantization (int8/int4) of tensors, in torch ops.

Counterpart of deepspeed_tpu/ops/quantization.py: the functions the
groupwise weight quantization of inference/quantization.py stands on.
Symmetric absmax scaling, q = round(x / scale) clamped to [-qmax, qmax],
scale = absmax / qmax (1 where absmax is 0).

The JAX package computes these inside jit, where XLA turns the division
of absmax by the constant qmax into a multiplication by its f32
reciprocal; the port multiplies the same way, so that codes and scales
are those the JAX engine serves, bit for bit. The division of x by its
scale stays a true division there and here. (Outside jit, JAX divides
absmax by qmax, which rounds a scale differently now and then: ROADMAP C,
contract notes.)

The comm-compression functions (quantize_per_axis, quantize_dequantize)
come with the slice that ports ZeRO++'s quantized collectives.
"""

from typing import Tuple

import torch

INT8_QMAX = 127.0
INT4_QMAX = 7.0


def _qmax(bits: int) -> float:
    return INT8_QMAX if bits == 8 else INT4_QMAX


def absmax_scale(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    """absmax / qmax as XLA computes it under jit (a multiplication by the
    f32 reciprocal), 1 where absmax is not > 0 (zero, or NaN)."""
    scale = absmax * torch.tensor(1.0 / qmax, dtype=torch.float32)
    return torch.where(absmax > 0, scale, torch.ones_like(scale))


def round_codes(x: torch.Tensor, scale: torch.Tensor, qmax: float) -> torch.Tensor:
    """clamp(round_half_even(x / scale), -qmax, qmax) as int8 (a NaN
    quotient converts to 0)."""
    return torch.round(x / scale).clamp(-qmax, qmax).to(torch.int8)


def _pad_to_blocks(x: torch.Tensor, block: int):
    n = x.numel()
    nblk = max((n + block - 1) // block, 1)
    flat = x.reshape(-1)
    pad = nblk * block - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(nblk, block), n


def quantize_blockwise(x: torch.Tensor, block: int = 2048,
                       bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 codes [nblk, block], f32 scales [nblk])."""
    qmax = _qmax(bits)
    blocks, _ = _pad_to_blocks(x.float(), block)
    scale = absmax_scale(blocks.abs().amax(dim=1), qmax)
    return round_codes(blocks, scale[:, None], qmax), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(codes, scales) -> a dense tensor of `shape` (inverse of
    quantize_blockwise)."""
    n = 1
    for d in shape:
        n *= int(d)
    x = (q.float() * scale[:, None]).reshape(-1)[:n]
    return x.reshape(tuple(shape)).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., 2k] int8 codes in [-7, 7] -> [..., k] bytes, two codes each
    (even index in the low nibble)."""
    lo = q[..., 0::2].to(torch.int16) & 0x0F
    hi = q[..., 1::2].to(torch.int16) & 0x0F
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4 (the nibbles sign-extended)."""
    u = p.view(torch.uint8).to(torch.int16)
    lo, hi = u & 0x0F, (u >> 4) & 0x0F
    sext = lambda v: torch.where(v >= 8, v - 16, v)
    out = torch.stack([sext(lo), sext(hi)], dim=-1).to(torch.int8)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2)


def quantize_groupwise(x: torch.Tensor, group_size: int = 128,
                       bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric quantization along the last dim: codes of x's
    shape (int8 storage) and f32 scales x.shape[:-1] + [n_groups]. A group
    size that does not divide the last dim gives one scale per row."""
    qmax = _qmax(bits)
    last = x.shape[-1]
    g = group_size if group_size and last % group_size == 0 else last
    xg = x.float().reshape(*x.shape[:-1], last // g, g)
    scale = absmax_scale(xg.abs().amax(dim=-1), qmax)
    return round_codes(xg, scale[..., None], qmax).reshape(x.shape), scale


def dequantize_groupwise(q: torch.Tensor, scale: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """codes x their group's f32 scale, rounded once to `dtype` (the JAX
    package's f32 product, then astype), in one pass that writes only the
    `dtype` result: no f32 copy of the codes (a Mixtral-8x7B expert stack
    is 0.47 G codes)."""
    last, n = q.shape[-1], scale.shape[-1]
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    grouped = (*q.shape[:-1], n, last // n)
    torch.mul(q.reshape(grouped), scale[..., None], out=out.view(grouped))
    return out
