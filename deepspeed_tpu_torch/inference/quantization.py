"""Weight-only quantization for serving: groupwise (the memory path) and
per-channel int8 (the speed path).

Counterpart of deepspeed_tpu/inference/quantization.py, whose parameter
trees are pytrees; here a tree is nested dicts and lists of tensors, and
the two weight classes are small holders of tensors.

- `QuantizedWeight` (groupwise int8/int4): codes of the weight's shape
  (int4 packed two to a byte on the last dim) and f32 scales, one per
  group of the last dim. The engine dequantizes the whole tree at the
  entry of each program (`dequantize_tree`), as the JAX engine does in
  each compiled step: resident bytes shrink, each step rebuilds the
  full-precision view.
- `ChannelQuantWeight` (per-channel int8): one f32 scale per output
  channel, constant along the contraction, so a product takes the codes
  straight and applies the scale to its output (inference/model.py
  `_wmm`). On the card that product is the hand-written W8A16 GEMM
  (ops/cuda/int8_matmul.py), which streams the int8 codes: no bf16 copy
  of a weight is ever made.

Layout. The JAX package keeps a ChannelQuantWeight's codes in the
weight's own shape and its scale in the shape of the consuming einsum's
output dims. The port keeps the codes as one [N, K] matrix, output
channels by contraction (K contiguous), and the scales as [N]: the layout
the kernel reads, and the one the tied embedding already has ([V, E],
one scale a row, `scale_first`), whose rows the embedding lookup
gathers. `shape` and `ndim` are the JAX layout's; `codes()` and
`scales()` give the codes and scales in that layout.

Codes and scales equal the JAX engine's bit for bit: scale = absmax x
f32(1/127), as XLA computes absmax / 127 under jit (ops/quantization.py).
"""

import dataclasses
import math
from typing import Any, Tuple

import torch

from ..ops.quantization import (
    INT8_QMAX,
    absmax_scale,
    dequantize_groupwise,
    pack_int4,
    quantize_groupwise,
    round_codes,
    unpack_int4,
)
from ..utils.logging import logger
from ..utils.tree import leaves, tree_map, tree_map_with_path


@dataclasses.dataclass
class QuantizedWeight:
    """One weight stored groupwise-quantized (the reference's
    QuantizedParameter)."""

    q: torch.Tensor      # int8 codes; int4: packed 2 a byte on the last dim
    scale: torch.Tensor  # f32 group scales [..., n_groups]
    bits: int
    dtype_name: str

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    def dequantize(self) -> torch.Tensor:
        q = unpack_int4(self.q) if self.bits == 4 else self.q
        return dequantize_groupwise(q, self.scale, self.dtype)

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes


@dataclasses.dataclass
class ChannelQuantWeight:
    """A per-output-channel int8 weight (see the module docstring): q
    int8 [N, K], scale f32 [N]; `jax_shape` the weight's shape in the JAX
    layout, its leading `contract_ndim` dims contracted (the output dims
    after them), or with `scale_first` its first dim the output (the
    embedding's rows); `dtype_name` the serving compute dtype."""

    q: torch.Tensor
    scale: torch.Tensor
    jax_shape: Tuple[int, ...]
    contract_ndim: int = 1
    scale_first: bool = False
    dtype_name: str = "bfloat16"

    @property
    def nbytes(self) -> int:
        return self.q.nbytes + self.scale.nbytes

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.jax_shape

    @property
    def ndim(self) -> int:
        return len(self.jax_shape)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    @property
    def out_shape(self) -> Tuple[int, ...]:
        """The output channels' dims (the product's trailing dims)."""
        if self.scale_first:
            return self.jax_shape[:1]
        return self.jax_shape[self.contract_ndim:]

    def codes(self) -> torch.Tensor:
        """The codes in the JAX layout (the weight's shape)."""
        q = self.q if self.scale_first else self.q.t()
        return q.reshape(self.jax_shape)

    def scales(self) -> torch.Tensor:
        """The scales in the JAX layout (the output channels' dims)."""
        return self.scale.reshape(self.out_shape)

    @classmethod
    def from_codes(cls, q: torch.Tensor, scale: torch.Tensor, contract_ndim: int = 1,
                   scale_first: bool = False,
                   dtype_name: str = "bfloat16") -> "ChannelQuantWeight":
        """From codes and scales in the JAX layout (q of the weight's
        shape, scale of its output dims), e.g. a JAX prepared tree's."""
        return cls(q=_kernel_layout(q, contract_ndim, scale_first).contiguous(),
                   scale=scale.reshape(-1).float().contiguous(), jax_shape=tuple(q.shape),
                   contract_ndim=contract_ndim, scale_first=scale_first, dtype_name=dtype_name)


def _kernel_layout(w: torch.Tensor, contract_ndim: int, scale_first: bool) -> torch.Tensor:
    """A weight in the JAX layout as [N, K]: output channels by
    contraction (a view where it can be)."""
    if scale_first:
        return w.reshape(w.shape[0], -1)
    return w.reshape(math.prod(w.shape[:contract_ndim]), -1).t()


def _dtype_name(w: torch.Tensor) -> str:
    return str(w.dtype).split(".")[-1]


def channel_quantize(w: torch.Tensor, contract_ndim: int,
                     scale_first: bool = False) -> ChannelQuantWeight:
    """Quantize one weight to int8 with a scale per output channel.

    contract_ndim: how many LEADING dims the consuming product contracts
    (they share one scale). scale_first=True instead scales over the
    FIRST dim (the embedding's rows). The codes land in the kernel layout
    [N, K] (see ChannelQuantWeight)."""
    w2 = _kernel_layout(w.float(), contract_ndim, scale_first)
    scale = absmax_scale(w2.abs().amax(dim=1), INT8_QMAX)
    q = round_codes(w2, scale[:, None], INT8_QMAX)
    return ChannelQuantWeight(q=q.contiguous(), scale=scale, jax_shape=tuple(w.shape),
                              contract_ndim=contract_ndim, scale_first=scale_first,
                              dtype_name=_dtype_name(w))


def quantize_for_inference(params: Any, bits: int = 8, group_size: int = 128,
                           min_ndim: int = 2) -> Any:
    """Quantize every floating leaf with ndim >= min_ndim groupwise (the
    products' weights and the embeddings; norm scales and biases stay full
    precision). int4 leaves an odd last dim full precision; a group size
    that does not divide the last dim gives one scale per row."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    skipped, widened = [], []

    def leaf(name, p):
        if not (isinstance(p, torch.Tensor) and p.is_floating_point() and p.ndim >= min_ndim):
            return p
        if bits == 4 and p.shape[-1] % 2:
            skipped.append(name)  # int4 packing needs an even last dim
            return p
        if group_size and p.shape[-1] % group_size:
            widened.append(name)
        q, s = quantize_groupwise(p, group_size, bits)
        if bits == 4:
            q = pack_int4(q)
        return QuantizedWeight(q=q, scale=s, bits=bits, dtype_name=_dtype_name(p))

    out = tree_map_with_path(leaf, params)
    if skipped:
        logger.warning(
            f"int4 PTQ left {len(skipped)} odd-last-dim leaves full precision "
            f"(resident memory larger than 4x-reduced): {skipped[:5]}...")
    if widened:
        logger.warning(
            f"PTQ group_size {group_size} does not divide the last dim of "
            f"{len(widened)} leaves; using one scale per row there: {widened[:5]}")
    return out


def dequantize_tree(params: Any) -> Any:
    """Every QuantizedWeight replaced by its full-precision tensor (the
    engine calls it at each program's entry)."""
    return tree_map(lambda x: x.dequantize() if isinstance(x, QuantizedWeight) else x, params)


def quantized_nbytes(params: Any) -> int:
    """Bytes of every leaf: codes and scales of the quantized ones."""
    return sum(x.nbytes for x in leaves(params) if hasattr(x, "nbytes"))
