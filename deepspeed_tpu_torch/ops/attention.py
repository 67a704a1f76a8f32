"""Attention ops.

Counterpart of deepspeed_tpu/ops/attention.py. Layout is [batch, seq,
heads, head_dim]; GQA KV heads are consumed in place by the flash kernels
and repeated only by the plain path.

`causal_attention` with use_flash=True goes through the flash attention
`torch.autograd.Function` at every length: forward and backward kernels
for CUDA tensors, their plain versions (the same recompute-from-lse
backward) for CPU tensors, differentiable on both. (The JAX package sends
S < 256 to XLA; that threshold was a TPU tiling choice, and on the card
plain attention is never the main path.) use_flash=False runs the dense
plain forward on any device, differentiated by autograd: the reference
the kernel path is compared with. window > 0 is the token-exact sliding
window (Mistral-class) on both paths.
"""

import torch

from .cuda.flash_attention import _repeat_kv, flash_attention, flash_attention_plain

__all__ = ["_repeat_kv", "causal_attention"]


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     use_flash: bool = True, window: int = 0) -> torch.Tensor:
    """Causal self-attention, [B,S,H,D] x [B,S,KV,D] -> [B,S,H,D]; window >
    0: each query attends to the last `window` positions, itself included."""
    if use_flash:
        return flash_attention(q, k, v, window=window)[0]
    return flash_attention_plain(q, k, v, window)[0]
