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
window (Mistral-class) on both paths; `alibi` [H] slopes (Bloom-class)
bias every score by slope_h * (key_pos - query_pos), alone or with a
window, on both paths and in both directions (the flash backward kernels
recompute P with the bias; the dense path is differentiated through it).
"""

import math

import torch

from .cuda.flash_attention import _repeat_kv, flash_attention, flash_attention_plain

__all__ = ["_repeat_kv", "alibi_slopes", "causal_attention"]


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """Per-head ALiBi slopes [H] f32 on the CPU (Press et al., arXiv
    2108.12409; the JAX package's alibi_slopes, bit for bit). A power-of-two
    head count takes the geometric ladder from 2^(-8/n); any other count
    takes the ladder of the power of two below it plus every other entry
    of the doubled ladder."""
    def ladder(n: int):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if math.log2(n_heads).is_integer():
        s = ladder(n_heads)
    else:
        c = 2 ** math.floor(math.log2(n_heads))
        s = ladder(c) + ladder(2 * c)[0::2][: n_heads - c]
    return torch.tensor(s, dtype=torch.float32)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     use_flash: bool = True, window: int = 0,
                     alibi: torch.Tensor = None) -> torch.Tensor:
    """Causal self-attention, [B,S,H,D] x [B,S,KV,D] -> [B,S,H,D]; window >
    0: each query attends to the last `window` positions, itself included;
    alibi: [H] f32 slopes on q's device (None: no bias)."""
    if use_flash:
        return flash_attention(q, k, v, window=window, alibi=alibi)[0]
    return flash_attention_plain(q, k, v, window, alibi)[0]
