"""The gating helpers of deepspeed_tpu/moe/sharded_moe.py that the dropless
serving path stands on: one-hot, the load-balance loss and noisy gating.

The capacity-factor paths (top1/top2/topk gating, moe_ffn, the expert
all-to-all frame) come with MoE training (ROADMAP A2/A13). Gate math runs
in f32, as there.
"""

from typing import Optional

import torch


def _one_hot(x: torch.Tensor, n: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [...] int -> [..., n] (jax.nn.one_hot: a comparison, so no value is
    read on the host and a CUDA graph captures it; out-of-range ids give
    a zero row)."""
    return (x[..., None] == torch.arange(n, device=x.device, dtype=x.dtype)).to(dtype)


def _load_balance_loss(gates: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """l_aux = E * sum_e mean_t(gate_e) * mean_t(assigned_e), 1.0 at uniform
    (ref: sharded_moe.py top1gating l_aux)."""
    num_experts = gates.shape[-1]
    me = gates.mean(dim=0)
    ce = mask.float().mean(dim=0)
    return num_experts * (me * ce).sum()


def _apply_noise(logits: torch.Tensor, rng: Optional[torch.Generator],
                 policy: Optional[str]) -> torch.Tensor:
    """Noisy gating (ref: sharded_moe.py multiplicative_jitter / RSample
    noisy_gate_policy). No-op when rng is None (eval) or policy unset. The
    draws come from a torch.Generator, so they differ from the JAX
    package's for the same seed; one replicated draw per call, as there."""
    if rng is None or policy is None:
        return logits
    if policy == "RSample":
        return logits + torch.randn(logits.shape, generator=rng, device=rng.device,
                                    dtype=logits.dtype).to(logits.device)
    if policy == "Jitter":
        eps = 1e-2
        u = torch.rand(logits.shape, generator=rng, device=rng.device, dtype=logits.dtype)
        return logits * (u * (2 * eps) + (1.0 - eps)).to(logits.device)
    raise ValueError(f"unknown noisy_gate_policy {policy!r}")
