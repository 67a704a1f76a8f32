"""Mixed precision: the master-weight cast, the global gradient norm and
clipping, and the non-finite gradient check.

Counterpart of deepspeed_tpu/runtime/precision.py. Everything stays on the
device (no host sync): the norm and the clip factor are 0-dim tensors.
fp16 dynamic loss scaling (LossScaleState, update_loss_scale) comes with a
later slice; the engine raises for fp16.
"""

import torch

from ..utils.tree import leaves, tree_map


def cast_params(params, dtype: torch.dtype):
    """Cast float leaves only (integer leaves untouched); a leaf already in
    `dtype` is returned as is, not copied."""
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p, params)


def found_inf_in_grads(grads) -> torch.Tensor:
    """True (a 0-dim bool tensor) when any float leaf holds an inf or a
    NaN; integer leaves are always finite, and an empty tree reports
    False."""
    flat = [g for g in leaves(grads) if g.is_floating_point()]
    if not flat:
        return torch.tensor(False)
    return torch.stack([~torch.isfinite(g).all() for g in flat]).any()


def global_grad_norm(grads) -> torch.Tensor:
    """L2 norm over the whole gradient tree, in float32."""
    norms = torch._foreach_norm([g.float() for g in leaves(grads)])
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def clip_grads_by_global_norm(grads, max_norm: float, grad_norm: torch.Tensor):
    """Scale every gradient IN PLACE by min(1, max_norm / (norm + 1e-6));
    nothing when max_norm <= 0. Returns `grads`."""
    if max_norm <= 0:
        return grads
    factor = torch.clamp(max_norm / (grad_norm + 1e-6), max=1.0)
    torch._foreach_mul_(leaves(grads), factor)
    return grads
