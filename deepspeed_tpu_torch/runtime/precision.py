"""Mixed precision: fp16 dynamic loss scaling, the master-weight cast, the
global gradient norm and clipping, and the non-finite gradient check.

Counterpart of deepspeed_tpu/runtime/precision.py. Everything stays on the
device (no host sync): the norm, the clip factor and the loss-scale state
are 0-dim tensors, and the scaler's update is a chain of selects, so the
engine's step never reads an overflow flag on the host.
"""

from typing import NamedTuple, Union

import torch

from ..config.config import FP16Config
from ..utils.tree import leaves, tree_map


class LossScaleState(NamedTuple):
    """The dynamic loss scaler (the reference's DynamicLossScaler) as
    0-dim device tensors."""
    scale: torch.Tensor  # f32
    good_steps: torch.Tensor  # int32: overflow-free steps since the last change
    hysteresis_left: torch.Tensor  # int32: overflows still tolerated before a backoff


def init_loss_scale(cfg: FP16Config,
                    device: Union[str, torch.device, None] = None) -> LossScaleState:
    """A static `loss_scale` (> 0) or 2^initial_scale_power, no good steps,
    the full hysteresis."""
    scale = float(cfg.loss_scale) if cfg.loss_scale and cfg.loss_scale > 0 else float(
        2.0 ** cfg.initial_scale_power)
    return LossScaleState(
        scale=torch.tensor(scale, dtype=torch.float32, device=device),
        good_steps=torch.tensor(0, dtype=torch.int32, device=device),
        hysteresis_left=torch.tensor(cfg.hysteresis, dtype=torch.int32, device=device))


def update_loss_scale(state: LossScaleState, found_inf: torch.Tensor,
                      cfg: FP16Config) -> LossScaleState:
    """The reference's DynamicLossScaler.update_scale, as the JAX package
    traces it: an overflow spends one unit of hysteresis, or once it is
    down to 1 halves the scale (not below min_loss_scale); the hysteresis
    is refilled only when the scale grows (or, with
    consecutive_hysteresis, by every overflow-free step); loss_scale_window
    overflow-free steps in a row double the scale. A static scale never
    moves. `found_inf` is a 0-dim bool tensor; returns a new state."""
    if cfg.loss_scale and cfg.loss_scale > 0:
        return state
    # Python scalars, not new device tensors: no host-to-device copy a step
    full = int(cfg.hysteresis)
    exhausted = state.hysteresis_left <= 1
    scale = torch.where(found_inf & exhausted,
                        torch.clamp_min(state.scale / 2.0, cfg.min_loss_scale), state.scale)
    hyst = torch.where(found_inf & ~exhausted, state.hysteresis_left - 1, state.hysteresis_left)
    good = torch.where(found_inf, 0, state.good_steps + 1)
    if cfg.consecutive_hysteresis:
        hyst = torch.where(found_inf, hyst, full)
    grow = good >= cfg.loss_scale_window
    scale = torch.where(grow, scale * 2.0, scale)
    hyst = torch.where(grow, full, hyst)
    good = torch.where(grow, 0, good)
    return LossScaleState(scale=scale, good_steps=good, hysteresis_left=hyst)


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
