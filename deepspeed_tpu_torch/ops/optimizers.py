"""Optimizers.

Counterpart of deepspeed_tpu/ops/optimizers.py: functional
`init(params) -> state` and `update(grads, state, params, lr, step) ->
(params, state)` pairs over parameter trees, fp32 throughout; the engine
owns the master-weight policy and hands them fp32 masters.

The update is elementwise fp32 work that XLA fuses in the JAX package;
here it runs as `torch._foreach_*` ops over the flat leaf lists (one
multi-tensor launch per op on the GPU). `update` works IN PLACE: it
writes the new parameters into `params` and the new moments into `state`
and returns both.

This slice ports Adam and AdamW; the other optimizers of the reference
(lamb, lion, adagrad, sgd, the 1-bit and 0/1 Adam families) raise
NotImplementedError (ROADMAP A4, A14).
"""

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..utils.tree import leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, lr, step) -> (params, state)
    name: str


def _zeros_like_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def adam(betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
         adam_w_mode: bool = True, bias_correction: bool = True) -> Optimizer:
    """Adam / AdamW with the reference FusedAdam's knobs: L2 decay added to
    the gradient (adam_w_mode=False) or decoupled decay added to the update
    (True); bias correction 1 - beta^step in float32."""
    b1, b2 = betas

    def init(params):
        return {"mu": _zeros_like_f32(params), "nu": _zeros_like_f32(params)}

    @torch.no_grad()
    def update(grads, state, params, lr, step):
        if bias_correction:
            s = np.float32(step)
            c1 = float(np.float32(1.0) - np.float32(b1) ** s)
            c2 = float(np.float32(1.0) - np.float32(b2) ** s)
        else:
            c1 = c2 = 1.0
        g, m, v, p = (leaves(t) for t in (grads, state["mu"], state["nu"], params))
        g = [x.float() for x in g]
        if weight_decay != 0.0 and not adam_w_mode:
            g = torch._foreach_add(g, p, alpha=weight_decay)  # L2 mode
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        denom = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m, c1)
        torch._foreach_div_(upd, denom)
        if weight_decay != 0.0 and adam_w_mode:
            torch._foreach_add_(upd, p, alpha=weight_decay)  # decoupled decay
        torch._foreach_add_(p, upd, alpha=-lr)
        return params, state

    return Optimizer(init, update, "adamw" if adam_w_mode else "adam")


_REGISTRY: Dict[str, Callable[..., Optimizer]] = {
    "adam": lambda **kw: adam(adam_w_mode=False, **kw),
    "adamw": lambda **kw: adam(adam_w_mode=True, **kw),
    "fusedadam": lambda **kw: adam(**kw),  # reference name compat
}
_LATER = ("lamb", "lion", "adagrad", "sgd", "onebitadam", "onebitlamb", "zerooneadam",
          "zoadam")


def build_optimizer(type_name: str, params: Optional[Dict[str, Any]] = None) -> Optimizer:
    """Build from the config's optimizer block. The 'lr' key belongs to
    the schedule, not the optimizer."""
    key = type_name.lower().replace("_", "")
    if key in _LATER:
        raise NotImplementedError(
            f"optimizer '{type_name}' is not ported yet (ROADMAP A4; the 1-bit "
            "and 0/1 Adam families with compressed comm, A14); this slice has "
            f"{sorted(_REGISTRY)}")
    if key not in _REGISTRY:
        raise ValueError(f"unknown optimizer '{type_name}'; available: {sorted(_REGISTRY)}")
    kwargs = dict(params or {})
    for k in ("lr", "torch_adam", "cuda_aware", "comm_backend_name"):
        kwargs.pop(k, None)
    if "betas" in kwargs:
        kwargs["betas"] = tuple(kwargs["betas"])
    return _REGISTRY[key](**kwargs)
