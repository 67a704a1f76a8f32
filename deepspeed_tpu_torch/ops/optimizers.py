"""Optimizers.

Counterpart of deepspeed_tpu/ops/optimizers.py: functional
`init(params) -> state` and `update(grads, state, params, lr, step) ->
(params, state)` pairs over parameter trees, fp32 throughout; the engine
owns the master-weight policy and hands them fp32 masters.

The update is elementwise fp32 work that XLA fuses in the JAX package;
here the moments update as `torch._foreach_*` ops over the flat leaf
lists (one multi-tensor launch per op on the GPU) and the parameters one
leaf at a time, so that the step's f32 temporaries stay the size of one
leaf. `update` works IN PLACE: it writes the new parameters into `params`
and the new moments into `state` and returns both.

fp16 training (runtime/engine.py) takes `masked_update` instead: the same
update with the learning rate and the bias corrections as 0-dim device
tensors (the engine looks them up by the device step, which only the
card knows after a skipped step) and a 0-dim bool `skip` that keeps every
parameter and moment as it was, bit for bit, where the step overflowed.
It runs leaf by leaf, in chunks of at most CHUNK elements, so that its
f32 temporaries stay small; `bias_corrections(step)` gives the host
values the engine fills its device tables with.

This slice ports Adam and AdamW; the other optimizers of the reference
(lamb, lion, adagrad, sgd, the 1-bit and 0/1 Adam families) raise
NotImplementedError (ROADMAP A4, A14).
"""

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.tree import leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, lr, step) -> (params, state)
    name: str
    # step -> (c1, c2), the bias corrections of that step as float32 values
    bias_corrections: Callable[[int], Tuple[float, float]]
    # (grads, state, params, lr, c1, c2, skip) -> (params, state), device scalars
    masked_update: Callable[..., Any]


# elements a masked update takes at a time (its f32 temporaries: four of
# this many elements, 1 GiB)
CHUNK = 1 << 26


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

    def bias_corrections(step):
        if not bias_correction:
            return 1.0, 1.0
        s = np.float32(step)
        return (float(np.float32(1.0) - np.float32(b1) ** s),
                float(np.float32(1.0) - np.float32(b2) ** s))

    @torch.no_grad()
    def update(grads, state, params, lr, step):
        c1, c2 = bias_corrections(step)
        g, m, v, p = (leaves(t) for t in (grads, state["mu"], state["nu"], params))
        g = [x.float() for x in g]
        if weight_decay != 0.0 and not adam_w_mode:
            g = torch._foreach_add(g, p, alpha=weight_decay)  # L2 mode
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        # one leaf at a time: the two f32 temporaries are then the size of
        # the largest leaf, not two copies of every parameter
        for m_i, v_i, p_i in zip(m, v, p):
            upd = (m_i / c1).div_((v_i / c2).sqrt_().add_(eps))
            if weight_decay != 0.0 and adam_w_mode:
                upd.add_(p_i, alpha=weight_decay)  # decoupled decay
            p_i.add_(upd, alpha=-lr)
        return params, state

    @torch.no_grad()
    def masked_update(grads, state, params, lr, c1, c2, skip):
        for g_i, m_i, v_i, p_i in _leaf_chunks(grads, state["mu"], state["nu"], params):
            g_i = g_i.float()
            if weight_decay != 0.0 and not adam_w_mode:
                g_i = g_i + weight_decay * p_i  # L2 mode
            m_new = m_i.mul(b1).add_(g_i, alpha=1.0 - b1)
            v_new = v_i.mul(b2).addcmul_(g_i, g_i, value=1.0 - b2)
            den = v_new.div(c2).sqrt_().add_(eps)
            upd = m_new.div(c1).div_(den)
            del den
            if weight_decay != 0.0 and adam_w_mode:
                upd.add_(p_i, alpha=weight_decay)  # decoupled decay
            torch.sub(p_i, upd.mul_(lr), out=upd)
            # where the step overflowed every leaf keeps its bits
            torch.where(skip, m_i, m_new, out=m_i)
            torch.where(skip, v_i, v_new, out=v_i)
            torch.where(skip, p_i, upd, out=p_i)
        return params, state

    return Optimizer(init, update, "adamw" if adam_w_mode else "adam", bias_corrections,
                     masked_update)


def _leaf_chunks(*trees):
    """The leaves of same-shaped trees side by side, each cut into flat
    contiguous views of at most CHUNK elements (an elementwise update on
    the pieces is the update of the whole)."""
    for xs in zip(*(leaves(t) for t in trees)):
        yield from zip(*(torch.split(x.view(-1), CHUNK) for x in xs))


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
