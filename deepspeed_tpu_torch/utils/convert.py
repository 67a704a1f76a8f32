"""Parameters of the JAX package -> parameters of the port.

`params_from_numpy` takes a model's parameters as the JAX package's
models/transformer.init lays them out (the training layout: a dict of
arrays, the per-layer weights stacked under "layers" on a leading
[n_layers] dim), given as numpy arrays, e.g. `jax.tree.map(np.asarray,
params)`, and returns the port's dict of tensors with the same leaf names,
shapes and values. Both packages use the same math on the same layout, so
this is a leaf-for-leaf copy; every leaf's shape is checked against
models/transformer._param_shapes and a missing, extra or misshapen leaf
raises.
"""

from typing import Any, Dict, Union

import numpy as np
import torch

from ..models import transformer as T
from ..platform.accelerator import resolve_device


def params_from_numpy(tree: Dict[str, Any], cfg: T.TransformerConfig,
                      device: Union[str, torch.device, None] = None,
                      dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Convert a numpy parameter tree (training layout) to tensors on
    `device` (None = the GPU) in `dtype`. Arrays in a 16-bit float type
    numpy cannot name (bfloat16) should arrive as float32."""
    device = resolve_device(device)
    want = T._param_shapes(cfg)
    flat = {k: v for k, v in tree.items() if k != "layers"}
    flat.update({f"layers/{k}": v for k, v in tree.get("layers", {}).items()})
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree does not match the config: missing "
                         f"{missing}, unexpected {extra}")
    out: Dict[str, Any] = {"layers": {}}
    for path, arr in flat.items():
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(want[path]):
            raise ValueError(f"{path}: shape {a.shape}, expected {want[path]}")
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        t = t.to(device=device, dtype=dtype)
        if path.startswith("layers/"):
            out["layers"][path[len("layers/"):]] = t
        else:
            out[path] = t
    return out


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `params_from_numpy` for any tree of tensors
    (parameters, gradients, optimizer moments): the same nesting with
    float32 numpy arrays as leaves, e.g. to hold them against a JAX tree."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().to("cpu", torch.float32).numpy()
