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

It also takes a PREPARED tree (the serving layout of the JAX package's
inference/model.py prepare: "layers" a list of per-layer dicts), whose
leaves may be the JAX package's quantized weights with numpy fields
(`jax.tree.map(np.asarray, prepared)` keeps their classes): a
ChannelQuantWeight becomes the port's (inference/quantization.py; codes
moved to the port's [N, K] layout, the embedding's scaled per row), a
QuantizedWeight the port's, with the same codes and scales. The port then
serves the very codes the JAX package made, e.g. a model built layer by
layer straight into int8.
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
    if isinstance(tree.get("layers"), (list, tuple)):
        return _prepared_from_numpy(tree, cfg, device, dtype)
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


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(np.array(a)).to(device)
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=dtype)


def _prepared_from_numpy(tree, cfg, device, dtype) -> Dict[str, Any]:
    from ..inference.quantization import ChannelQuantWeight, QuantizedWeight

    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"prepared tree has {len(tree['layers'])} layers, the config "
                         f"{cfg.n_layers}")

    def leaf(name, x):
        if not (hasattr(x, "q") and hasattr(x, "scale")):
            return _tensor(x, device, dtype)
        q = _tensor(x.q, device, dtype)
        scale = _tensor(x.scale, device, torch.float32)
        if hasattr(x, "bits"):  # groupwise
            return QuantizedWeight(q=q, scale=scale, bits=int(x.bits),
                                   dtype_name=str(x.dtype_name))
        return ChannelQuantWeight.from_codes(q, scale, contract_ndim=q.dim() - scale.dim(),
                                             scale_first=name == "embed",
                                             dtype_name=str(x.dtype_name))

    out = {k: leaf(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: leaf(k, v) for k, v in lp.items()} for lp in tree["layers"]]
    return out


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `params_from_numpy` for any tree of tensors
    (parameters, gradients, optimizer moments): the same nesting with
    float32 numpy arrays as leaves, e.g. to hold them against a JAX tree."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().to("cpu", torch.float32).numpy()
