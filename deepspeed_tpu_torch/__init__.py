"""deepspeed_tpu_torch: the PyTorch + CUDA port of deepspeed_tpu for NVIDIA
Hopper GPUs (H100).

The JAX package `deepspeed_tpu` is the reference this package is held
against; the two share their module layout, so every module here has one
counterpart there. This package imports `torch` and never `jax`, and
nothing of `deepspeed_tpu`.

So far it trains and serves Llama-class models on one GPU:

    from deepspeed_tpu_torch import initialize, init_inference
    engine = initialize(ds_config, loss_fn=T.make_loss_fn(model_config),
                        param_init_fn=lambda g: T.init(model_config, g, device="cuda"))
    metrics = engine.train_batch({"tokens": tokens})
    server = init_inference(params, model_config, {"max_seq_len": 1024})

Entry points run on the GPU unless the caller passes `device="cpu"`, where
every kernel is replaced by its plain PyTorch version.
"""

from typing import Any, Callable, Dict, Optional, Union

import torch

from .config.config import DeepSpeedTPUConfig, parse_config
from .inference import InferenceConfig, InferenceEngine, init_inference
from .runtime.engine import DeepSpeedTPUEngine, TrainState
from .version import __version__


def initialize(config: Any = None, *, loss_fn: Callable, params: Any = None,
               param_init_fn: Optional[Callable] = None, param_logical_specs: Any = None,
               mesh=None, rules: Optional[Dict[str, Any]] = None, has_aux: bool = False,
               init_rng: Optional[torch.Generator] = None, pipelined: bool = False,
               pipeline_virtual_stages: Optional[int] = None,
               device: Union[str, torch.device, None] = None) -> DeepSpeedTPUEngine:
    """Build a training engine (the JAX package's `initialize`, with its
    signature plus `device`): a pure `loss_fn(params, batch, rng) -> loss`
    and either a parameter tree or `param_init_fn(generator)`, called with
    a torch.Generator on the engine's device seeded from config.seed (the
    JAX package passes a PRNG key there, so the two draw different values
    for the same seed). The engine runs on the GPU unless `device="cpu"`."""
    if params is None and param_init_fn is None:
        raise ValueError("initialize() needs `params` or `param_init_fn`")
    return DeepSpeedTPUEngine(parse_config(config), loss_fn, params,
                              param_logical_specs=param_logical_specs, mesh=mesh, rules=rules,
                              has_aux=has_aux, param_init_fn=param_init_fn, init_rng=init_rng,
                              pipelined=pipelined,
                              pipeline_virtual_stages=pipeline_virtual_stages, device=device)


__all__ = ["DeepSpeedTPUConfig", "DeepSpeedTPUEngine", "InferenceConfig", "InferenceEngine",
           "TrainState", "init_inference", "initialize", "parse_config", "__version__"]
