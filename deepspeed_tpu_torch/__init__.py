"""deepspeed_tpu_torch: the PyTorch + CUDA port of deepspeed_tpu for NVIDIA
Hopper GPUs (H100).

The JAX package `deepspeed_tpu` is the reference this package is held
against; the two share their module layout, so every module here has one
counterpart there. This package imports `torch` and never `jax`, and
nothing of `deepspeed_tpu`.

This slice serves Llama-class models on one GPU:

    from deepspeed_tpu_torch import init_inference
    engine = init_inference(params, model_config, {"max_seq_len": 1024})

Entry points run on the GPU unless the caller passes `device="cpu"`, where
every kernel is replaced by its plain PyTorch version.
"""

from .inference import InferenceConfig, InferenceEngine, init_inference
from .version import __version__

__all__ = ["InferenceConfig", "InferenceEngine", "init_inference", "__version__"]
