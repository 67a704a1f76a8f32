"""Device resolution and the GPU peaks that bounds are computed from.

Counterpart of deepspeed_tpu/platform/accelerator.py. Entry points of the
port run on the GPU by default: `resolve_device(None)` is `cuda`, and it
raises when no CUDA device is present instead of carrying on on the CPU.
The CPU runs only when a caller asks for it (`device="cpu"`), and there
every kernel is replaced by its plain PyTorch version.
"""

from typing import Optional, Tuple, Union

import torch

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense,
# without sparsity, at the full 700 W power limit).
H100_SXM = {
    "bf16_flops_per_s": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """`None` means the GPU. Raises when the GPU is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def device_name(device: Union[str, torch.device, None] = None) -> str:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def hbm_per_device(device: Union[str, torch.device, None] = None) -> int:
    """Device memory in bytes: the budget the serving scheduler checks the
    warmup footprints against. The CPU reports the JAX package's 16 GiB
    default."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return 16 * 2**30


def bound_ms(n_bytes: float, n_flops: float,
             peaks: Optional[dict] = None) -> Tuple[float, str]:
    """Least time (ms) the card could take for work that must move
    `n_bytes` and do `n_flops` bf16 operations: the larger of the two
    times at the card's peak rates, and which of them binds."""
    p = peaks or H100_SXM
    t_bytes = n_bytes / p["hbm_bytes_per_s"]
    t_ops = n_flops / p["bf16_flops_per_s"]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"
