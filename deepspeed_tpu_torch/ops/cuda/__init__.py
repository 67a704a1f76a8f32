"""Hand-written CUDA kernels (csrc/*.cu) and their wrappers.

`WRAPPERS` maps each kernel's name to its wrapper; every wrapper carries a
plain integer `launches`, raised by one per kernel launch, so a run can
show that its main path went through the kernels.
"""

from typing import Dict

from . import flash_attention as _flash
from . import paged_attention as _paged

WRAPPERS = {
    "paged_kv_write": _paged.paged_kv_write,
    "paged_decode_fused": _paged.paged_decode_fused,
    "paged_decode_attention": _paged.paged_decode_attention,
    "flash_fwd": _flash.flash_fwd,
    "flash_bwd_dq": _flash.flash_bwd_dq,
    "flash_bwd_dkv": _flash.flash_bwd_dkv,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
