"""Hand-written CUDA kernels (csrc/*.cu) and their wrappers.

`WRAPPERS` maps each kernel's name to its wrapper; every wrapper carries a
plain integer `launches`, raised by one per kernel launch, so a run can
show that its main path went through the kernels (`_common.count_launch`).
The wrappers that take a sliding `window` also carry `window_launches`,
raised by one per launch in that mode (window > 0), counted as
"<name>[window]"; `WINDOW_MODES` names them. Those that take ALiBi slopes
carry `alibi_launches`, counted as "<name>[alibi]"; `ALIBI_MODES` names
them. Those that take a block-sparse layout bitmap carry
`sparse_launches`, counted as "<name>[sparse]"; `SPARSE_MODES` names them.
A launch in several modes counts in each.
"""

from typing import Dict

from . import evoformer_attention as _evo
from . import flash_attention as _flash
from . import paged_attention as _paged

WRAPPERS = {
    "paged_kv_write": _paged.paged_kv_write,
    "paged_decode_fused": _paged.paged_decode_fused,
    "paged_decode_attention": _paged.paged_decode_attention,
    "paged_kv_write_int8": _paged.paged_kv_write_int8,
    "paged_decode_fused_int8": _paged.paged_decode_fused_int8,
    "paged_decode_attention_int8": _paged.paged_decode_attention_int8,
    "flash_fwd": _flash.flash_fwd,
    "flash_bwd_dq": _flash.flash_bwd_dq,
    "flash_bwd_dkv": _flash.flash_bwd_dkv,
    "evoformer_fwd": _evo.evoformer_fwd,
    "evoformer_bwd_dq": _evo.evoformer_bwd_dq,
    "evoformer_bwd_dkv": _evo.evoformer_bwd_dkv,
    "evoformer_bwd_db2": _evo.evoformer_bwd_db2,
}


WINDOW_MODES = tuple(name for name, fn in WRAPPERS.items() if hasattr(fn, "window_launches"))
ALIBI_MODES = tuple(name for name, fn in WRAPPERS.items() if hasattr(fn, "alibi_launches"))
SPARSE_MODES = tuple(name for name, fn in WRAPPERS.items() if hasattr(fn, "sparse_launches"))


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def window_launch_counts() -> Dict[str, int]:
    """"<name>[window]" -> launches in the sliding-window mode (each also
    counted in launch_counts()[name])."""
    return {f"{name}[window]": WRAPPERS[name].window_launches for name in WINDOW_MODES}


def alibi_launch_counts() -> Dict[str, int]:
    """"<name>[alibi]" -> launches in the ALiBi mode (each also counted in
    launch_counts()[name])."""
    return {f"{name}[alibi]": WRAPPERS[name].alibi_launches for name in ALIBI_MODES}


def sparse_launch_counts() -> Dict[str, int]:
    """"<name>[sparse]" -> launches with a layout bitmap (each also counted
    in launch_counts()[name])."""
    return {f"{name}[sparse]": WRAPPERS[name].sparse_launches for name in SPARSE_MODES}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for name in WINDOW_MODES:
        WRAPPERS[name].window_launches = 0
    for name in ALIBI_MODES:
        WRAPPERS[name].alibi_launches = 0
    for name in SPARSE_MODES:
        WRAPPERS[name].sparse_launches = 0
