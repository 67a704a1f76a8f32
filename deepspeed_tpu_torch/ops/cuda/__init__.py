"""Hand-written CUDA kernels (csrc/*.cu) and their wrappers.

`WRAPPERS` maps each kernel's name to its wrapper; every wrapper carries a
plain integer `launches`, raised by one per kernel launch, so a run can
show that its main path went through the kernels (`_common.count_launch`).
A wrapper that runs a kernel in a further mode also carries that mode's
counter (`_common.MODE_COUNTERS`), raised by one per launch in the mode
and counted as "<name>[<mode>]": `window_launches` (a sliding window > 0),
`alibi_launches` (ALiBi slopes), `sparse_launches` (a block-sparse layout
bitmap), `wide_group_launches` (more than 8 query heads per KV head),
`d80_launches` (head_dim 80: Phi-2), `d96_launches` (head_dim 96:
GPT-NeoX-20B), `d256_launches` (head_dim 256: GPT-J-6B; the head-dim
counters on the flash kernels #1-#3 and the serving kernels #4-#6) and
`f16_launches` (f16 operands: the flash kernels #1-#3 of fp16 training).
`MODES[mode]` names the wrappers with that
counter, `mode_launch_counts(mode)` gives their counts. A launch in
several modes counts in each.
"""

from typing import Dict

from . import evoformer_attention as _evo
from . import flash_attention as _flash
from . import grouped_gemm as _grouped_gemm
from . import int8_matmul as _int8_matmul
from . import paged_attention as _paged
from ._common import MODE_COUNTERS

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
    "int8_matmul": _int8_matmul.int8_matmul,
    "grouped_gemm": _grouped_gemm.grouped_gemm,
    "grouped_gemm_int8": _grouped_gemm.grouped_gemm_int8,
}

MODES = {mode: tuple(name for name, fn in WRAPPERS.items() if hasattr(fn, attr))
         for mode, attr in MODE_COUNTERS.items()}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def mode_launch_counts(mode: str) -> Dict[str, int]:
    """"<name>[<mode>]" -> launches in that mode (each also counted in
    launch_counts()[name])."""
    attr = MODE_COUNTERS[mode]
    return {f"{name}[{mode}]": getattr(WRAPPERS[name], attr) for name in MODES[mode]}


def all_launch_counts() -> Dict[str, int]:
    """Every wrapper's launches and every mode's, "<name>[<mode>]"."""
    out = launch_counts()
    for mode in MODES:
        out.update(mode_launch_counts(mode))
    return out


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for mode, attr in MODE_COUNTERS.items():
        for name in MODES[mode]:
            setattr(WRAPPERS[name], attr, 0)
