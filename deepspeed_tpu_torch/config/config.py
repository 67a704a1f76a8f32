"""Config blocks of the port.

Counterpart of deepspeed_tpu/config/config.py. The JAX package builds its
configs on pydantic models with `extra="forbid"`; the port is plain
dataclasses (the GPU machine has no pydantic) with the same contract:
unknown keys raise `TypeError` (the dataclass constructor does that) and
a value of the wrong type raises `TypeError` in `check_field_types`.
"""

import dataclasses
import typing


def check_field_types(obj) -> None:
    """Raise TypeError for a field whose value is not of its declared type
    (bool is not accepted for int, nor int for bool; an int is accepted for
    float). Supports the plain field types the port's configs use."""
    hints = typing.get_type_hints(type(obj))
    for f in dataclasses.fields(obj):
        want = hints[f.name]
        val = getattr(obj, f.name)
        if want is bool:
            ok = isinstance(val, bool)
        elif want is int:
            ok = isinstance(val, int) and not isinstance(val, bool)
        elif want is float:
            ok = isinstance(val, (int, float)) and not isinstance(val, bool)
        elif want is str:
            ok = isinstance(val, str)
        else:
            continue
        if not ok:
            raise TypeError(
                f"{type(obj).__name__}.{f.name} must be {want.__name__}, "
                f"got {val!r}")


@dataclasses.dataclass
class PrefixCacheConfig:
    """Automatic prefix caching for the ragged inference engine
    (inference/ragged.py): content-addressed reuse of full KV blocks
    across sequences sharing a prompt prefix, vLLM-PagedAttention style.

    pool_blocks caps the LRU pool of retired-but-cached blocks
    (refcount 0, contents kept for future hits): -1 keeps every retired
    cached block until allocation pressure evicts it; 0 disables
    parking (blocks shared only while a live sequence holds them)."""

    enabled: bool = True
    pool_blocks: int = -1

    def __post_init__(self):
        check_field_types(self)
