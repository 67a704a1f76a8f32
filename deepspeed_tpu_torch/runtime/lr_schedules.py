"""LR schedules: pure `step -> lr` functions.

Counterpart of deepspeed_tpu/runtime/lr_schedules.py (the reference's
LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR and WarmupCosineLR), with
the same names and parameter keys. The JAX package traces them into its
compiled step in float32; here they run on the host in numpy float32, the
same arithmetic as XLA compiles it: a division by a constant becomes a
multiply by the constant's float32 reciprocal (`_over`), and a
multiply-add becomes one fused multiply-add with a single rounding
(`_fma`). WarmupLR and WarmupDecayLR with linear warmup then give the
same float32 learning rate in both packages. The others agree within a
few float32 ulps: XLA also folds chains of constant factors into one
constant, and its log1p and cos are not numpy's. Each returns a Python
float.
"""

import math
from typing import Any, Callable, Dict, Optional

import numpy as np

Schedule = Callable[[int], float]

_f32 = np.float32


def _clip01(x):
    return np.clip(x, _f32(0.0), _f32(1.0))


def _over(x, c):
    """x / c for a constant c, as x * float32(1 / c)."""
    return _f32(x) * (_f32(1) / _f32(c))


def _fma(a, b, c):
    """a * b + c in float32 with one rounding (the float64 product of two
    float32 values is exact)."""
    return _f32(np.float64(_f32(a)) * np.float64(_f32(b)) + np.float64(_f32(c)))


def constant(lr: float) -> Schedule:
    return lambda step: float(_f32(lr))


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000, warmup_type: str = "log") -> Schedule:
    """WarmupLR: log or linear warmup, then flat."""
    n = max(warmup_num_steps, 1)

    def f(step):
        s = _f32(step)
        if warmup_type == "log":
            frac = _over(np.log1p(s), math.log1p(n)) if step > 0 else _f32(0.0)
        else:
            frac = _over(s, n)
        return float(_fma(warmup_max_lr - warmup_min_lr, _clip01(frac), warmup_min_lr))

    return f


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3, warmup_num_steps: int = 1000,
                    warmup_type: str = "log") -> Schedule:
    """WarmupDecayLR: warmup, then linear decay towards warmup_min_lr
    (min + (max - min) * decay)."""
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def f(step):
        if step < warmup_num_steps:
            return warm(step)
        decay = _clip01(_over(_f32(total_num_steps) - _f32(step),
                              max(total_num_steps - warmup_num_steps, 1)))
        return float(_fma(warmup_max_lr - warmup_min_lr, decay, warmup_min_lr))

    return f


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 1e-4,
                     lr: float = 1e-3) -> Schedule:
    """WarmupCosineLR: scales `lr` by a warmup ratio, then by a cosine
    decay to cos_min_ratio."""

    def f(step):
        s = _f32(step)
        if step < warmup_num_steps:
            ratio = _fma(1 - warmup_min_ratio,
                         _clip01(_over(s, max(warmup_num_steps, 1))), warmup_min_ratio)
        else:
            progress = _clip01(_over(s - _f32(warmup_num_steps),
                                     max(total_num_steps - warmup_num_steps, 1)))
            ratio = _fma((1 - cos_min_ratio) * 0.5,
                         _f32(1) + np.cos(_f32(math.pi) * progress), cos_min_ratio)
        return float(_f32(lr) * ratio)

    return f


def one_cycle(cycle_min_lr: float, cycle_max_lr: float, cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None, decay_step_size: int = 0,
              decay_lr_rate: float = 0.0, **_ignored) -> Schedule:
    """OneCycle: triangular up and down, then decay."""
    second = (cycle_second_step_size if cycle_second_step_size is not None
              else cycle_first_step_size)
    cycle_len = cycle_first_step_size + second
    span = cycle_max_lr - cycle_min_lr

    def f(step):
        s = _f32(step)
        if step < cycle_first_step_size:
            return float(_fma(span, _over(s, max(cycle_first_step_size, 1)), cycle_min_lr))
        if step < cycle_len:
            return float(_fma(-span, _over(s - _f32(cycle_first_step_size), max(second, 1)),
                              cycle_max_lr))
        if decay_step_size > 0:
            post = s - _f32(cycle_len)
            return float(_f32(cycle_min_lr)
                         / _fma(decay_lr_rate, np.floor(_over(post, decay_step_size)), 1))
        return float(_f32(cycle_min_lr))

    return f


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Schedule:
    """LRRangeTest: lr grows linearly (or in stairs) with the step."""

    def f(step):
        interval = _over(step, max(lr_range_test_step_size, 1))
        if lr_range_test_staircase:
            interval = np.floor(interval)
        return float(_f32(lr_range_test_min_lr) * _fma(interval, lr_range_test_step_rate, 1))

    return f


_REGISTRY: Dict[str, Callable[..., Schedule]] = {
    "warmuplr": warmup_lr,
    "warmupdecaylr": warmup_decay_lr,
    "warmupcosinelr": warmup_cosine_lr,
    "onecycle": one_cycle,
    "lrrangetest": lr_range_test,
    "constant": lambda lr=1e-3, **_: constant(lr),
}


def build_schedule(type_name: Optional[str], params: Optional[Dict[str, Any]] = None,
                   base_lr: float = 1e-3) -> Schedule:
    """Build from the config's scheduler block. With no scheduler, a
    constant schedule at the optimizer's lr. WarmupCosineLR and constant
    scale the optimizer's lr unless their block sets `lr`."""
    if type_name is None:
        return constant(base_lr)
    key = type_name.lower().replace("_", "")
    if key not in _REGISTRY:
        raise ValueError(f"unknown scheduler '{type_name}'; available: {sorted(_REGISTRY)}")
    params = dict(params or {})
    if key in ("warmupcosinelr", "constant"):
        params.setdefault("lr", base_lr)
    return _REGISTRY[key](**params)
