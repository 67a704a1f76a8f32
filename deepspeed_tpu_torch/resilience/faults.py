"""Deterministic fault injection at named fault points.

Counterpart of deepspeed_tpu/resilience/faults.py, the part that the
single-replica serving control plane fires: the typed injected errors, the
seeded FaultPlan of FaultSpecs, arming, and `fault_point`, with the
registry entries of the points the engine's KV transfer, the spill tier
and the scheduler call. The router's and the trainer's points, the
replica-death and checkpoint errors, and `corrupt_file` come with the
router's slice (ROADMAP A16).

- Zero overhead disarmed: a fault point is one module-global `None` check
  when no plan is armed.
- Deterministic: a spec fires on the Nth *matching* invocation of its
  point (`at`), for `times` consecutive matches (-1 = forever). The plan's
  `seed` only drives payload choices (which bit a 'corrupt' flips,
  resilience/integrity.py), keyed on the seed and the matching invocation.
- Typed: injected errors subclass `InjectedFault`.
"""

import contextlib
import dataclasses
import json
import os
import threading
from typing import Any, Dict, List, Optional, Union

__all__ = [
    "FaultPlan", "FaultSpec", "FaultAction", "fault_point", "arm", "disarm", "armed",
    "active_plan", "FAULT_POINTS", "InjectedFault", "HandoffError",
    "InjectedIOError",
]


class InjectedFault(RuntimeError):
    """Base of every injected failure."""


class HandoffError(InjectedFault):
    """A KV block transfer (export/import) failed."""


class InjectedIOError(InjectedFault, OSError):
    """A transient storage-layer I/O failure (retry-able)."""


_ERRORS = {
    "handoff": HandoffError,
    "io": InjectedIOError,
    "generic": InjectedFault,
}

_KINDS = ("raise", "delay", "skip", "corrupt")

#: The registry of the fault points the port calls: name -> the ctx keys
#: its call site passes, the site and the failure meaning (the JAX
#: package's entries for these points).
FAULT_POINTS = {
    "scheduler.step": {
        "ctx": ("replica",),
        "site": "inference/scheduler.py `step()`",
        "meaning": ("raise = replica death mid-decode (before dispatch, so requeue is "
                    "safe); delay = straggler (accrues to `scheduler.fault_delay_s`)"),
    },
    "engine.export_kv": {
        "ctx": ("uid",),
        "site": "inference/engine.py",
        "meaning": ("raise = handoff export failure; delay = hung transfer (sleeps, "
                    "trips `handoff_timeout_s`)"),
    },
    "engine.import_kv": {
        "ctx": ("uid",),
        "site": "inference/engine.py",
        "meaning": "raise = handoff import failure (adopt cleans up + falls back)",
    },
    "spill.io": {
        "ctx": ("op", "key"),
        "site": "inference/offload_store.py `HostKvSpillStore.put/get`",
        "meaning": ("raise `io` on `op='put'` = the spill export is lost (the victim "
                    "falls back to flush-and-recompute); on `op='get'` = the resume "
                    "readback dies (same fallback; the entry is dropped first so the "
                    "byte budget never wedges)"),
    },
    "handoff.payload": {
        "ctx": ("uid",),
        "site": "inference/engine.py `import_kv`, pre-verification",
        "meaning": ("`corrupt` = an in-transit flip in the K/V page stacks; digest "
                    "verification raises `HandoffIntegrityError` and the caller "
                    "recomputes token-identically (spill resumes ride the same import "
                    "path, so this point also models a flip while a spilled payload sat "
                    "in host memory)"),
    },
}


@dataclasses.dataclass
class FaultSpec:
    """One deterministic failure rule.

    point: fault-point name (FAULT_POINTS).
    kind:  'raise' (throw `error`), 'delay' (hand `value` seconds to the
           call site), 'skip' (suppress the guarded action), 'corrupt'
           (the call site flips bits, resilience/integrity.py).
    where: ctx filters; every key must equal the call site's ctx for the
           invocation to count as a match.
    at:    fire from the at-th matching invocation (1-based).
    times: for how many consecutive matches (-1 = forever)."""

    point: str
    kind: str = "raise"
    error: str = "generic"
    value: float = 0.0
    where: Dict[str, Any] = dataclasses.field(default_factory=dict)
    at: int = 1
    times: int = 1
    note: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind '{self.kind}' (expected one of {_KINDS})")
        if self.kind == "raise" and self.error not in _ERRORS:
            raise ValueError(f"unknown error '{self.error}' (expected one of "
                             f"{sorted(_ERRORS)})")
        if self.at < 1:
            raise ValueError("at is 1-based and must be >= 1")


class FaultAction:
    """Non-raising verdict of a fault point: kind + value + the spec, plus
    the plan `seed` and the 1-based matching `invocation`, which key a
    'corrupt' call site's bit flips."""

    __slots__ = ("kind", "value", "spec", "seed", "invocation")

    def __init__(self, kind: str, value: float, spec: FaultSpec, seed: int = 0,
                 invocation: int = 1):
        self.kind = kind
        self.value = value
        self.spec = spec
        self.seed = int(seed)
        self.invocation = int(invocation)

    def __repr__(self):  # pragma: no cover - debug aid
        return f"FaultAction({self.kind}, {self.value})"


class FaultPlan:
    """A seeded, ordered set of FaultSpecs. Counters live here (not in the
    specs), so one plan object can be reset and replayed."""

    def __init__(self, faults: List[Union[FaultSpec, Dict[str, Any]]], seed: int = 0,
                 budget: Optional[Dict[str, float]] = None, name: str = "chaos"):
        self.name = name
        self.seed = int(seed)
        self.budget: Dict[str, float] = dict(budget or {})
        self.faults: List[FaultSpec] = [f if isinstance(f, FaultSpec) else FaultSpec(**f)
                                        for f in faults]
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> "FaultPlan":
        with self._lock:
            self._matched = [0] * len(self.faults)
            self.fired: List[str] = []  # human-readable injection log
        return self

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultPlan":
        return cls(d.get("faults", []), seed=d.get("seed", 0), budget=d.get("budget"),
                   name=d.get("name", "chaos"))

    @classmethod
    def from_json(cls, path_or_text: str) -> "FaultPlan":
        if os.path.exists(path_or_text):
            with open(path_or_text) as f:
                d = json.load(f)
            d.setdefault("name", os.path.basename(path_or_text))
        else:
            d = json.loads(path_or_text)
        return cls.from_dict(d)

    def _hit(self, point: str, ctx: Dict[str, Any]):
        """One fault-point invocation: count matches, fire what is due. A
        'raise' spec throws immediately; other kinds return the last due
        FaultAction (None when nothing fires)."""
        act: Optional[FaultAction] = None
        for k, spec in enumerate(self.faults):
            if spec.point != point:
                continue
            if any(ctx.get(key) != want for key, want in spec.where.items()):
                continue
            with self._lock:
                self._matched[k] += 1
                n = self._matched[k]
                due = n >= spec.at and (spec.times < 0 or n < spec.at + spec.times)
                if due:
                    detail = (spec.error if spec.kind == "raise"
                              else f"{spec.value}" if spec.kind == "delay" else spec.kind)
                    self.fired.append(f"{point}#{n}:{spec.kind}:{detail}")
            if not due:
                continue
            if spec.kind == "raise":
                err = _ERRORS[spec.error](
                    f"injected {spec.error} at {point} (matching invocation {n}, "
                    f"plan '{self.name}')")
                err.spec = spec
                raise err
            act = FaultAction(spec.kind, spec.value, spec, seed=self.seed, invocation=n)
        return act


# One process-global plan: fault points sit in modules that must not know
# about each other, and a chaos run arms one plan at a time.
_ACTIVE: Optional[FaultPlan] = None


def arm(plan: Union[FaultPlan, Dict[str, Any], str]) -> FaultPlan:
    """Arm a plan (FaultPlan | dict | JSON path/text). Returns it."""
    global _ACTIVE
    if isinstance(plan, str):
        plan = FaultPlan.from_json(plan)
    elif isinstance(plan, dict):
        plan = FaultPlan.from_dict(plan)
    _ACTIVE = plan
    return plan


def disarm() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


@contextlib.contextmanager
def armed(plan: Union[FaultPlan, Dict[str, Any], str]):
    """``with armed(plan) as p: ...`` disarms on exit, also when the
    injected fault propagates."""
    p = arm(plan)
    try:
        yield p
    finally:
        disarm()


def fault_point(point: str, **ctx) -> Optional[FaultAction]:
    """The injection site. Disarmed: one global read + None check. Armed:
    may raise an InjectedFault subclass, or return a FaultAction
    ('delay'/'skip'/'corrupt') for the call site to interpret."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan._hit(point, ctx)
