"""Fault injection and integrity envelopes for the serving control plane.

Counterpart of deepspeed_tpu/resilience: `faults` (the deterministic chaos
harness: FaultPlan, fault_point, arm/disarm) and `integrity` (digest
envelopes and seeded bit flips of KV handoff payloads), the parts the
single-replica scheduler, the spill tier and the engine's KV transfer
fire. The health breaker, peer redundancy and the interleaving harness
come with the router's and the elastic trainer's slices."""

from .faults import (
    FaultAction,
    FaultPlan,
    FaultSpec,
    HandoffError,
    InjectedFault,
    InjectedIOError,
    active_plan,
    arm,
    armed,
    disarm,
    fault_point,
)
from .integrity import (
    HandoffIntegrityError,
    IntegrityError,
    corrupt_payload,
    flip_bits,
    payload_digest,
)

__all__ = [
    "FaultAction", "FaultPlan", "FaultSpec", "HandoffError", "InjectedFault",
    "InjectedIOError", "active_plan", "arm", "armed", "disarm", "fault_point",
    "HandoffIntegrityError", "IntegrityError", "corrupt_payload", "flip_bits",
    "payload_digest",
]
