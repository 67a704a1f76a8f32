from .engine import InferenceConfig, InferenceEngine, KvCacheDtypeError, init_inference
from .offload_store import HostKvSpillStore
from .pressure import BROWNOUT, GREEN, RED, YELLOW, PressureGovernor
from .ragged import (
    BlockedAllocator,
    KVCacheExhaustedError,
    PrefixMatch,
    SequenceDescriptor,
    StateManager,
)
from .scheduler import Request, ServingScheduler, ServingSchedulerConfig
from ..resilience.integrity import HandoffIntegrityError

__all__ = [
    "InferenceConfig",
    "InferenceEngine",
    "KvCacheDtypeError",
    "init_inference",
    "BlockedAllocator",
    "KVCacheExhaustedError",
    "PrefixMatch",
    "SequenceDescriptor",
    "StateManager",
    "GREEN",
    "YELLOW",
    "RED",
    "BROWNOUT",
    "PressureGovernor",
    "HandoffIntegrityError",
    "HostKvSpillStore",
    "Request",
    "ServingScheduler",
    "ServingSchedulerConfig",
]
