from .engine import InferenceConfig, InferenceEngine, init_inference
from .ragged import (
    BlockedAllocator,
    KVCacheExhaustedError,
    PrefixMatch,
    SequenceDescriptor,
    StateManager,
)

__all__ = [
    "InferenceConfig",
    "InferenceEngine",
    "init_inference",
    "BlockedAllocator",
    "KVCacheExhaustedError",
    "PrefixMatch",
    "SequenceDescriptor",
    "StateManager",
]
