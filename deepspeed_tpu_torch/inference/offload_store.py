"""Host-memory tiers of the serving engine.

Counterpart of deepspeed_tpu/inference/offload_store.py. This slice ports
`HostKvSpillStore`, the bounded host tier that the serving scheduler parks
preempted sequences' paged KV in under RED pressure. The NVMe layer store
of full-offload serving comes with the offload slice (ROADMAP A14).
"""

import threading
from typing import Any, Dict

import numpy as np

from ..resilience.faults import fault_point

__all__ = ["HostKvSpillStore"]


class HostKvSpillStore:
    """Bounded host spill tier for preempted sequences' paged KV (the
    serving counterpart of vLLM's swap space, used by
    scheduler._preempt under RED pressure).

    Entries are `engine.export_kv` payloads: numpy page stacks plus the
    blake2b digest envelope, so a bit flipped while a payload sits in host
    memory is caught by `import_kv` at resume, which then recomputes. On a
    CUDA engine export_kv lands the pages in pinned host memory, and the
    store keeps those arrays as they are (no second copy).

    The tier is bounded in BYTES (`capacity_bytes`): a put that would
    overflow is REJECTED (returns False: the caller flushes and recomputes)
    and nothing is evicted, because every resident entry belongs to a
    request the scheduler will resume. Fault point 'spill.io' (ctx: op
    put|get, key) fires inside both operations."""

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        self._entries: Dict[Any, Dict[str, Any]] = {}
        self._bytes: Dict[Any, int] = {}
        self._lock = threading.Lock()
        self.used_bytes = 0
        self.peak_bytes = 0
        self.counters: Dict[str, int] = {"puts": 0, "gets": 0, "rejects": 0, "discards": 0}

    @staticmethod
    def payload_nbytes(payload: Dict[str, Any]) -> int:
        return sum(int(v.nbytes) for v in payload.values() if isinstance(v, np.ndarray))

    def put(self, key: Any, payload: Dict[str, Any]) -> bool:
        """Admit one spilled payload. Returns False (nothing stored) when
        the byte budget cannot take it. May raise an InjectedFault from
        the 'spill.io' fault point."""
        fault_point("spill.io", op="put", key=key)
        nbytes = self.payload_nbytes(payload)
        with self._lock:
            if key in self._entries:
                raise ValueError(f"spill key {key!r} already stored")
            if self.used_bytes + nbytes > self.capacity_bytes:
                self.counters["rejects"] += 1
                return False
            self._entries[key] = payload
            self._bytes[key] = nbytes
            self.used_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.used_bytes)
            self.counters["puts"] += 1
        return True

    def get(self, key: Any):
        """Pop one spilled payload (None when absent). May raise an
        InjectedFault from the 'spill.io' fault point; the entry is dropped
        first, so a failed get never wedges the byte budget."""
        with self._lock:
            payload = self._entries.pop(key, None)
            if payload is not None:
                self.used_bytes -= self._bytes.pop(key)
                self.counters["gets"] += 1
        fault_point("spill.io", op="get", key=key)
        return payload

    def restore(self, key: Any, payload: Dict[str, Any]) -> None:
        """Re-insert a payload just popped by get() whose resume could not
        land (pool full for now): no fault point and no put accounting."""
        with self._lock:
            if key in self._entries:
                raise ValueError(f"spill key {key!r} already stored")
            nbytes = self.payload_nbytes(payload)
            self._entries[key] = payload
            self._bytes[key] = nbytes
            self.used_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.used_bytes)

    def discard(self, key: Any) -> None:
        """Drop an entry whose request will never resume here."""
        with self._lock:
            if self._entries.pop(key, None) is not None:
                self.used_bytes -= self._bytes.pop(key)
                self.counters["discards"] += 1

    def drain(self) -> int:
        """Discard every resident entry; returns how many were dropped."""
        with self._lock:
            dropped = len(self._entries)
            self.counters["discards"] += dropped
            self._entries.clear()
            self._bytes.clear()
            self.used_bytes = 0
        return dropped

    def stats(self) -> Dict[str, float]:
        with self._lock:
            s = {f"spill_{k}": float(v) for k, v in self.counters.items()}
            s["spill_entries"] = float(len(self._entries))
            s["spill_used_bytes"] = float(self.used_bytes)
            s["spill_peak_bytes"] = float(self.peak_bytes)
            s["spill_capacity_bytes"] = float(self.capacity_bytes)
        return s
