"""Memory-pressure governor and SLO admission cost model of the serving
scheduler.

Counterpart of deepspeed_tpu/inference/pressure.py (the port keeps its own
copy: it imports nothing of the JAX package).

- PressureGovernor: tiered watermarks over the BlockedAllocator's LIVE
  occupancy (blocks pinned by active sequences; parked prefix-cache
  blocks are evictable and do not count), scaled down when the warmup
  footprint crowds the device memory budget. Levels:

    GREEN     steady state.
    YELLOW    evict LRU-parked prefix-cache blocks into the free list.
    RED       preemption victims spill their paged KV to the bounded
              pinned-host tier (offload_store.HostKvSpillStore) instead of
              discarding it; resume is an import_kv scatter, with
              recompute as the fallback.
    BROWNOUT  speculative mode degrades to plain decode, the prefill chunk
              shrinks and admission is capped per iteration.

  Transitions down carry a hysteresis margin, one level per update.
- The step cost model (C_DISPATCH + C_TOKEN per batched token) and
  `estimate_ttft`, which the scheduler's SLO admission checks a deadline
  against at submit(). The handoff's cost constants come with the router
  (ROADMAP A16).

Everything here is host-side arithmetic over counters: no device state and
no wall clocks, so both packages' governors move through the same levels
on the same occupancy sequence.
"""

from typing import Dict, Optional

__all__ = [
    "GREEN", "YELLOW", "RED", "BROWNOUT", "LEVEL_NAMES", "PressureGovernor",
    "estimate_ttft", "C_DISPATCH", "C_TOKEN",
]

# pressure levels (ordered: comparisons like `level >= RED` are the API)
GREEN, YELLOW, RED, BROWNOUT = 0, 1, 2, 3
LEVEL_NAMES = {GREEN: "green", YELLOW: "yellow", RED: "red", BROWNOUT: "brownout"}

# the modeled per-step cost (the JAX package's constants, in modeled
# seconds; SLO deadlines are given in the same units)
C_DISPATCH, C_TOKEN = 2e-3, 5e-5


class PressureGovernor:
    """Tiered-watermark pressure controller over one engine's paged KV
    pool. The scheduler calls `update()` once per iteration, before
    admission; everything else reads `level`.

    cfg: a config.PressureConfig. budget_bytes: the device memory budget
    the watermark scaling divides the warmed footprint by (0 disables the
    scaling)."""

    def __init__(self, cfg, engine, budget_bytes: int = 0):
        self.cfg = cfg
        self.engine = engine
        self.budget_bytes = int(budget_bytes)
        self.level = GREEN
        self.counters: Dict[str, int] = {
            "transitions": 0, "parked_trimmed": 0, "trim_calls": 0,
            "steps_yellow": 0, "steps_red": 0, "steps_brownout": 0,
        }
        self.max_level = GREEN

    def occupancy(self) -> float:
        """LIVE occupancy of the block pool: the fraction pinned by active
        sequences (parked prefix-cache blocks are headroom)."""
        alloc = self.engine.state.allocator
        total = alloc.total_blocks
        return 1.0 - alloc.available_blocks / total if total else 1.0

    def watermark_scale(self) -> float:
        """When the warmed widest decode bucket's footprint crowds the
        budget past `static_headroom`, every watermark scales down by the
        overshoot (floored at 0.5)."""
        if self.budget_bytes <= 0:
            return 1.0
        fps = getattr(self.engine, "warmup_footprints", {})
        if not fps:
            return 1.0
        peak = max(f["peak_hbm_bytes"] for f in fps.values())
        overshoot = max(0.0, peak / self.budget_bytes - self.cfg.static_headroom)
        return max(0.5, 1.0 - overshoot)

    def update(self) -> int:
        """Re-read occupancy, move the level (with hysteresis on the way
        down), and run the YELLOW relief valve (LRU-parked trim). Returns
        the new level."""
        occ = self.occupancy()
        scale = self.watermark_scale()
        marks = (self.cfg.yellow * scale, self.cfg.red * scale, self.cfg.brownout * scale)
        target = GREEN
        for lvl, mark in ((YELLOW, marks[0]), (RED, marks[1]), (BROWNOUT, marks[2])):
            if occ >= mark:
                target = lvl
        if target < self.level:
            # relax ONE level per update, and only once occupancy clears
            # the current level's entry watermark by the margin
            entry = marks[self.level - 1]
            target = self.level - 1 if occ < entry - self.cfg.hysteresis else self.level
        if target != self.level:
            self.counters["transitions"] += 1
            self.level = target
            self.max_level = max(self.max_level, target)
        if self.level >= YELLOW:
            self.counters["steps_yellow"] += 1
            trimmed = self.engine.state.trim_parked(self.cfg.yellow_trim_blocks)
            if trimmed:
                self.counters["trim_calls"] += 1
                self.counters["parked_trimmed"] += trimmed
        if self.level >= RED:
            self.counters["steps_red"] += 1
        if self.level >= BROWNOUT:
            self.counters["steps_brownout"] += 1
        return self.level

    def metrics(self) -> Dict[str, float]:
        m = {f"pressure_{k}": float(v) for k, v in self.counters.items()}
        m["pressure_level"] = float(self.level)
        m["pressure_max_level"] = float(self.max_level)
        m["pressure_occupancy"] = round(self.occupancy(), 4)
        return m


def estimate_ttft(scheduler, prompt_tokens: int, level: Optional[int] = None) -> float:
    """Cost-model TTFT estimate for a prompt submitted now: every prompt
    token queued ahead of it (waiting requests' bases plus active
    sequences' unfinished prefill suffixes) feeds through the
    per-iteration token budget before its own last chunk runs, and each of
    those iterations also carries the running decode rows. BROWNOUT
    doubles the estimate."""
    cfg = scheduler.cfg
    ahead = sum(len(r.base) - r.fed for r in scheduler.waiting)
    running = 0
    for r in scheduler.active:
        if r.state == "prefill":
            ahead += len(r.base) - r.fed
        else:
            running += 1
    total = ahead + int(prompt_tokens)
    budget = max(1, cfg.max_num_batched_tokens)
    iters = -(-total // budget)
    est = iters * C_DISPATCH + (total + iters * running) * C_TOKEN
    if level is None and scheduler.governor is not None:
        level = scheduler.governor.level
    if level is not None and level >= BROWNOUT:
        est *= 2.0
    return est
