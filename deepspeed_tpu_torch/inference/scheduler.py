"""Continuous-batching serving scheduler: the request-level control plane
over the paged KV pool.

Counterpart of deepspeed_tpu/inference/scheduler.py, line for line in its
host logic, so that both packages' schedulers take the same decisions on
the same requests (tests/test_torch_scheduler.py holds tokens, finish
reasons and counters equal). Orca-style iteration-level scheduling with
Sarathi-style chunked prefill:

- admission pops waiting requests whenever the KV pool fits their
  (prefix-cache-credited) prompt;
- chunked prefill interleaves with decode: a newly admitted prompt feeds
  through the decode step in `prefill_chunk` pieces beside the running
  sequences' decode rows, bounded by `max_num_batched_tokens` a step. Rows
  of one sequence share its block table, so such a step writes every row
  (#6) before it attends (#4 plain); a step of single-token rows takes the
  fused write+attend kernel (#5);
- immediate retirement: a sequence that hits EOS or its length is flushed
  at the iteration it finishes;
- preemption over failure: under KV pressure the youngest sequence is
  preempted (flushed and re-queued for recompute, or under RED pressure
  spilled to the host tier and resumed by import_kv). Recompute is exact:
  draws are keyed by (seed, stream, position).

Device side:

- `engine.warmup()` at construction captures the decode programs of every
  mixed width (8, 16, ... up to max_batch_size; shared-table and distinct
  rows) and every fused depth as CUDA graphs (inference/graphs.py), so the
  steady state replays instead of issuing each op from the host;
- chained steps: in the steady pure-decode state step N+1 is dispatched on
  step N's sampled tokens while they are still on the device (a replay
  copies them into the graph's static token buffer on the stream), and
  step N's readback (utils/sync.py, an async copy started at dispatch)
  lands after; with decode_chunk > 1 the steady state fuses decode_chunk
  steps into one decode_multi program.

`InferenceEngine.generate()` and `generate_speculative()` are thin
wrappers over this scheduler (prefill_mode='wave', warmup off).
"""

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..config.config import ServingSchedulerConfig
from ..platform.accelerator import hbm_per_device
from ..resilience.faults import fault_point
from ..resilience.integrity import HandoffIntegrityError
from ..utils.logging import log_dist
from ..utils.sync import serving_readback, start_readback
from .engine import InferenceEngine, _bucket
from .offload_store import HostKvSpillStore
from .pressure import BROWNOUT, RED, PressureGovernor, estimate_ttft
from .ragged import KVCacheExhaustedError
from .sampling import SamplingConfig

__all__ = ["Request", "ServingScheduler", "ServingSchedulerConfig", "SchedulerConfig",
           "Finding", "BudgetReport"]

# module-local alias, as in the JAX package (config.SchedulerConfig is the
# LR-schedule block)
SchedulerConfig = ServingSchedulerConfig

WAITING, PREFILL, RUNNING, FINISHED, HANDOFF = (
    "waiting", "prefill", "running", "finished", "handoff")


@dataclasses.dataclass
class Request:
    """One serving request through its whole lifecycle."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int]
    stream: int                      # sampling stream id (defaults to rid)
    arrival: float                   # perf_counter() at submit
    state: str = WAITING
    uid: Optional[int] = None        # engine uid while admitted
    fed: int = 0                     # base tokens already in the KV cache
    output: List[int] = dataclasses.field(default_factory=list)
    pending: Optional[int] = None    # sampled, not-yet-fed token
    presence: Optional[np.ndarray] = None  # [V] uint8, rep-penalty only
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    finish_reason: Optional[str] = None    # eos | length | capacity
    preemptions: int = 0
    n_cached: int = 0                # prefix-cache-served prompt tokens
    # prefill/decode disaggregation (inference/router.py): a handoff
    # request parks after its FIRST sampled token — KV intact — for the
    # router to transfer to a decode replica, instead of decoding here
    handoff: bool = False
    # SLO admission (inference/pressure.py): optional TTFT deadline in
    # modeled seconds; an unservable deadline rejects at submit() with
    # finish_reason='deadline' before any KV block is touched
    deadline_s: Optional[float] = None
    slo_class: Optional[str] = None
    # preempt-to-host (RED pressure): key of this request's spilled KV
    # payload in the scheduler's HostKvSpillStore — resume imports the
    # pages instead of recomputing; None = recompute on re-admission
    spill_key: Optional[int] = None

    @property
    def base(self) -> List[int]:
        """The token stream that must be in the cache before the next
        draw: prompt + accepted output (recompute target after a
        preemption — positions are absolute, so re-drawn tokens are
        identical)."""
        return self.prompt + self.output

    @property
    def done(self) -> bool:
        return self.state == FINISHED


@dataclasses.dataclass
class Finding:
    """One admit-time budget finding (rule S004, the JAX package's
    analysis/report.py Finding fields)."""

    rule: str
    path: str
    line: int
    severity: str
    message: str
    fix_hint: str = ""


@dataclasses.dataclass
class BudgetReport:
    """The admit-time budget check's findings (the JAX package's
    SanitizerReport, reduced to what the scheduler fills)."""

    label: str
    findings: List[Finding] = dataclasses.field(default_factory=list)


class _Part:
    """One dispatched program of an iteration (a step may hold several:
    prefill wave(s) + the mixed decode step). The host copy of its sampled
    tokens starts here, at dispatch (utils/sync.py start_readback); the
    device tensor stays for a chained successor to read."""

    def __init__(self, kind: str, sample_rows, tok_dev, n_steps: int = 1):
        self.kind = kind              # wave | mixed | fused
        self.sample_rows = sample_rows  # [(req, row_index)]
        self.tok_dev = tok_dev        # [bucket] or [n_steps, bucket] int32
        self.n_steps = n_steps
        self.readback = None if tok_dev is None else start_readback(tok_dev)


class _Step:
    def __init__(self, parts: List[_Part], n_tokens: int):
        self.parts = parts
        self.n_tokens = n_tokens      # batched tokens this iteration


class ServingScheduler:
    """Iteration-level scheduler driving one InferenceEngine.

    sampling: SamplingConfig kwargs shared by every request (compiled
    into the decode/sample programs; greedy when omitted); seed + each
    request's stream id + token position define every draw, so outputs
    are reproducible and independent of batch composition, preemption,
    and arrival order. speculative={'ngram': n, 'draft_len': k} switches
    running sequences to prompt-lookup self-speculation (greedy only;
    the generate_speculative() control plane)."""

    def __init__(
        self,
        engine: InferenceEngine,
        config: Union[ServingSchedulerConfig, Dict[str, Any], None] = None,
        sampling: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        speculative: Optional[Dict[str, int]] = None,
    ):
        self.engine = engine
        if isinstance(config, dict):
            config = ServingSchedulerConfig(**config)
        self.cfg = config or ServingSchedulerConfig()
        self.scfg = SamplingConfig(**(sampling or {}))
        self.seed = int(seed)
        self._spec = dict(speculative) if speculative else None
        if self._spec and not self.scfg.greedy:
            raise ValueError("speculative decoding is greedy-only")
        self.waiting: "deque[Request]" = deque()
        self.active: List[Request] = []   # admission order; PREFILL/RUNNING
        self.finished: Dict[int, Request] = {}
        # prefill-complete handoff requests awaiting KV transfer to a
        # decode replica (router.pump() drains this; disaggregated mode)
        self.handoff_ready: "deque[Request]" = deque()
        self._next_rid = 0
        self.counters: Dict[str, int] = {
            "steps": 0, "admitted": 0, "finished": 0, "preemptions": 0,
            "batched_tokens": 0, "fused_steps": 0, "chained_steps": 0,
            "wave_prefills": 0, "handoffs": 0, "adopted": 0,
            "spills": 0, "spill_resumes": 0, "spill_fallbacks": 0,
            "spill_rejects": 0, "spill_integrity_failures": 0,
            "spill_releases": 0, "chain_fallbacks": 0,
            "deadline_rejections": 0, "starvation_protected": 0,
        }
        self.spec_stats: Dict[str, float] = {
            "steps": 0, "verified_chunks": 0, "draft_tokens": 0,
            "accepted_tokens": 0, "draft_collapsed_steps": 0,
            "mean_accepted": 0.0,
        }
        # SLO-class breakdown of deadline rejections: the autoscaler's
        # premium-impact signal (inference/autoscaler.py) needs to know
        # WHOSE deadlines the fleet is failing, not just how many
        self.slo_rejections: Dict[str, int] = {}
        self._ttft: List[float] = []
        self._tpot: List[float] = []
        # set by ServingRouter (fault-point ctx + health identity);
        # standalone schedulers leave it None
        self.replica_index: Optional[int] = None
        # injected straggler time (resilience/faults 'delay' kind)
        # accrues here: virtual-clock simulations charge it to their
        # clocks, wall-clock callers fold it into the health observation
        self.fault_delay_s = 0.0
        if self.cfg.warmup:
            use_pres = self.scfg.needs_presence
            # every fused depth _fused_depth can return (2..decode_chunk:
            # a sequence near its budget shortens the chunk): where the
            # JAX package compiles a missing depth once, an uncaptured
            # depth here would run eagerly at every such step
            chunks = (tuple(range(2, self.cfg.decode_chunk + 1))
                      if self.cfg.decode_chunk > 1 and not self._spec
                      else ())
            engine.warmup(sampling=sampling, decode_chunks=chunks,
                          presence=use_pres)
        # admit-config budget validation: the warmed per-bucket
        # footprints vs the device memory budget (S004), logged once here
        # and counted in metrics()
        self.budget_report = self._validate_budget()
        # memory-pressure governor + pinned-host spill tier
        # (inference/pressure.py, docs/fault_tolerance.md): opt-in —
        # with pressure off, preemption stays flush-and-recompute
        self.governor: Optional[PressureGovernor] = None
        self.spill_store = None
        self._spill_seq = 0
        pcfg = self.cfg.pressure
        if pcfg.enabled:
            budget = (int(self.cfg.hbm_budget_gb * 1e9)
                      if self.cfg.hbm_budget_gb > 0 else 0)
            if budget == 0 and getattr(engine, "warmup_footprints", {}):
                budget = hbm_per_device(engine.device)
            self.governor = PressureGovernor(pcfg, engine,
                                             budget_bytes=budget)
            if pcfg.spill_enabled:
                self.spill_store = HostKvSpillStore(
                    int(pcfg.spill_host_mb * 2**20))

    # -- admit-config budget validation ----------------------------------
    def _validate_budget(self):
        """S004 at admit-config time: the widest warmed decode bucket's
        peak footprint (engine.warmup's CUDA allocator readings: weights,
        paged KV pools and scratch) must fit the device memory budget,
        and `max_num_batched_tokens` must not overcommit the KV pool's
        token capacity in a single iteration. Findings are logged, not
        raised."""
        eng = self.engine
        rep = BudgetReport(label="serving/admit_budget")
        fps = getattr(eng, "warmup_footprints", {})
        if fps:
            if self.cfg.hbm_budget_gb > 0:
                budget = int(self.cfg.hbm_budget_gb * 1e9)
            else:
                budget = hbm_per_device(eng.device)
            peak = max(f["peak_hbm_bytes"] for f in fps.values())
            if peak > budget:
                gib = 1 / 2**30
                rep.findings.append(Finding(
                    rule="S004", path="serving/warmup", line=0,
                    severity="error",
                    message=(
                        f"widest warmed decode bucket needs "
                        f"{peak * gib:.2f} GiB but the per-device budget "
                        f"is {budget * gib:.2f} GiB — steady-state "
                        "serving OOMs before the first request"),
                    fix_hint=(
                        "shrink num_kv_blocks/max_batch_size, quantize "
                        "the weights, or raise hbm_budget_gb if the "
                        "budget is wrong"),
                ))
        pool_tokens = eng.config.num_kv_blocks * eng.config.kv_block_size
        if self.cfg.max_num_batched_tokens > pool_tokens:
            rep.findings.append(Finding(
                rule="S004", path="serving/admission", line=0,
                severity="warning",
                message=(
                    f"max_num_batched_tokens "
                    f"{self.cfg.max_num_batched_tokens} exceeds the KV "
                    f"pool's {pool_tokens}-token capacity — one "
                    "iteration can overcommit the allocator and thrash "
                    "preemption"),
                fix_hint=("lower max_num_batched_tokens or grow "
                          "num_kv_blocks"),
            ))
        for f in rep.findings:
            log_dist(f"serving budget check: {f.message}", ranks=[0])
        return rep

    # -- request intake --------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               stream: Optional[int] = None,
               handoff: bool = False,
               deadline_s: Optional[float] = None,
               slo_class: Optional[str] = None) -> int:
        """Queue one request; returns its request id. The stream id
        (default: the rid) keys the request's PRNG stream — generate()
        passes 0..n-1 so a fixed seed reproduces its exact batch.
        handoff=True marks a disaggregated prefill request: it parks in
        handoff_ready after its first sampled token instead of decoding
        here (inference/router.py transfers its KV to a decode
        replica).

        SLO admission: deadline_s (modeled seconds of TTFT slack, the
        inference/pressure.py cost model's units) or slo_class (a name
        resolved through config.slo_classes) attaches a deadline; when
        the queue-depth TTFT estimate already exceeds it, the request
        is rejected HERE — finish_reason='deadline', done=True, zero KV
        blocks touched — instead of queueing to time out after
        consuming pool capacity."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.engine.config.max_seq_len:
            raise ValueError(
                f"prompt of {len(prompt)} > max_seq_len "
                f"{self.engine.config.max_seq_len}")
        deadline = float(deadline_s) if deadline_s is not None else None
        if deadline is None and slo_class is not None:
            deadline = self.cfg.slo_classes.get(slo_class)
            if deadline is None:
                raise ValueError(
                    f"unknown slo_class {slo_class!r}; configure it in "
                    "ServingSchedulerConfig.slo_classes")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      eos_token_id=eos_token_id,
                      stream=int(stream) if stream is not None else rid,
                      arrival=time.perf_counter(),
                      handoff=bool(handoff),
                      deadline_s=deadline, slo_class=slo_class)
        if deadline is not None \
                and estimate_ttft(self, len(prompt)) > deadline:
            req.state = FINISHED
            req.finish_reason = "deadline"
            req.finish_t = time.perf_counter()
            self.finished[rid] = req
            self.counters["deadline_rejections"] += 1
            if slo_class is not None:
                self.slo_rejections[slo_class] = \
                    self.slo_rejections.get(slo_class, 0) + 1
            return rid
        if self.scfg.needs_presence:
            pres = np.zeros((self.engine.cfg.vocab_size,), np.uint8)
            toks = np.asarray(prompt, np.int64)
            pres[toks[(toks >= 0) & (toks < pres.size)]] = 1
            req.presence = pres
        self.waiting.append(req)
        return rid

    def requeue(self, req: Request) -> None:
        """Accept an EXISTING Request for (re)compute on this replica —
        the router's failover / handoff-capacity-fallback path. The
        request keeps its identity (stream, arrival, accepted output),
        so the re-drawn continuation is token-identical to never having
        moved: draws key on (seed, stream, position). The dead/source
        replica's KV is NOT flushed here — it is gone or already
        released by the caller."""
        req.uid = None
        req.fed = 0
        req.pending = None
        req.state = WAITING
        req.preemptions += 1
        # a spill payload lives in the SOURCE scheduler's host tier —
        # unreachable from here; this replica recomputes
        req.spill_key = None
        # a foreign rid may collide with a local one: re-key it so
        # self.finished stays one-entry-per-request
        req.rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(req)

    def release_spill(self, req: Request) -> None:
        """Drop req's host-tier spill payload from THIS scheduler's
        store: a spill payload lives in the SOURCE scheduler's host
        tier, and requeue() on another scheduler cannot reach it, so a
        caller that moves a WAITING request elsewhere releases the
        payload here first or the bytes strand until process exit."""
        if req.spill_key is None:
            return
        if self.spill_store is not None:
            self.spill_store.discard(req.spill_key)
            self.counters["spill_releases"] += 1
        req.spill_key = None

    def adopt(self, req: Request, payload: Dict[str, Any]) -> None:
        """Admit a request whose KV arrives by block transfer
        (engine.import_kv payload): a prefill-complete sequence starts
        RUNNING here with its first token pending, a MID-PREFILL one
        (a drain migration caught between chunks — the payload carries
        only its written blocks, like a spill) re-reserves the rest of
        its base and continues chunking — no recompute either way.
        Raises RuntimeError when the batch or the KV pool cannot take
        it (callers fall back to requeue())."""
        if len(self.active) >= self.engine.config.max_batch_size:
            raise RuntimeError(
                f"decode replica at max_batch_size "
                f"{self.engine.config.max_batch_size}")
        uid = self._alloc_uid()
        try:
            self.engine.import_kv(uid, payload)  # may raise: pool exhausted
        except Exception:
            # a failed import must not leak half-allocated blocks —
            # callers fall back to requeue-for-recompute on this engine
            if self.engine.state.get(uid) is not None:
                self.engine.flush(uid)
            raise
        seen = int(payload["seen_tokens"])
        if req.output and seen == len(req.base) - 1:
            req.pending = req.output[-1]
            req.state = RUNNING
        else:
            # mid-prefill: chunked prefill continues at `fed` (the
            # _resume_from_spill geometry — import laid down only the
            # written blocks, so room for the remainder is re-reserved
            # exactly as admission would have)
            try:
                self.engine.state.extend(uid, len(req.base) - seen)
            except KVCacheExhaustedError:
                self.engine.flush(uid)
                raise
            req.pending = None
            req.state = PREFILL
        req.uid = uid
        req.rid = self._next_rid
        self._next_rid += 1
        req.handoff = False
        req.fed = seen
        self.active.append(req)
        self.counters["adopted"] += 1
        self.counters["admitted"] += 1

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    # -- uid / capacity management ---------------------------------------
    def _alloc_uid(self) -> int:
        taken = set(self.engine.state.tracked_uids)
        cand = 0
        while cand in taken:
            cand += 1
        return cand

    def _try_spill(self, victim: Request) -> bool:
        """Preempt-to-host (RED pressure): export the victim's paged KV
        through the serialized-gather handoff path (digest envelope
        attached) into the bounded pinned-host tier, so re-admission
        resumes with an import_kv scatter instead of recomputing the
        whole prefix. Returns False — the flush-and-recompute fallback
        — when pressure is below RED, the tier lacks room, or the
        export/put leg fails (including an injected 'spill.io'
        fault)."""
        store = self.spill_store
        gov = self.governor
        if store is None or gov is None:
            return False
        # the level was set at dispatch START; admission may have
        # filled the pool since (that is WHY this preemption fired) —
        # the spill decision reads instantaneous occupancy as well,
        # so RED-grade pressure inside an iteration still spills
        if gov.level < RED and \
                gov.occupancy() < gov.cfg.red * gov.watermark_scale():
            return False
        seq = self.engine.state.get(victim.uid)
        if seq is None or seq.seen_tokens < 1:
            return False
        nbytes = self.engine.kv_payload_nbytes(len(seq.blocks))
        if store.used_bytes + nbytes > store.capacity_bytes:
            self.counters["spill_rejects"] += 1
            return False
        key = self._spill_seq
        self._spill_seq += 1
        try:
            payload = self.engine.export_kv(victim.uid)
            if not store.put(key, payload):
                self.counters["spill_rejects"] += 1
                return False
        except Exception as e:
            log_dist(
                f"serving scheduler: KV spill of rid={victim.rid} "
                f"failed ({e!r}); falling back to recompute", ranks=[0])
            self.counters["spill_fallbacks"] += 1
            return False
        victim.spill_key = key
        self.counters["spills"] += 1
        return True

    def _preempt(self, victim: Request) -> None:
        """Flush the victim's KV blocks and re-queue it (front of the
        queue: it has the oldest claim among preempted). Under RED
        pressure with the spill tier on, the pages are exported to host
        FIRST (spill_key set), so re-admission resumes by block import
        instead of recompute — token-identical either way, since draws
        key on (seed, stream, position)."""
        self._try_spill(victim)
        self.engine.state.flush(victim.uid)
        victim.uid = None
        victim.fed = 0
        victim.pending = None
        victim.state = WAITING
        victim.preemptions += 1
        self.counters["preemptions"] += 1
        self.active.remove(victim)
        self.waiting.appendleft(victim)

    def _reserve(self, req: Request, n: int) -> bool:
        """Reserve KV room for n more tokens of req, preempting the
        youngest OTHER active sequence under pressure. Returns False
        when req itself was preempted or finished (its row must be
        dropped from this iteration).

        Starvation bound (config.max_preemptions): a request preempted
        that many times is PROTECTED — skipped in victim selection —
        so two similar-age requests can no longer ping-pong
        (preempt + requeue-front) forever under sustained pressure;
        when every eligible victim is protected, the REQUESTER yields
        instead, and the protected sequences run to completion."""
        bound = self.cfg.max_preemptions
        while True:
            try:
                self.engine.state.extend(req.uid, n)
                return True
            except KVCacheExhaustedError:
                victim = None
                if self.active[-1] is not req:
                    # youngest-first among the OTHER active sequences,
                    # skipping protected ones (preemptions >= bound)
                    for r in reversed(self.active):
                        if r is req:
                            continue
                        if bound and r.preemptions >= bound:
                            continue
                        victim = r
                        break
                if victim is None:
                    if len(self.active) == 1:
                        # alone and still does not fit: genuine capacity
                        # exhaustion, not contention — finish truncated
                        # instead of raising (the generate() behavior
                        # this scheduler replaces)
                        self._finish(req, "capacity")
                        return False
                    if self.active[-1] is not req:
                        # protection forced the requester to yield
                        self.counters["starvation_protected"] += 1
                    self._preempt(req)
                    return False
                self._preempt(victim)

    def _finish(self, req: Request, reason: str) -> None:
        """Retire NOW: blocks go back to the allocator at the iteration
        the sequence finishes, not when the batch drains."""
        if req.uid is not None and self.engine.state.get(req.uid) is not None:
            self.engine.flush(req.uid)
        if req.spill_key is not None and self.spill_store is not None:
            # a spilled payload whose request retires another way
            # (shed, length while queued) must not strand host bytes
            self.spill_store.discard(req.spill_key)
            req.spill_key = None
        req.uid = None
        req.state = FINISHED
        req.finish_reason = reason
        req.finish_t = time.perf_counter()
        if req in self.active:
            self.active.remove(req)
        self.finished[req.rid] = req
        self.counters["finished"] += 1
        if req.first_token_t is not None:
            self._ttft.append(req.first_token_t - req.arrival)
            if len(req.output) > 1:
                self._tpot.append((req.finish_t - req.first_token_t)
                                  / (len(req.output) - 1))

    # -- admission -------------------------------------------------------
    def _resume_from_spill(self, req: Request) -> str:
        """Re-admit a spilled preemption victim by importing its host-
        tier KV payload (a donated scatter — no recompute). Returns
        'resumed' (admitted RUNNING/PREFILL), 'recompute' (payload
        lost/corrupt/faulted: fall through to normal admission), or
        'defer' (the pool cannot take the pages right now: the payload
        is back in the tier and the caller stops admitting — recompute
        would need the same blocks, so waiting is strictly better)."""
        key, req.spill_key = req.spill_key, None
        store = self.spill_store
        try:
            payload = store.get(key)
        except Exception as e:
            log_dist(
                f"serving scheduler: spill readback of rid={req.rid} "
                f"failed ({e!r}); recomputing", ranks=[0])
            self.counters["spill_fallbacks"] += 1
            return "recompute"
        if payload is None:
            self.counters["spill_fallbacks"] += 1
            return "recompute"
        uid = self._alloc_uid()
        try:
            self.engine.import_kv(uid, payload)
        except HandoffIntegrityError as e:
            # a bit flipped while the payload sat in host DRAM: the
            # digest envelope catches it BEFORE any page is scattered
            log_dist(
                f"serving scheduler: spilled KV of rid={req.rid} "
                f"failed digest verification ({e}); recomputing",
                ranks=[0])
            self.counters["spill_integrity_failures"] += 1
            self.counters["spill_fallbacks"] += 1
            return "recompute"
        except KVCacheExhaustedError:
            if self.engine.state.get(uid) is not None:
                self.engine.flush(uid)
            req.spill_key = key
            store.restore(key, payload)
            return "defer"
        seen = int(payload["seen_tokens"])
        req.uid = uid
        req.fed = seen
        if req.output and seen == len(req.base) - 1:
            # mid-decode victim: its next draw's input is the pending
            # (sampled, not-yet-fed) token — exactly where it stopped
            # (per-step _reserve grows the block table from here)
            req.pending = req.output[-1]
            req.state = RUNNING
        else:
            # mid-prefill victim: chunked prefill continues at `fed`.
            # The payload only carried the WRITTEN blocks; re-reserve
            # room for the rest of the base, as admission would have
            try:
                self.engine.state.extend(uid, len(req.base) - seen)
            except KVCacheExhaustedError:
                self.engine.flush(uid)
                req.spill_key = key
                store.restore(key, payload)
                return "defer"
            req.pending = None
            req.state = PREFILL
        self.active.append(req)
        self.counters["admitted"] += 1
        self.counters["spill_resumes"] += 1
        return "resumed"

    def _red_admission_gate(self) -> bool:
        """Under RED pressure NEW admissions pause (the vLLM admission-
        watermark idea): every block a fresh prompt takes is a block a
        RUNNING sequence's growth will preempt it for one iteration
        later — admit-then-evict churn that burns prefill work for
        zero progress. Preempted requests re-entering (preemptions > 0
        or a spill to resume) are exempt: they ARE the in-flight work
        the gate protects. Instantaneous occupancy, not the iteration-
        start level: admissions themselves move it."""
        gov = self.governor
        if gov is None:
            return False
        return (gov.level >= RED
                or gov.occupancy() >= gov.cfg.red * gov.watermark_scale())

    def _admit(self) -> None:
        """Admit waiting requests while a slot and (prefix-cache-
        credited) KV room exist. fcfs stops at the first misfit; skip
        scans past it. Spilled preemption victims resume by block
        import (_resume_from_spill). Under RED pressure fresh
        admissions pause (_red_admission_gate); under BROWNOUT
        admission caps at pressure.brownout_admit per iteration."""
        eng = self.engine
        scanned: List[Request] = []
        admitted_now = 0
        cap = (self.cfg.pressure.brownout_admit
               if self.governor is not None
               and self.governor.level >= BROWNOUT else -1)
        while self.waiting:
            if len(self.active) >= eng.config.max_batch_size:
                break
            if 0 <= cap <= admitted_now:
                break
            req = self.waiting.popleft()
            if req.spill_key is not None:
                outcome = self._resume_from_spill(req)
                if outcome == "resumed":
                    admitted_now += 1
                    continue
                if outcome == "defer":
                    self.waiting.appendleft(req)
                    break
                # 'recompute': fall through to the normal path below
            if req.preemptions == 0 and self._red_admission_gate():
                # fresh work waits out the RED window; preempted
                # requests re-enter ahead of it (queue front)
                self.waiting.appendleft(req)
                break
            base = req.base
            if len(base) > eng.config.max_seq_len:
                # recompute target overfills the context window —
                # nothing further can be drawn
                self._finish(req, "length")
                continue
            uid = self._alloc_uid()
            try:
                _, match = eng.state.extend(uid, len(base), token_ids=base)
            except KVCacheExhaustedError:
                if not self.active:
                    # alone against an empty pool and still no fit: the
                    # prompt needs more blocks than the cache holds —
                    # permanent, not contention
                    self._finish(req, "capacity")
                    continue
                if self.cfg.admission == "fcfs":
                    self.waiting.appendleft(req)
                    break
                scanned.append(req)
                continue
            if match.cow is not None:
                # shared full-match tail: clone the page before the
                # recomputed last token writes into it
                eng._copy_block(*match.cow)
            req.uid = uid
            req.fed = eng.state.get(uid).seen_tokens  # = match.n_cached
            req.n_cached += match.n_cached
            req.state = PREFILL
            self.active.append(req)
            self.counters["admitted"] += 1
            admitted_now += 1
        for req in reversed(scanned):  # preserve arrival order
            self.waiting.appendleft(req)

    # -- dispatch construction -------------------------------------------
    def _sample_part(self, logits_dev, sample_rows, bucket: int) -> Any:
        """Device-side sampling epilogue over one dispatch's [bucket, V]
        logits (put()'s sample rows). Returns the device token tensor; the
        host copy is started by _Part and waited on at finalize."""
        eng, scfg = self.engine, self.scfg
        streams = np.zeros((bucket,), np.uint32)
        steps = np.zeros((bucket,), np.int32)
        for req, row in sample_rows:
            streams[row] = req.stream
            # draw counter = the sampled token's POSITION = seen_tokens
            # after this dispatch's commit (put()/generate() contract)
            steps[row] = eng.state.get(req.uid).seen_tokens
        keys = eng._row_keys(self.seed, streams)
        if scfg.needs_presence:
            V = self.engine.cfg.vocab_size
            pres = np.zeros((bucket, V), np.uint8)
            for req, row in sample_rows:
                pres[row] = req.presence
            return eng._sample_fn(scfg, True)(
                logits_dev, keys, eng._dev(steps), eng._dev(pres))
        return eng._sample_fn(scfg, False)(logits_dev, keys,
                                           eng._dev(steps))

    def _dispatch_wave(self, reqs: List[Request]) -> List[_Part]:
        """Whole-prompt prefill waves (put()'s grouped waves): blocks were
        reserved at admission; each wave is one batched prefill over a
        (batch-bucket, token-bucket) and samples its last-token rows on
        the device."""
        eng = self.engine
        reqs = sorted(reqs, key=lambda r: len(r.base))
        groups: Dict[int, List[Request]] = {}
        for r in reqs:
            groups.setdefault(
                _bucket(len(r.base), eng.config.min_prefill_bucket), []
            ).append(r)
        cap = 1 << (eng.config.max_batch_size.bit_length() - 1)
        waves = [g[w0:w0 + cap] for _, g in sorted(groups.items())
                 for w0 in range(0, len(g), cap)]
        parts: List[_Part] = []
        for wave in waves:
            tp = _bucket(max(len(r.base) for r in wave),
                         eng.config.min_prefill_bucket)
            bp = _bucket(len(wave), 1)
            toks_b = np.zeros((bp, tp), np.int32)
            n_real = np.zeros((bp,), np.int32)
            tables = np.zeros((bp, eng.config.blocks_per_seq), np.int32)
            for row, r in enumerate(wave):
                base = r.base
                toks_b[row, :len(base)] = base
                n_real[row] = len(base)
                tables[row] = eng.state.block_table(
                    [r.uid], eng.config.blocks_per_seq)[0]
            logits, eng.cache = eng._prefill_batch_fn(bp, tp)(
                eng.params, eng.cache, toks_b, n_real, tables)
            sample_rows = []
            for row, r in enumerate(wave):
                eng.state.commit(r.uid, len(r.base), token_ids=r.base)
                r.fed = len(r.base)
                r.state = RUNNING  # pending arrives at finalize
                sample_rows.append((r, row))
            tok_dev = self._sample_part(logits, sample_rows, bp)
            parts.append(_Part("wave", sample_rows, tok_dev))
            self.counters["wave_prefills"] += len(wave)
            self.counters["batched_tokens"] += int(n_real.sum())
        return parts

    def _dispatch_mixed(self, rows) -> Optional[_Part]:
        """One decode step over the iteration's ragged rows: 1-token decode
        rows + multi-token prefill chunk rows (the Sarathi piggyback).
        rows: [(req, chunk, sample)]. Rows of one chunk share a block
        table, so a step with any chunk takes the shared-table program
        (write #6, then plain attend #4); single-token rows only take the
        fused #5."""
        eng = self.engine
        n_rows = sum(len(c) for _, c, _ in rows)
        if n_rows == 0:
            return None
        sp = _bucket(n_rows, 8)
        toks = np.zeros((sp,), np.int32)
        ctx = np.zeros((sp,), np.int32)  # pad rows: ctx 0 = inert
        tables = np.full((sp, eng.config.blocks_per_seq),
                         eng.pad_block, np.int32)
        sample_rows: List[Tuple[Request, int]] = []
        row = 0
        for req, chunk, sample in rows:
            seq = eng.state.get(req.uid)
            base_seen = seq.seen_tokens
            table = eng.state.block_table(
                [req.uid], eng.config.blocks_per_seq, eng.pad_block)[0]
            for j, tok in enumerate(chunk):
                toks[row] = int(tok)
                ctx[row] = base_seen + j + 1
                tables[row] = table
                row += 1
            if sample:
                sample_rows.append((req, row - 1))
        unique = all(len(c) == 1 for _, c, _ in rows)
        logits, eng.cache = eng._decode_fn(sp, unique)(
            eng.params, eng.cache, toks, tables, ctx)
        # host bookkeeping overlaps the in-flight device program
        for req, chunk, sample in rows:
            eng.state.commit(req.uid, len(chunk),
                             token_ids=[int(t) for t in chunk])
            if req.state == PREFILL:
                req.fed += len(chunk)
                if req.fed == len(req.base):
                    req.state = RUNNING
        # mid-prompt chunks produce no token: skip the sample epilogue
        tok_dev = (self._sample_part(logits, sample_rows, sp)
                   if sample_rows else None)
        self.counters["batched_tokens"] += n_rows
        return _Part("mixed", sample_rows, tok_dev)

    def _dispatch_fused(self, running: List[Request], C: int) -> _Part:
        """Steady-state fused decode: C steps in one decode_multi program
        (one captured graph after warmup); sampled tokens never leave the
        device between the C steps; one [C, width] readback per chunk."""
        eng, scfg = self.engine, self.scfg
        width = _bucket(len(running), 8)
        toks = np.zeros((width,), np.int32)
        ctx = np.zeros((width,), np.int32)
        steps = np.zeros((width,), np.int32)
        streams = np.zeros((width,), np.uint32)
        tables = np.full((width, eng.config.blocks_per_seq),
                         eng.pad_block, np.int32)
        V = eng.cfg.vocab_size
        use_sampler = not (scfg.greedy and not scfg.needs_presence)
        pres_rows = (np.zeros((width, V), np.uint8)
                     if scfg.needs_presence and use_sampler else None)
        sample_rows = []
        for r, req in enumerate(running):
            seq = eng.state.get(req.uid)
            base = seq.seen_tokens
            eng.state.extend(req.uid, C)  # capacity pre-checked by caller
            toks[r] = req.pending
            ctx[r] = base + 1
            steps[r] = base + 1  # first in-chunk draw's position
            streams[r] = req.stream
            if pres_rows is not None:
                pres_rows[r] = req.presence
            sample_rows.append((req, r))
        tables[:len(running)] = eng.state.block_table(
            [r.uid for r in running], eng.config.blocks_per_seq,
            eng.pad_block)
        fn = eng.decode_multi_fn(
            width, C, sampling=scfg if use_sampler else None,
            with_presence=pres_rows is not None)
        args = [eng.params, eng.cache, toks, tables, ctx]
        if use_sampler:
            args.append(eng._row_keys(self.seed, streams))
            args.append(steps)
            if pres_rows is not None:
                args.append(pres_rows)
        gen, _, eng.cache, _ = fn(*args)
        for req in running:
            eng.state.commit(req.uid, C)
        self.counters["batched_tokens"] += len(running) * C
        self.counters["fused_steps"] += 1
        return _Part("fused", sample_rows, gen, n_steps=C)

    # -- the scheduling iteration ----------------------------------------
    def _fused_depth(self, running: List[Request]) -> int:
        """How many fused steps the steady state supports (0 = use the
        mixed single-step program)."""
        if self.cfg.decode_chunk < 2 or self._spec or not running:
            return 0
        if any(r.state != RUNNING for r in self.active):
            return 0  # prefill in flight: keep chunks interleaving
        eng = self.engine
        C = min(
            self.cfg.decode_chunk,
            min(r.max_new_tokens - len(r.output) for r in running),
            min(eng.config.max_seq_len - 1
                - eng.state.get(r.uid).seen_tokens for r in running),
        )
        if C < 2:
            return 0
        if not eng.can_schedule([r.uid for r in running],
                                [C + 1] * len(running)):
            return 0  # pressure: step singly, preempting as needed
        return C

    def _brownout(self) -> bool:
        return (self.governor is not None
                and self.governor.level >= BROWNOUT)

    def _dispatch(self) -> Optional[_Step]:
        """Build and launch one iteration; returns None when idle.
        Host-side state (commits, next tables) is updated after the
        async launch, overlapping the device program. The pressure
        governor (when enabled) updates FIRST — its level steers this
        iteration's admission cap, victim policy, and brownout
        degradations."""
        if self.governor is not None:
            self.governor.update()
        self._admit()
        if not self.active:
            return None
        self.counters["steps"] += 1
        if self._spec and not self._brownout():
            # BROWNOUT degrades speculation to plain decode: draft rows
            # burn batch capacity the pool no longer has, and greedy
            # verification == greedy decode token for token, so the
            # degradation is output-invisible
            return self._dispatch_spec()
        running = [r for r in self.active if r.state == RUNNING]
        prefill = [r for r in self.active if r.state == PREFILL]
        C = self._fused_depth(running)
        if C:
            return _Step([self._dispatch_fused(running, C)],
                         len(running) * C)
        parts: List[_Part] = []
        if prefill and self.cfg.prefill_mode == "wave":
            wave = [r for r in prefill if r.fed == 0]
            if wave:
                parts.extend(self._dispatch_wave(wave))
                prefill = [r for r in prefill if r.state == PREFILL]
        budget = self.cfg.max_num_batched_tokens
        row_budget = self.engine.config.max_batch_size
        pchunk = self.cfg.prefill_chunk
        if self._brownout():
            # shrink the prefill chunk: under brownout every reserved
            # prefill token is pool pressure the decode rows pay for
            pchunk = max(1, pchunk // self.cfg.pressure.brownout_chunk_div)
        rows: List[Tuple[Request, List[int], bool]] = []
        for req in list(running):  # oldest first; preemption takes youngest
            if budget < 1 or row_budget < 1:
                break
            if req.state != RUNNING:
                continue  # preempted/finished while reserving earlier rows
            if not self._reserve(req, 1):
                continue
            rows.append((req, [req.pending], True))
            budget -= 1
            row_budget -= 1
        for req in prefill:
            if budget < 1 or row_budget < 1:
                break
            if req.state != PREFILL:
                continue  # preempted while reserving decode rows
            remaining = req.base[req.fed:]
            c = min(pchunk, budget, row_budget, len(remaining))
            if c < 1:
                continue
            chunk = remaining[:c]
            rows.append((req, chunk, req.fed + c == len(req.base)))
            budget -= c
            row_budget -= c
        part = self._dispatch_mixed(rows)
        if part is not None:
            parts.append(part)
        if not parts:
            return None
        return _Step(parts, sum(len(c) for _, c, _ in rows))

    # -- finalize: readback + accept + retire ----------------------------
    def _accept(self, req: Request, tok: int, now: float) -> None:
        """Mirror generate()'s accept: append, then finish on EOS /
        output budget / context capacity — retiring immediately."""
        if req.first_token_t is None:
            req.first_token_t = now
        req.output.append(tok)
        if req.presence is not None and 0 <= tok < req.presence.size:
            req.presence[tok] = 1
        if req.eos_token_id is not None and tok == req.eos_token_id:
            self._finish(req, "eos")
            return
        if len(req.output) >= req.max_new_tokens:
            self._finish(req, "length")
            return
        seq = self.engine.state.get(req.uid)
        if seq.seen_tokens + 1 >= self.engine.config.max_seq_len:
            self._finish(req, "length")
            return
        req.pending = tok
        if req.handoff:
            # disaggregated prefill: first token produced, KV complete —
            # park for the router's block transfer instead of decoding
            # here. Blocks stay allocated until export; finish-path
            # cases above (EOS / budget-of-1) never reach this, so a
            # request that needs no decode never pays a transfer.
            req.state = HANDOFF
            self.active.remove(req)
            self.handoff_ready.append(req)
            self.counters["handoffs"] += 1
            return
        req.state = RUNNING

    def _finalize(self, step: _Step) -> None:
        for part in step.parts:
            if part.tok_dev is None:
                continue  # mid-prompt prefill chunks: nothing sampled
            toks = serving_readback(part.readback)
            now = time.perf_counter()
            if part.kind == "fused":
                # gen [C, width]: distribute each row's chunk in order,
                # stopping at the first finish (generate()'s mid-chunk
                # EOS contract — later tokens in the row are discarded)
                for req, r in part.sample_rows:
                    if req.done:
                        continue
                    for j in range(part.n_steps):
                        self._accept(req, int(toks[j, r]), now)
                        if req.done:
                            break
            else:
                for req, row in part.sample_rows:
                    if req.done:
                        continue  # chained lookahead of a retired row
                    self._accept(req, int(toks[row]), now)

    # -- speculative iteration (generate_speculative control plane) ------
    def _dispatch_spec(self) -> Optional[_Step]:
        """Prompt-lookup self-speculation under scheduler lifecycle:
        prefill via waves, then each iteration verifies
        [pending + drafts] chunks through engine._verify_chunks and
        accepts the greedy-consistent prefix. Synchronous per step (the
        verification IS a host decision), so no _Part machinery."""
        eng = self.engine
        prefill = [r for r in self.active if r.state == PREFILL]
        if prefill:
            # whole prompts through compiled waves; prefix-cache-hit
            # suffixes (fed > 0) through chunked decode rows
            parts: List[_Part] = []
            wave = [r for r in prefill if r.fed == 0]
            if wave:
                parts.extend(self._dispatch_wave(wave))
            rows = []
            row_budget = eng.config.max_batch_size
            for req in prefill:
                if req.state != PREFILL or row_budget < 1:
                    continue
                remaining = req.base[req.fed:]
                c = min(len(remaining), row_budget)
                rows.append((req, remaining[:c],
                             req.fed + c == len(req.base)))
                row_budget -= c
            part = self._dispatch_mixed(rows)
            if part is not None:
                parts.append(part)
            return _Step(parts, sum(len(r.base) for r in prefill))
        running = [r for r in self.active if r.state == RUNNING]
        if not running:
            return None
        ngram = int(self._spec.get("ngram", 3))
        draft_len = int(self._spec.get("draft_len", 4))
        n_live = len(running)
        per_seq = max(1, eng.config.max_batch_size // n_live)
        st = self.spec_stats
        collapsed = per_seq == 1 and draft_len > 0
        chunks: List[Tuple[Request, np.ndarray]] = []
        for req in list(running):
            if req.state != RUNNING:
                continue  # preempted while reserving earlier chunks
            # output includes the pending (undrafted) token, so the
            # draft budget is max_new - len(output) further tokens
            budget = req.max_new_tokens - len(req.output)
            k = min(draft_len, budget, per_seq - 1)
            # history INCLUDING the pending token drafts the continuation
            draft = eng._ngram_draft(req.base, ngram, k)
            room = eng.config.max_seq_len \
                - eng.state.get(req.uid).seen_tokens
            if room < 1:
                self._finish(req, "length")
                continue
            chunk = np.asarray([req.pending] + draft[:max(0, room - 1)],
                               np.int32)
            if not self._reserve(req, len(chunk)):
                continue
            chunks.append((req, chunk))
        if not chunks:
            return None
        # collapse accounting is per DISPATCHED step (counted only once
        # chunks exist), so draft_collapsed_steps can never exceed
        # steps — the invariant the stats contract promises and the
        # pre-scheduler engine loop kept
        if collapsed:
            if st["draft_collapsed_steps"] == 0:
                log_dist(
                    "speculative serving: max_batch_size "
                    f"{eng.config.max_batch_size} // {n_live} live "
                    "sequences leaves no draft rows (per_seq=1, k=0); "
                    "speculation is running as plain decode — raise "
                    "max_batch_size or lower concurrency",
                    ranks=[0],
                )
            st["draft_collapsed_steps"] += 1
        st["steps"] += 1
        st["verified_chunks"] += len(chunks)
        st["draft_tokens"] += sum(len(c) - 1 for _, c in chunks)
        all_logits = eng._verify_chunks([r.uid for r, _ in chunks],
                                        [c for _, c in chunks])
        now = time.perf_counter()
        for (req, chunk), lg in zip(chunks, all_logits):
            accepted = 1
            while (accepted < len(chunk)
                   and int(np.argmax(lg[accepted - 1]))
                   == int(chunk[accepted])):
                accepted += 1
            st["accepted_tokens"] += accepted
            eng.state.commit(req.uid, accepted,
                             token_ids=[int(t) for t in chunk[:accepted]])
            # chunk[0] == pending == output[-1]: the newly ACCEPTED
            # tokens are chunk[1:accepted] plus the next committed draw
            for t in [int(t) for t in chunk[1:accepted]] \
                    + [int(np.argmax(lg[accepted - 1]))]:
                self._accept(req, t, now)
                if req.done:
                    break
        self.counters["batched_tokens"] += sum(len(c) for _, c in chunks)
        return _Step([], 0)  # already finalized (host verification)

    # -- public driving --------------------------------------------------
    def drain_fault_delay(self) -> float:
        """Collect and reset injected straggler time (0.0 outside chaos
        runs)."""
        d, self.fault_delay_s = self.fault_delay_s, 0.0
        return d

    def step(self) -> bool:
        """One scheduling iteration (dispatch + finalize). Returns False
        when there was nothing to do. Chaos fault point
        'scheduler.step' fires BEFORE dispatch: an injected replica
        death raises with no state half-mutated (requeue is safe), an
        injected straggler delay accrues to fault_delay_s."""
        act = fault_point("scheduler.step", replica=self.replica_index)
        if act is not None and act.kind == "delay":
            self.fault_delay_s += act.value
        st = self._dispatch()
        if st is None:
            return False
        self._finalize(st)
        return True

    def _can_chain(self, step: _Step) -> bool:
        """May the NEXT iteration consume this step's device-resident
        sampled tokens directly (no host round trip between them)?
        Steady pure-decode only: one mixed part whose rows all keep
        decoding with >= 2 tokens of budget, no queue/prefill activity,
        and no presence coupling (the bitmap update needs the host
        token)."""
        if self._spec or self.scfg.needs_presence:
            return False
        if self.waiting or len(step.parts) != 1:
            return False
        part = step.parts[0]
        if part.kind != "mixed":
            return False
        if len(part.sample_rows) != len(self.active):
            return False
        # the token array feeds the next dispatch POSITIONALLY: row i of
        # the chained step reads tok_dev[i], so the previous step must
        # have sampled row i at index i (pure decode steps do; the step
        # that finished a prefill chunk samples at the chunk-end row)
        if any(row != i for i, (_, row) in enumerate(part.sample_rows)):
            return False
        if part.tok_dev.shape[0] != _bucket(max(len(part.sample_rows), 1), 8):
            return False
        eng = self.engine
        for req, _ in part.sample_rows:
            if req.state != RUNNING or req.eos_token_id is not None:
                return False
            if len(req.output) + 2 > req.max_new_tokens:
                return False
            seq = eng.state.get(req.uid)
            if seq is None or seq.seen_tokens + 2 >= eng.config.max_seq_len:
                return False
        return True

    def _dispatch_chained(self, prev: _Step) -> Optional[_Step]:
        """Launch the next pure-decode iteration feeding prev's sampled
        tokens DEVICE-RESIDENT (the [bucket] tensor is the next token
        input: a replay copies it into the graph's static token buffer on
        the stream; prev's host readback lands after this launch).
        Commits carry no token ids (the host has not seen them yet).
        Returns None when a row's block reservation forced a composition
        change (caller falls back to finalize-then-dispatch)."""
        eng = self.engine
        part = prev.parts[0]
        rows = [req for req, _ in part.sample_rows]
        sp = part.tok_dev.shape[0]
        for req in rows:
            try:
                eng.state.extend(req.uid, 1)
            except RuntimeError:
                # pressure (KVCacheExhaustedError) or a row whose KV
                # died under it mid-chain: resolve via the normal
                # path, which can preempt/spill/requeue; counted so a
                # hot chain-break loop is visible in metrics instead
                # of silently absorbed (L004)
                self.counters["chain_fallbacks"] += 1
                return None
        ctx = np.zeros((sp,), np.int32)
        tables = np.full((sp, eng.config.blocks_per_seq),
                         eng.pad_block, np.int32)
        sample_rows = []
        for r, req in enumerate(rows):
            seq = eng.state.get(req.uid)
            ctx[r] = seq.seen_tokens + 1
            tables[r] = eng.state.block_table(
                [req.uid], eng.config.blocks_per_seq, eng.pad_block)[0]
            sample_rows.append((req, r))
        logits, eng.cache = eng._decode_fn(sp, True)(
            eng.params, eng.cache, part.tok_dev, tables, ctx)
        for req in rows:
            eng.state.commit(req.uid, 1)  # token device-resident: no ids
        tok_dev = self._sample_part(logits, sample_rows, sp)
        self.counters["steps"] += 1
        self.counters["batched_tokens"] += len(rows)
        self.counters["chained_steps"] += 1
        return _Step([_Part("mixed", sample_rows, tok_dev)], len(rows))

    def run(self, tick=None) -> None:
        """Drive until idle. tick(scheduler), when given, runs once per
        iteration before admission — the arrival-injection hook the
        serving simulator uses. The loop is double-buffered: in the
        steady pure-decode state iteration N+1 is dispatched on N's
        device-resident tokens BEFORE N's readback."""
        prev: Optional[_Step] = None
        stalls = 0
        while True:
            if tick is not None:
                tick(self)
            if prev is not None and not self.waiting \
                    and self._can_chain(prev):
                nxt = self._dispatch_chained(prev)
                self._finalize(prev)  # readback overlaps nxt's compute
                prev = nxt
                continue
            if prev is not None:
                self._finalize(prev)
                prev = None
            st = self._dispatch()
            if st is None:
                if not self.has_work:
                    break
                # every active sequence was preempted/finished this
                # iteration: the next _admit makes progress (freed
                # blocks) or capacity-finishes — a third idle pass
                # with work pending is a scheduler bug, not pressure
                stalls += 1
                if stalls > 2:
                    raise RuntimeError(
                        "serving scheduler stalled with work pending "
                        f"({len(self.waiting)} waiting)")
                continue
            stalls = 0
            if st.parts:
                prev = st
        if prev is not None:
            self._finalize(prev)

    # -- observability ---------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        """Flat float counters: TTFT/TPOT percentiles (ms, host wall time
        over finished requests), queue depth, the counters, and the
        engine's decode programs run eagerly and replayed (on the GPU an
        eager run after warmup is a width warmup did not capture: the
        port's counterpart of the JAX engine's recompile count)."""
        def pct(xs, q):
            return float(np.percentile(np.asarray(xs), q) * 1e3) if xs \
                else 0.0

        m: Dict[str, float] = {
            "queue_depth": float(len(self.waiting)),
            "active": float(len(self.active)),
            "ttft_p50_ms": pct(self._ttft, 50),
            "ttft_p95_ms": pct(self._ttft, 95),
            "tpot_p50_ms": pct(self._tpot, 50),
            "tpot_p95_ms": pct(self._tpot, 95),
            "decode_eager_runs": float(self.engine.graphs.eager_runs),
            "decode_replays": float(self.engine.graphs.replays),
            "budget_findings": float(
                len(getattr(self, "budget_report").findings)
                if getattr(self, "budget_report", None) else 0),
            # KV-pool residency (engine.kv_bytes_per_token): bytes one
            # resident token costs, and whether the pool is int8
            "kv_bytes_per_token": float(self.engine.kv_bytes_per_token()),
            "kv_pool_quantized": (
                1.0 if self.engine.cache.quantized else 0.0),
        }
        # warmup-measured peak footprint per decode bucket
        fps = getattr(self.engine, "warmup_footprints", {})
        if fps:
            m["hbm_peak_mb"] = max(
                f["peak_hbm_bytes"] for f in fps.values()) / 2**20
            for w, f in sorted(fps.items()):
                m[f"hbm_w{w}_mb"] = f["peak_hbm_bytes"] / 2**20
        # pressure governor + spill tier (inference/pressure.py;
        # present only when config.pressure.enabled)
        if self.governor is not None:
            m.update(self.governor.metrics())
        if self.spill_store is not None:
            m.update(self.spill_store.stats())
        for k, v in self.counters.items():
            m[k] = float(v)
        for cls, v in sorted(self.slo_rejections.items()):
            m[f"deadline_rejections_{cls}"] = float(v)
        if self.counters["steps"]:
            m["batched_tokens_per_step"] = (
                self.counters["batched_tokens"] / self.counters["steps"])
        if self._spec:
            for k, v in self.spec_summary().items():
                m[f"spec_{k}"] = float(v)
        return m

    def spec_summary(self) -> Dict[str, float]:
        """The speculative-decoding stats with their derived rates
        folded in: mean_accepted (tokens committed per verified chunk,
        includes the guaranteed pending token, so >= 1) and
        draft_acceptance_rate (accepted DRAFT tokens / proposed draft
        tokens — the policy signal: 0 means the n-gram draft never
        lands, collapse aside). One authority for both the engine's
        generate_speculative(return_stats=True) and the router's
        per-replica reporting."""
        st = dict(self.spec_stats)
        vc = st["verified_chunks"]
        st["mean_accepted"] = st["accepted_tokens"] / vc if vc else 0.0
        # every verified chunk's slot 0 is the already-committed pending
        # token — only the remainder of `accepted` came from drafts
        drafts = st["draft_tokens"]
        st["draft_acceptance_rate"] = (
            (st["accepted_tokens"] - vc) / drafts if drafts else 0.0)
        self.spec_stats["mean_accepted"] = st["mean_accepted"]
        return st
