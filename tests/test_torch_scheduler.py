"""The port's serving scheduler held against the JAX package's on the CPU.

The tiny Llama form of tests/test_scheduler.py (vocab 128, 2 layers, 4
heads, d_model 64, f32, 8-token KV blocks, 32 blocks), with the same
numpy-made weights in both packages. Each case drives the JAX
`ServingScheduler` and the port's with the same prompts, configs and
arrival script; per request the tokens and finish reasons must be equal,
and so must the host-logic `counters`, `spec_stats` and SLO rejections
(the two schedulers take the same decisions: admission, chunking,
preemption, spill and resume, chaining, fusing, speculation). Cases:
chunked prefill, staggered arrivals, preemption, sampling (with a
repetition penalty too: the presence bitmaps), EOS
retirement, the fused steady state, chained steps, skip admission, an
oversized prompt, a prompt bigger than the pool, speculation, handoff to
a second engine's scheduler (export_kv, adopt), deadlines
and SLO classes, the starvation bound, spill-resume (greedy and
sampled), the spill fault, corrupt-spill and zero-budget fallbacks, and
`generate`, `generate_speculative` and `sample_token` of both engines.

Each package's engine is built once for the module (the JAX engine's
programs compile once) and each case starts from a fresh StateManager. A
case on a smaller pool, or without the prefix cache, gets a StateManager
over the first N of the engine's 32 blocks (the scratch block stays the
33rd): after init nothing but the allocator reads the pool's size, in
either package. Torch runs single-threaded here: the tiny model's ops
are too small to split, and under the tier-1 run's parallel workers
split ops wait on each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_config, numpy_params, to_jax, torch_config
from deepspeed_tpu.inference import engine as JE
from deepspeed_tpu.inference import ragged as JR
from deepspeed_tpu.inference import scheduler as JS
from deepspeed_tpu.resilience import faults as JF
from deepspeed_tpu_torch.inference import engine as PE
from deepspeed_tpu_torch.inference import ragged as PR
from deepspeed_tpu_torch.inference import scheduler as PS
from deepspeed_tpu_torch.resilience import faults as PF
from deepspeed_tpu_torch.utils.convert import params_from_numpy

SCHED_TINY = dict(vocab_size=128, n_layers=2, n_heads=4, d_model=64, max_seq=64,
                  variant="llama")
BASE = dict(max_seq_len=64, kv_block_size=8, num_kv_blocks=32, min_prefill_bucket=8,
            max_batch_size=8)
STD = 0.3  # greedy tokens vary at this weight scale
# the speculation cases' weights: at 0.08 greedy decoding repeats itself,
# so prompt-lookup drafts are accepted
SPEC_STD = 0.08
PKGS = {"jax": (JS, JR, JF), "torch": (PS, PR, PF)}
# the pressure governor's watermarks of the spill cases: a 6-block pool
# reaches RED while sequences grow, so victims spill and resume
PRESSURE = dict(enabled=True, yellow=0.6, red=0.7, brownout=1.0)


def _models(std):
    tree = numpy_params(jax_config(**SCHED_TINY), seed=0, std=std)
    return to_jax(tree), params_from_numpy(tree, torch_config(**SCHED_TINY), device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """engines(pkg, std=STD, pool=None, prefix=True): that package's
    engine of those weights, built once, with a fresh StateManager each
    call over `pool` blocks (None: all 32), the prefix cache on or off."""
    built = {}

    def get(pkg, std=STD, pool=None, prefix=True):
        key = (pkg, std)
        if key not in built:
            jax_params, port_params = _models(std)
            if pkg == "jax":
                built[key] = JE.init_inference(jax_params, jax_config(**SCHED_TINY), dict(BASE),
                                               dtype=jnp.float32)
            else:
                built[key] = PE.init_inference(port_params, torch_config(**SCHED_TINY),
                                               dict(BASE), dtype=torch.float32, device="cpu")
        eng = built[key]
        c = eng.config
        eng.state = PKGS[pkg][1].StateManager(
            num_blocks=pool or c.num_kv_blocks, block_size=c.kv_block_size,
            max_tracked=c.max_tracked_sequences, enable_prefix_cache=prefix,
            cache_pool_blocks=c.prefix_cache.pool_blocks)
        return eng

    return get


def _prompts(lens=(6, 9, 4), seed=0):
    r = np.random.default_rng(seed)
    return [[int(t) for t in r.integers(0, 128, n)] for n in lens]


def _result(s, rids, **extra):
    fin = [s.finished[r] for r in rids]
    return {"tokens": [list(map(int, f.output)) for f in fin],
            "reasons": [f.finish_reason for f in fin], "counters": dict(s.counters),
            "spec": {k: float(v) for k, v in s.spec_stats.items()},
            "slo": dict(s.slo_rejections), **extra}


def _sched(pkg, eng, cfg, **kw):
    mod = PKGS[pkg][0]
    return mod.ServingScheduler(eng, mod.ServingSchedulerConfig(**dict(cfg, warmup=False)), **kw)


def _drive(pkg, engines, cfg, prompts, new=10, geometry=None, eos=None, plan=None,
           submit=None, **kw):
    """Submit every prompt (submit(s, i, p) -> rid when given) and run to
    the end, under the fault plan `plan` of this package when given."""
    s = _sched(pkg, engines(pkg, **(geometry or {})), cfg, **kw)
    rids = [submit(s, i, p) if submit else s.submit(p, new, eos_token_id=eos)
            for i, p in enumerate(prompts)]
    faults = PKGS[pkg][2]
    if plan is not None:
        with faults.armed(faults.FaultPlan(plan, seed=3)) as armed_plan:
            s.run()
        return _result(s, rids, fired=list(armed_plan.fired))
    s.run()
    return _result(s, rids)


def _staggered(pkg, engines):
    prompts = _prompts((6, 9, 4, 7))
    s = _sched(pkg, engines(pkg), dict(prefill_chunk=4, max_num_batched_tokens=8))
    rids = [s.submit(prompts[0], 6, stream=0)]
    pending = list(enumerate(prompts))[1:]

    def tick(sc):  # one arrival every other iteration, mid-generation
        if pending and sc.counters["steps"] % 2 == 0:
            i, p = pending.pop(0)
            rids.append(sc.submit(p, 6, stream=i))

    s.run(tick=tick)
    while pending:
        i, p = pending.pop(0)
        rids.append(s.submit(p, 6, stream=i))
        s.run(tick=tick)
    return _result(s, rids)


def _stepwise(pkg, engines):
    """The chained-steps case driven by step() (no chaining) beside run()."""
    cfg = dict(prefill_chunk=8, max_num_batched_tokens=16, decode_chunk=1)
    a = _drive(pkg, engines, cfg, _prompts((6, 9)), new=10)
    s = _sched(pkg, engines(pkg), cfg)
    rids = [s.submit(p, 10) for p in _prompts((6, 9))]
    while s.has_work:
        s.step()
    return {"run": a, "step": _result(s, rids)}


def _skip_admission(pkg, engines):
    out = {}
    for policy in ("skip", "fcfs"):
        s = _sched(pkg, engines(pkg, pool=7, prefix=False),
                   dict(admission=policy, prefill_chunk=8, max_num_batched_tokens=64))
        r = np.random.default_rng(1)
        big = s.submit([int(t) for t in r.integers(0, 128, 33)], 6)
        s.step()
        huge = s.submit([int(t) for t in r.integers(0, 128, 33)], 2)
        tiny = s.submit([int(t) for t in r.integers(0, 128, 4)], 2)
        s.step()
        active = sorted(q.rid for q in s.active)
        s.run()
        out[policy] = _result(s, [big, huge, tiny], active_after_two_steps=active)
    return out


def _eos(pkg, engines):
    probe = _drive(pkg, engines, dict(prefill_chunk=3, max_num_batched_tokens=8),
                   _prompts((6, 9, 4)), new=8)
    eos = probe["tokens"][0][2]
    return _drive(pkg, engines, dict(prefill_chunk=3, max_num_batched_tokens=8),
                  _prompts((6, 9, 4)), new=8, eos=eos)


def _capacity(pkg, engines):
    s = _sched(pkg, engines(pkg, pool=2, prefix=False), {})
    r = np.random.default_rng(2)
    rids = [s.submit([int(t) for t in r.integers(0, 128, 30)], 4),
            s.submit([int(t) for t in r.integers(0, 128, 5)], 2)]
    s.run()
    return _result(s, rids)


def _handoff_adopt(pkg, engines):
    """Disaggregated serving's hand-off: requests submitted with
    handoff=True park in handoff_ready after their first token; their KV
    leaves by export_kv (flushed behind it) and comes back by a second
    scheduler's adopt(), which finishes them. Also the plain run of the
    same requests."""
    cfg = dict(prefill_chunk=4, max_num_batched_tokens=16)
    prompts = _prompts((6, 9, 4))
    eng = engines(pkg)
    prefill, decode = _sched(pkg, eng, cfg), _sched(pkg, eng, cfg)
    rids = [prefill.submit(p, 8, stream=i, handoff=True) for i, p in enumerate(prompts)]
    prefill.run()
    parked = list(prefill.handoff_ready)
    for req in parked:
        payload = eng.export_kv(req.uid)
        eng.flush(req.uid)
        decode.adopt(req, payload)
    decode.run()
    plain = _drive(pkg, engines, cfg, prompts, new=8)
    return {"parked": [r.rid for r in parked], "outputs": [list(map(int, r.output))
                                                            for r in parked],
            "prefill": dict(prefill.counters), "decode": dict(decode.counters),
            "plain": plain["tokens"], "rids": rids}


def _slo(pkg, engines):
    """A burst of long prompts with SLO classes and direct deadlines: the
    queue-depth TTFT estimate rejects the unservable ones at submit."""
    cfg = dict(prefill_chunk=4, max_num_batched_tokens=8,
               slo_classes={"premium": 0.02, "batch": 5.0})
    prompts = _prompts((40, 40, 40, 12, 30, 8), seed=4)
    classes = ["batch", "premium", "batch", "premium", None, None]
    deadlines = [None, None, None, None, 0.001, None]

    def submit(s, i, p):
        return s.submit(p, 4, deadline_s=deadlines[i], slo_class=classes[i])

    return _drive(pkg, engines, cfg, prompts, submit=submit)


def _starvation(pkg, engines):
    """Six sequences on a 6-block pool with max_preemptions 1: victims
    become protected and requesters yield."""
    return _drive(pkg, engines, dict(prefill_chunk=3, max_num_batched_tokens=8,
                                     max_preemptions=1),
                  _prompts((7,) * 6, seed=5), new=12,
                  geometry=dict(pool=6))


def _spill(sampled=False, plan=None, **pressure):
    def case(pkg, engines):
        kw = dict(sampling=dict(do_sample=True, temperature=0.9, top_k=12), seed=7) \
            if sampled else {}
        return _drive(pkg, engines,
                      dict(prefill_chunk=3, max_num_batched_tokens=16,
                           pressure=dict(PRESSURE, **pressure)),
                      _prompts((6, 9, 4, 12, 7)), new=12, geometry=dict(pool=6),
                      plan=plan, **kw)
    return case


CASES = {
    "chunked_prefill": lambda pkg, e: _drive(
        pkg, e, dict(prefill_chunk=3, max_num_batched_tokens=8), _prompts()),
    "staggered_arrivals": _staggered,
    "preemption": lambda pkg, e: _drive(
        pkg, e, dict(prefill_chunk=3, max_num_batched_tokens=8), _prompts(), new=10,
        geometry=dict(pool=6)),
    "sampled": lambda pkg, e: _drive(
        pkg, e, dict(prefill_chunk=4, max_num_batched_tokens=16), _prompts(), new=7,
        sampling=dict(do_sample=True, temperature=0.9, top_k=12), seed=7),
    "sampled_repetition_penalty": lambda pkg, e: _drive(
        pkg, e, dict(prefill_chunk=4, max_num_batched_tokens=16, decode_chunk=4),
        _prompts(), new=9, sampling=dict(do_sample=True, temperature=0.9, top_k=12,
                                         repetition_penalty=1.3), seed=5),
    "eos_retirement": _eos,
    "fused_steady_state": lambda pkg, e: _drive(
        pkg, e, dict(prefill_chunk=8, max_num_batched_tokens=16, decode_chunk=4),
        _prompts((6, 4)), new=9),
    "chained_steps": _stepwise,
    "skip_admission": _skip_admission,
    "prompt_bigger_than_pool": _capacity,
    "speculation": lambda pkg, e: _drive(
        pkg, e, dict(prefill_mode="wave"), [(_prompts((6,))[0] * 4)[:22], _prompts((9,))[0]],
        new=10, geometry=dict(std=SPEC_STD), speculative={"ngram": 2, "draft_len": 4}),
    "deadlines_and_slo_classes": _slo,
    "handoff_and_adopt": _handoff_adopt,
    "starvation_bound": _starvation,
    "spill_resume_greedy": _spill(),
    "spill_resume_sampled": _spill(sampled=True),
    "spill_fault": _spill(plan=[{"point": "spill.io", "kind": "raise", "error": "io",
                                 "where": {"op": "put"}, "at": 1, "times": 1}]),
    "spill_get_fault": _spill(plan=[{"point": "spill.io", "kind": "raise", "error": "io",
                                     "where": {"op": "get"}, "at": 1, "times": 1}]),
    "corrupt_spill": _spill(plan=[{"point": "handoff.payload", "kind": "corrupt", "at": 1,
                                   "times": 1}]),
    "zero_budget_spill": _spill(spill_host_mb=0.0),
}
# what each case must exercise, so that an equal result is not an empty one
EXERCISES = {
    "preemption": ("preemptions",), "fused_steady_state": ("fused_steps",),
    "spill_resume_greedy": ("spills", "spill_resumes"),
    "spill_resume_sampled": ("spills", "spill_resumes"),
    "spill_fault": ("spill_fallbacks",), "spill_get_fault": ("spill_fallbacks",),
    "corrupt_spill": ("spill_integrity_failures",), "zero_budget_spill": ("spill_rejects",),
    "deadlines_and_slo_classes": ("deadline_rejections",),
    "starvation_bound": ("starvation_protected",),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_scheduler_matches_the_jax_scheduler(engines, case):
    want = CASES[case]("jax", engines)
    got = CASES[case]("torch", engines)
    assert got == want
    for counter in EXERCISES.get(case, ()):
        assert want["counters"][counter] > 0, (case, counter, want["counters"])
    if case == "chained_steps":
        assert want["run"]["counters"]["chained_steps"] > 0
        assert want["step"]["counters"]["chained_steps"] == 0
        assert want["run"]["tokens"] == want["step"]["tokens"]
    if case == "speculation":
        assert want["spec"]["accepted_tokens"] > want["spec"]["verified_chunks"]
    if case == "skip_admission":
        assert want["skip"]["active_after_two_steps"] != want["fcfs"]["active_after_two_steps"]
    if case == "handoff_and_adopt":
        assert len(want["parked"]) == 3 and want["decode"]["adopted"] == 3
        assert want["outputs"] == want["plain"]  # the moved KV continues exactly
    if case == "prompt_bigger_than_pool":
        assert want["reasons"][0] == "capacity" and want["tokens"][0] == []


def test_every_request_ends_and_the_pool_drains(engines):
    """Spill-resume under pressure leaves no live block and no spilled
    byte; every request ends by length with its token count."""
    eng = engines("torch", pool=6)
    s = _sched("torch", eng, dict(prefill_chunk=3, max_num_batched_tokens=16,
                                  pressure=PRESSURE))
    rids = [s.submit(p, 12) for p in _prompts((6, 9, 4, 12, 7))]
    s.run()
    assert all(s.finished[r].finish_reason == "length" and len(s.finished[r].output) == 12
               for r in rids)
    assert eng.state.allocator.available_blocks == eng.state.allocator.total_blocks == 6
    assert s.spill_store.used_bytes == 0 and s.counters["spill_resumes"] > 0


def test_oversized_prompt_raises_in_both(engines):
    for pkg in PKGS:
        s = _sched(pkg, engines(pkg), {})
        with pytest.raises(ValueError, match="max_seq_len"):
            s.submit(list(range(65)), 4)


@pytest.mark.parametrize("kw", [dict(), dict(do_sample=True, temperature=0.8, top_k=20,
                                             top_p=0.9, seed=11)], ids=["greedy", "seeded"])
def test_generate_matches(engines, kw):
    prompts = _prompts((6, 9, 4, 11))
    want = engines("jax").generate(prompts, max_new_tokens=9, **kw)
    got = engines("torch").generate(prompts, max_new_tokens=9, **kw)
    assert got == [[int(t) for t in o] for o in want]


def test_generate_speculative_matches(engines):
    prompts = [(_prompts((6,))[0] * 4)[:22], _prompts((7,), seed=3)[0]]
    want, wst = engines("jax", std=SPEC_STD).generate_speculative(
        prompts, max_new_tokens=10, ngram=2, draft_len=4, return_stats=True)
    got, gst = engines("torch", std=SPEC_STD).generate_speculative(
        prompts, max_new_tokens=10, ngram=2, draft_len=4, return_stats=True)
    assert got == want and gst == wst
    assert wst["accepted_tokens"] > wst["verified_chunks"]
    assert got == engines("torch", std=SPEC_STD).generate(prompts, max_new_tokens=10)


@pytest.mark.parametrize("kw", [
    dict(temperature=0.0),
    dict(temperature=0.7, top_k=5),
    dict(temperature=1.3, top_p=0.8),
    dict(temperature=0.9, top_k=30, top_p=0.95, repetition_penalty=1.3,
         seen_tokens=[3, 7, 7, 40]),
], ids=["greedy", "top_k", "top_p", "all"])
def test_sample_token_matches(kw):
    logits = np.random.default_rng(6).normal(0, 2, (64,)).astype(np.float32)
    want = [JE.InferenceEngine.sample_token(logits, rng=np.random.default_rng(s), **kw)
            for s in range(12)]
    got = [PE.InferenceEngine.sample_token(logits, rng=np.random.default_rng(s), **kw)
           for s in range(12)]
    assert got == want


def test_config_validation_matches():
    from deepspeed_tpu.config.config import ServingSchedulerConfig as JC
    from deepspeed_tpu_torch.config import ServingSchedulerConfig as PC

    for bad in (dict(admission="lifo"), dict(prefill_mode="eager"), dict(decode_chunk=0),
                dict(slo_classes={"a": -1.0}), dict(pressure={"red": 0.5, "yellow": 0.7}),
                dict(max_preemptions=-1)):
        with pytest.raises(ValueError):
            JC(**bad)
        with pytest.raises(ValueError):
            PC(**bad)
    with pytest.raises(TypeError):
        PC(no_such_knob=1)
    with pytest.raises(TypeError):
        PC(pressure={"enabled": "yes"})
    assert PC().pressure.spill_host_mb == JC().pressure.spill_host_mb
