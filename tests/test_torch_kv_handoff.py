"""The port's KV handoff, integrity envelope, pressure governor and spill
tier held against the JAX package on the CPU.

- export_kv / import_kv round trips inside the port (f32 and int8 pools):
  the importing engine continues with the exporter's logits bit for bit;
- payloads cross the packages: a JAX engine's payload imports into the
  port's engine, which continues with the JAX engine's greedy tokens (its
  logits within 1e-4, the engine tests' pin), and the other way round,
  from f32 and int8 pools;
- kv_payload_nbytes equals the JAX engine's and the exported page bytes;
- payload_digest equals the JAX digest over the same payload, for f32,
  int8 and bf16 pages (the port carries bf16 pages as uint16 bits tagged
  "bfloat16", the JAX package as an ml_dtypes array); corrupt_payload
  flips the JAX function's bits for the same seed and invocation;
- export ships only the written blocks, as the JAX engine's does;
- import_kv refuses a corrupt payload (HandoffIntegrityError), a payload
  of another pool dtype or of int8 codes without scales
  (KvCacheDtypeError) and a payload of another geometry (ValueError),
  each before a block is allocated, each beside its genuine case;
- export_parked_kv carries the JAX engine's chains;
- PressureGovernor levels, hysteresis and counters equal the JAX
  governor's over a scripted occupancy sequence;
- HostKvSpillStore byte accounting, rejection and 'spill.io' faults equal
  the JAX store's.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import SERVE, jax_config, numpy_params, to_jax, torch_config
from deepspeed_tpu.inference import engine as JE
from deepspeed_tpu.inference import offload_store as JO
from deepspeed_tpu.inference import pressure as JP
from deepspeed_tpu.resilience import faults as JF
from deepspeed_tpu.resilience import integrity as JI
from deepspeed_tpu_torch.config.config import PressureConfig
from deepspeed_tpu_torch.inference import engine as PE
from deepspeed_tpu_torch.inference import offload_store as PO
from deepspeed_tpu_torch.inference import pressure as PP
from deepspeed_tpu_torch.resilience import faults as PF
from deepspeed_tpu_torch.resilience import integrity as PI
from deepspeed_tpu_torch.utils.convert import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 6
DTYPES = ("f32", "int8")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny engines' ops are too small to split across threads; under
    the tier-1 run's parallel workers, split ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    return numpy_params(jax_config(), seed=2)


@pytest.fixture(scope="module")
def engines(tree):
    """engines(pkg, kind): a fresh engine of that package and pool dtype
    (the JAX engines built once, their state reset)."""
    built = {}

    def get(pkg, kind):
        cfg = dict(SERVE, kv_cache_dtype="int8" if kind == "int8" else "auto")
        if pkg == "torch":
            return PE.init_inference(params_from_numpy(tree, torch_config(), device="cpu"),
                                     torch_config(), cfg, dtype=torch.float32, device="cpu")
        key = (pkg, kind)
        if key not in built:
            built[key] = JE.init_inference(to_jax(tree), jax_config(), cfg, dtype=jnp.float32)
        eng = built[key]
        c = eng.config
        eng.state = type(eng.state)(
            num_blocks=c.num_kv_blocks, block_size=c.kv_block_size,
            max_tracked=c.max_tracked_sequences, enable_prefix_cache=c.prefix_cache.enabled,
            cache_pool_blocks=c.prefix_cache.pool_blocks)
        return eng

    return get


def _prompt(n=37, seed=0):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


def _continue(eng, uid, first, steps=STEPS):
    """Greedy single-token puts from `first`: (tokens, [steps, V] logits)."""
    toks, logits, t = [], [], int(first)
    for _ in range(steps):
        lg = np.asarray(eng.put([uid], [np.array([t], np.int32)]))[0]
        logits.append(lg)
        t = int(lg.argmax())
        toks.append(t)
    return toks, np.stack(logits)


def _prefilled(eng, uid=3, n=37, seed=0):
    lg = np.asarray(eng.put([uid], [_prompt(n, seed)]))[0]
    return int(lg.argmax())


@pytest.mark.parametrize("kind", DTYPES)
def test_round_trip_continues_bit_identically(engines, kind):
    a, b = engines("torch", kind), engines("torch", kind)
    first = _prefilled(a)
    payload = a.export_kv(3)
    free = b.state.free_blocks
    b.import_kv(11, payload)
    assert b.state.get(11).seen_tokens == 37
    assert free - b.state.free_blocks == payload["n_blocks"] == 3
    want = _continue(a, 3, first)
    got = _continue(b, 11, first)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_payloads_cross_the_packages(engines, kind, direction):
    src_pkg, dst_pkg = direction.split("_to_")
    src, dst = engines(src_pkg, kind), engines(dst_pkg, kind)
    first = _prefilled(src, n=45, seed=1)
    payload = src.export_kv(3)
    dst.import_kv(5, payload)
    want_t, want_l = _continue(src, 3, first)
    got_t, got_l = _continue(dst, 5, first)
    assert got_t == want_t
    assert len(set(want_t)) > 1  # the tokens move
    np.testing.assert_allclose(got_l, want_l, **TOL)


@pytest.mark.parametrize("kind", DTYPES)
def test_payload_nbytes_matches_jax(engines, kind):
    j, p = engines("jax", kind), engines("torch", kind)
    for n in (1, 3, 8):
        assert p.kv_payload_nbytes(n) == j.kv_payload_nbytes(n)
    _prefilled(p)
    payload = p.export_kv(3)
    pages = sum(payload[k].nbytes for k in ("k", "v", "k_scale", "v_scale") if k in payload)
    assert pages == p.kv_payload_nbytes(payload["n_blocks"])


def _payload(kind, seed=0, tokens=True):
    r = np.random.default_rng(seed)
    pages = r.normal(0, 1, (2, 3, 16, 2, 8)).astype(np.float32)
    out = {"seen_tokens": 41, "n_blocks": 3, "token_ids": list(range(41)) if tokens else None}
    if kind == "int8":
        out.update(kv_dtype="int8", k=r.integers(-127, 128, pages.shape).astype(np.int8),
                   v=r.integers(-127, 128, pages.shape).astype(np.int8),
                   k_scale=r.random(pages.shape[:4]).astype(np.float32),
                   v_scale=r.random(pages.shape[:4]).astype(np.float32))
    elif kind == "bf16":
        out.update(kv_dtype="bfloat16", k=pages.astype(ml_dtypes.bfloat16),
                   v=(pages * 2).astype(ml_dtypes.bfloat16))
    else:
        out.update(kv_dtype="float32", k=pages, v=pages * 2)
    return out


def _as_port_bits(payload):
    """The port's form of a payload: bf16 pages as their uint16 bits."""
    return {k: (v.view(np.uint16) if isinstance(v, np.ndarray)
                and v.dtype == ml_dtypes.bfloat16 else v) for k, v in payload.items()}


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("tokens", [True, False], ids=["tokens", "no_tokens"])
def test_digest_matches_jax(kind, tokens):
    jp = _payload(kind, tokens=tokens)
    pp = _as_port_bits(jp)
    want = JI.payload_digest(jp)
    assert PI.payload_digest(pp) == want
    assert PI.payload_digest(jp) == want  # the JAX form verifies in the port too
    flipped = dict(pp, seen_tokens=40)
    assert PI.payload_digest(flipped) != want


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
def test_corrupt_payload_flips_match_jax(kind):
    jp = _payload(kind)
    pp = _as_port_bits(jp)
    for seed, inv in ((0, 1), (3, 2), (17, 5)):
        jout, jlog = JI.corrupt_payload(jp, seed, inv)
        pout, plog = PI.corrupt_payload(pp, seed, inv)
        assert plog == jlog
        for key in ("k", "v"):
            np.testing.assert_array_equal(np.asarray(pout[key]).view(np.uint8),
                                          np.asarray(jout[key]).view(np.uint8))
        assert PI.payload_digest(pout) != PI.payload_digest(pp)
    for bit_class in ("any", "exponent"):
        a, la = JI.flip_bits(jp["k"], 5, 1, "k", n_flips=3, bit_class=bit_class)
        b, lb = PI.flip_bits(pp["k"], 5, 1, "k", n_flips=3, bit_class=bit_class,
                             dtype_name="bfloat16" if kind == "bf16" else None)
        assert la == lb
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


def test_export_ships_only_written_blocks(engines):
    out = {}
    for pkg in ("jax", "torch"):
        eng = engines(pkg, "f32")
        _prefilled(eng, n=20)
        eng.state.extend(3, 40)  # a reservation ahead of the writes (a preemption victim's)
        payload = eng.export_kv(3)
        out[pkg] = (payload["n_blocks"], payload["seen_tokens"], payload["k"].shape,
                    payload["token_ids"], len(eng.state.get(3).blocks))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 2 and out["torch"][4] == 4


def _refusals(eng, payload, kind):
    """(case, payload, expected error) of the refused imports, each
    beside the genuine payload it was made from."""
    no_scales = {k: v for k, v in payload.items() if k not in ("k_scale", "v_scale", "digest")}
    no_scales["digest"] = PI.payload_digest(no_scales)
    narrow = dict(payload, k=payload["k"][..., :64], v=payload["v"][..., :64])
    narrow["digest"] = PI.payload_digest(narrow)
    as_int8 = dict(payload, kv_dtype="int8")
    as_int8["digest"] = PI.payload_digest(as_int8)
    cases = [("corrupt", PI.corrupt_payload(payload, 1, 1)[0], PI.HandoffIntegrityError),
             ("geometry", narrow, ValueError)]
    if kind == "int8":
        cases.append(("no_scales", no_scales, PE.KvCacheDtypeError))
    else:
        cases.append(("dtype", as_int8, PE.KvCacheDtypeError))
    return cases


@pytest.mark.parametrize("kind", DTYPES)
def test_import_refusals_come_before_allocation(engines, kind):
    a = engines("torch", kind)
    _prefilled(a)
    payload = a.export_kv(3)
    for name, bad, err in _refusals(a, payload, kind):
        b = engines("torch", kind)
        free = b.state.free_blocks
        with pytest.raises(err):
            b.import_kv(9, bad)
        assert b.state.free_blocks == free and b.state.get(9) is None, name
        b.import_kv(9, payload)  # the genuine payload lands
        assert b.state.get(9).seen_tokens == 37, name
    f32 = engines("torch", "f32" if kind == "int8" else "int8")
    with pytest.raises(PE.KvCacheDtypeError):
        f32.import_kv(9, payload)  # a pool of the other dtype


def test_handoff_payload_fault_corrupts_and_is_caught(engines):
    a = engines("torch", "f32")
    _prefilled(a)
    payload = a.export_kv(3)
    b = engines("torch", "f32")
    plan = {"faults": [{"point": "handoff.payload", "kind": "corrupt"}], "seed": 4}
    with PF.armed(plan) as p:
        with pytest.raises(PI.HandoffIntegrityError):
            b.import_kv(2, payload)
        b.import_kv(2, payload)  # the spec fired once
    assert p.fired == ["handoff.payload#1:corrupt:corrupt"]
    assert b.state.get(2).seen_tokens == 37


def test_export_parked_kv_matches_jax(engines):
    out = {}
    for pkg in ("jax", "torch"):
        eng = engines(pkg, "f32")
        _prefilled(eng, uid=4, n=50)
        eng.flush(4)  # its 3 full blocks park in the prefix cache
        out[pkg] = eng.export_parked_kv(4)
    assert [(p["n_blocks"], p["seen_tokens"], p["token_ids"]) for p in out["torch"]] == \
        [(p["n_blocks"], p["seen_tokens"], p["token_ids"]) for p in out["jax"]]
    for pp, jp in zip(out["torch"], out["jax"]):
        np.testing.assert_allclose(pp["k"], jp["k"], **TOL)
    b = engines("torch", "f32")
    b.import_kv(8, out["torch"][0])
    b.flush(8)
    b.put([1], [_prompt(50)])
    assert b.prefix_cache_stats()["lookup_hits"] == 1


class _Alloc:
    def __init__(self, total):
        self.total_blocks, self.available_blocks = total, total


class _State:
    def __init__(self, total):
        self.allocator, self.parked, self.trims = _Alloc(total), 5, []

    def trim_parked(self, n):
        k = min(n, self.parked)
        self.parked -= k
        self.trims.append(k)
        return k


class _Engine:
    def __init__(self, total, footprints):
        self.state, self.warmup_footprints = _State(total), footprints


OCCUPANCY = (0.1, 0.5, 0.66, 0.7, 0.86, 0.9, 0.84, 0.8, 0.79, 0.96, 0.93, 0.9, 0.6, 0.55,
             0.3, 0.1, 0.97, 0.0, 0.0, 0.0)


@pytest.mark.parametrize("budget,peak", [(0, 0), (100, 70), (100, 95)],
                         ids=["unscaled", "within_headroom", "scaled"])
def test_pressure_governor_matches_jax(budget, peak):
    from deepspeed_tpu.config.config import PressureConfig as JPC

    fps = {8: {"peak_hbm_bytes": float(peak)}} if peak else {}
    kw = dict(enabled=True, yellow_trim_blocks=2)
    runs = {}
    for name, mod, cfg in (("jax", JP, JPC(**kw)), ("torch", PP, PressureConfig(**kw))):
        eng = _Engine(100, fps)
        gov = mod.PressureGovernor(cfg, eng, budget_bytes=budget)
        levels = []
        for occ in OCCUPANCY:
            eng.state.allocator.available_blocks = round(100 * (1 - occ))
            levels.append(gov.update())
        runs[name] = (levels, gov.metrics(), eng.state.trims, gov.watermark_scale())
    assert runs["torch"] == runs["jax"]
    levels = runs["torch"][0]
    assert PP.BROWNOUT in levels and levels[-1] < PP.RED  # up fast, down one at a time


def _spill_ops(store_mod, faults, plan=None):
    """One scripted run of the spill store: puts past the budget, a get, a
    restore, a discard and a drain, under `plan`; returns every outcome."""
    store = store_mod.HostKvSpillStore(3000)
    mk = lambda n: {"k": np.zeros((n,), np.uint8), "v": np.zeros((n,), np.uint8),
                    "seen_tokens": n}
    log = []

    def op(name, fn):
        try:
            log.append((name, fn()))
        except faults.InjectedFault as e:
            log.append((name, type(e).__name__, isinstance(e, OSError)))

    def run():
        op("put0", lambda: store.put(0, mk(600)))
        op("put1", lambda: store.put(1, mk(800)))
        op("put2", lambda: store.put(2, mk(200)))   # past the budget: rejected
        op("put3", lambda: store.put(3, mk(50)))
        op("get1", lambda: sorted(store.get(1) or {}))
        op("restore1", lambda: store.restore(1, mk(800)))
        op("get9", lambda: store.get(9))
        op("discard0", lambda: store.discard(0))
        op("put4", lambda: store.put(4, mk(500)))
        log.append(("stats", store.stats()))
        op("drain", store.drain)
        log.append(("stats", store.stats()))

    if plan is None:
        run()
    else:
        with faults.armed(faults.FaultPlan(plan)):
            run()
    return log


@pytest.mark.parametrize("plan", [None, [{"point": "spill.io", "kind": "raise", "error": "io",
                                          "where": {"op": "put"}, "at": 2}],
                                  [{"point": "spill.io", "kind": "raise", "error": "io",
                                    "where": {"op": "get", "key": 1}}]],
                         ids=["plain", "put_fault", "get_fault"])
def test_spill_store_matches_jax(plan):
    want = _spill_ops(JO, JF, plan)
    got = _spill_ops(PO, PF, plan)
    assert got == want
    if plan is None:
        assert ("put2", False) in got
    else:
        assert any(len(x) == 3 and x[1] == "InjectedIOError" and x[2] for x in got)
