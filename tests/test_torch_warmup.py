"""The port engine's sampled lane and warmup held against the JAX engine,
both in f32 on the CPU, from the same numpy-made parameters.

Sampled put(return_tokens=True) (prefill waves and decode rows, with
sampling_streams, with and without the repetition penalty's presence
bitmap) and sampled decode_multi_fn (with and without presence) must give
the JAX engine's tokens for the same seed, streams and positions; the
chunked decode must equal the stepwise one; a penalty without presence
raises. warmup() must count the JAX warmup's programs for the same
arguments, leave the live cache's pages bit-identical and change no
later decode. (On a CPU engine warmup captures nothing: the CUDA graphs
are held against eager decode in tests/test_torch_cuda.py and
chip_smoke.py.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SERVE, jax_config, numpy_params, to_jax, torch_config
from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.inference.sampling import SamplingConfig as JaxSamplingConfig
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.inference.sampling import SamplingConfig, presence_from_prompts
from deepspeed_tpu_torch.utils.convert import params_from_numpy

LANE = dict(do_sample=True, temperature=0.9, top_k=40, top_p=0.95)  # the bench's
PENALTY = dict(do_sample=True, temperature=1.0, top_k=9, top_p=0.85, repetition_penalty=1.4)
VOCAB = 512


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: pytest-xdist workers share the CPU, and
    torch's own threads would oversubscribe it (restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    """Weights large enough that the logits spread over a few units: the
    draws then depend on the logits, not on the noise alone."""
    return numpy_params(jax_config(), seed=2, std=0.3)


def _port_engine():
    pc = torch_config()
    return init_inference(params_from_numpy(_tree(), pc, device="cpu"), pc, dict(SERVE),
                          dtype=torch.float32, device="cpu")


def _engines():
    jeng = jax_init_inference(to_jax(_tree()), jax_config(), dict(SERVE), dtype=jnp.float32)
    return jeng, _port_engine()


def _prompts(r, lengths):
    return [r.integers(0, VOCAB, n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("kw", [LANE, PENALTY], ids=["lane", "penalty"])
def test_sampled_put_matches_jax_engine(kw):
    """A prefill wave, then single-token decode rows and a 2-token chunk,
    every step sampled with explicit streams and presence where the
    penalty needs it: the same tokens on both engines."""
    jeng, peng = _engines()
    r = np.random.default_rng(4)
    uids = [3, 7, 11, 12]
    streams = [40, 41, 2**32 - 1, 0]
    prompts = _prompts(r, (9, 20, 5, 31))
    pres = presence_from_prompts(prompts, VOCAB, len(uids)) if "repetition_penalty" in kw else None
    call = dict(return_tokens=True, sampling=kw, seed=17, sampling_streams=streams,
                presence=pres)
    got = [(jeng.put(uids, [p.copy() for p in prompts], **call),
            peng.put(uids, [p.copy() for p in prompts], **call))]
    for step in range(4):
        last = got[-1][0]
        if pres is not None:
            pres[np.arange(len(uids)), last] = 1
        if step == 2:  # uid 7 continues with a 2-token chunk
            toks = [np.array([t], np.int32) for t in last]
            toks[1] = np.array([last[1], 5], np.int32)
        else:
            toks = [np.array([t], np.int32) for t in last]
        got.append((jeng.put(uids, [t.copy() for t in toks], **call),
                    peng.put(uids, [t.copy() for t in toks], **call)))
    for i, (j, p) in enumerate(got):
        np.testing.assert_array_equal(p, np.asarray(j), err_msg=f"put {i}")
    seq = np.stack([j for j, _ in got])
    assert len(np.unique(seq)) > 5  # the draws move


def test_sampled_tokens_ignore_batch_composition():
    """A row's draw depends on seed, stream and position only."""
    peng = _port_engine()
    r = np.random.default_rng(8)
    prompts = _prompts(r, (12, 7))
    call = dict(return_tokens=True, sampling=LANE, seed=3)
    both = peng.put([1, 2], [p.copy() for p in prompts], **call)
    solo = _port_engine()
    alone = solo.put([2], [prompts[1].copy()], **call)
    assert alone[0] == both[1]


@pytest.mark.parametrize("with_presence", [False, True], ids=["no_presence", "presence"])
def test_sampled_decode_multi_matches_jax_engine(with_presence):
    jeng, peng = _engines()
    kw = PENALTY if with_presence else LANE
    uids = [0, 1, 2]
    r = np.random.default_rng(6)
    lengths = (10, 17, 4)
    prompts = _prompts(r, lengths)
    jeng.put(uids, [p.copy() for p in prompts])
    peng.put(uids, [p.copy() for p in prompts])
    tables = peng.state.block_table(uids, peng.config.blocks_per_seq, peng.pad_block)
    ctx = np.array([peng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
    toks = np.array([7, 8, 9], np.int32)
    streams = np.array([5, 6, 7], np.uint32)
    step0 = ctx.copy()
    pres = presence_from_prompts(prompts, VOCAB, 3)
    jfn = jeng.decode_multi_fn(3, 10, sampling=JaxSamplingConfig(**kw),
                               with_presence=with_presence)
    pfn = peng.decode_multi_fn(3, 10, sampling=SamplingConfig(**kw),
                               with_presence=with_presence)
    jargs = [jnp.asarray(toks), jnp.asarray(tables), jnp.asarray(ctx),
             jeng._row_keys(11, streams), jnp.asarray(step0)]
    pargs = [toks, tables, ctx, peng._row_keys(11, streams), step0]
    if with_presence:
        jargs.append(jnp.asarray(pres))
        pargs.append(pres)
    jg, jl, jeng.cache, jp = jfn(jeng.params, jeng.cache, *jargs)
    pg, pl_, peng.cache, pp = pfn(peng.params, peng.cache, *pargs)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert (pp is None) == (not with_presence)
    if with_presence:
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    assert len(np.unique(pg.numpy())) > 5


def test_chunked_equals_stepwise():
    """decode_multi_fn(S, 8) and eight decode_multi_fn(S, 1) calls with the
    counters advanced give the same tokens: draws are keyed by (seed,
    stream, position), not by the program's depth."""
    a, b = _port_engine(), _port_engine()
    r = np.random.default_rng(9)
    lengths = (6, 13)
    prompts = _prompts(r, lengths)
    cfg = SamplingConfig(**LANE)
    out = []
    for eng, chunk in ((a, 8), (b, 1)):
        eng.put([0, 1], [p.copy() for p in prompts])
        tables = eng.state.block_table([0, 1], eng.config.blocks_per_seq, eng.pad_block)
        ctx = np.array([eng.state.get(u).seen_tokens + 1 for u in (0, 1)], np.int32)
        keys = eng._row_keys(4, np.array([0, 1], np.uint32))
        toks, gen = np.array([3, 4], np.int32), []
        fn = eng.decode_multi_fn(2, chunk, sampling=cfg)
        for i in range(0, 8, chunk):
            g, _, eng.cache, _ = fn(eng.params, eng.cache, toks, tables, ctx + i, keys, ctx + i)
            gen.append(g.numpy())
            toks = g.numpy()[-1]
        out.append(np.concatenate(gen))
    np.testing.assert_array_equal(out[0], out[1])


def test_stepwise_put_replays_decode_multi():
    """decode_multi's sampled tokens equal put(return_tokens=True) fed back
    one at a time with the same seed and streams (each draw's counter is
    its token's position on both paths)."""
    a, b = _port_engine(), _port_engine()
    r = np.random.default_rng(12)
    prompts = _prompts(r, (8, 11))
    uids = [0, 1]
    first = [a.put(uids, [p.copy() for p in prompts], return_tokens=True, sampling=LANE, seed=9),
             b.put(uids, [p.copy() for p in prompts], return_tokens=True, sampling=LANE, seed=9)]
    np.testing.assert_array_equal(first[0], first[1])
    tables = a.state.block_table(uids, a.config.blocks_per_seq, a.pad_block)
    ctx = np.array([a.state.get(u).seen_tokens + 1 for u in uids], np.int32)
    fn = a.decode_multi_fn(2, 6, sampling=SamplingConfig(**LANE))
    g, _, a.cache, _ = fn(a.params, a.cache, first[0], tables, ctx,
                          a._row_keys(9, np.array(uids, np.uint32)), ctx)
    toks, want = first[1], []
    for _ in range(6):
        toks = b.put(uids, [np.array([t], np.int32) for t in toks], return_tokens=True,
                     sampling=LANE, seed=9)
        want.append(toks)
    np.testing.assert_array_equal(g.numpy(), np.stack(want))


def test_penalty_without_presence_raises():
    peng = _port_engine()
    with pytest.raises(ValueError, match="presence"):
        peng.put([90], [np.arange(5, dtype=np.int32)], return_tokens=True,
                 sampling=dict(do_sample=True, repetition_penalty=1.2))
    assert peng.state.get(90) is None  # raised before any state changed


def test_greedy_put_tokens_are_the_logits_argmax():
    a, b = _port_engine(), _port_engine()
    r = np.random.default_rng(1)
    prompts = _prompts(r, (7, 30, 3))
    lg = a.put([0, 1, 2], [p.copy() for p in prompts])
    tok = b.put([0, 1, 2], [p.copy() for p in prompts], return_tokens=True)
    np.testing.assert_array_equal(tok, lg.argmax(-1))


WARMUPS = {
    "default": dict(footprint=False),
    "one_width_sampled": dict(sampling=LANE, widths=[8], decode_chunks=[3], footprint=False),
    "unchunked_depths": dict(widths=[8], chunked=False, decode_chunks=[0, 2, 4],
                                 footprint=False),
    "penalty_presence": dict(sampling=PENALTY, widths=[8], decode_chunks=[2], presence=True,
                             footprint=False),
}


@pytest.mark.parametrize("name", WARMUPS)
def test_warmup_counts_the_jax_programs(name):
    jeng, peng = _engines()
    want = jeng.warmup(**WARMUPS[name])
    got = peng.warmup(**WARMUPS[name])
    assert got["programs"] == want["programs"]
    assert got["widths"] == want["widths"] and got["chunks"] == want["chunks"]
    assert got["graphs"] == 0  # the CPU has no graphs
    assert peng.graphs.captures == 0


def _live_pages(eng):
    live = slice(0, eng.config.num_kv_blocks)  # the pad block is scratch
    return [x[live].clone() for x in eng.cache.k + eng.cache.v]


def test_warmup_leaves_the_live_cache_and_later_decodes_alone():
    a, b = _port_engine(), _port_engine()
    r = np.random.default_rng(5)
    lengths = (9, 26)
    prompts = _prompts(r, lengths)
    out = []
    for eng, warm in ((a, True), (b, False)):
        eng.put([0, 1], [p.copy() for p in prompts])
        before = _live_pages(eng)
        if warm:
            eng.warmup(sampling=LANE, widths=[8, 16], decode_chunks=[4], footprint=False)
            for x, y in zip(before, _live_pages(eng)):
                assert torch.equal(x, y)
            assert eng.state.get(0).seen_tokens == lengths[0]
        tables = eng.state.block_table([0, 1], eng.config.blocks_per_seq, eng.pad_block)
        ctx = np.array([eng.state.get(u).seen_tokens + 1 for u in (0, 1)], np.int32)
        g, lg, eng.cache, _ = eng.decode_multi_fn(2, 5)(eng.params, eng.cache,
                                                       np.array([1, 2], np.int32), tables, ctx)
        dec = eng.put([0, 1], [np.array([t], np.int32) for t in g.numpy()[-1]])
        out.append((g.numpy(), lg.numpy(), dec))
    for x, y in zip(*out):
        np.testing.assert_array_equal(x, y)
    assert a.graphs.eager_runs > 0 and a.graphs.replays == 0


def test_replays_only_on_the_engines_own_weights_and_cache():
    """decode_multi_fn replays a program's graph when one is registered
    under its key and the call is on the engine's weights and cache, else
    runs eagerly; refresh_params drops the graphs (a stand-in program
    replaces the CUDA graph, which the CPU has not)."""
    from deepspeed_tpu_torch.inference.graphs import GraphKey

    eng = _port_engine()
    r = np.random.default_rng(3)
    eng.put([0, 1], _prompts(r, (5, 9)))
    tables = eng.state.block_table([0, 1], eng.config.blocks_per_seq, eng.pad_block)
    ctx = np.array([6, 10], np.int32)
    toks = np.array([1, 2], np.int32)
    calls = []

    def program(*ins):
        calls.append(ins)
        return torch.zeros((3, 2), dtype=torch.int32), torch.zeros((2, VOCAB)), None

    eng.graphs.programs[GraphKey(2, 3, True, eng.config.blocks_per_seq, None, False)] = program
    fn = eng.decode_multi_fn(2, 3)
    gen, _, cache, pres = fn(eng.params, eng.cache, toks, tables, ctx)
    assert len(calls) == 1 and eng.graphs.replays == 1 and cache is eng.cache and pres is None
    assert [x.dtype for x in calls[0]] == [torch.int32] * 3
    np.testing.assert_array_equal(calls[0][1].numpy(), tables)
    fn(dict(eng.params), eng.cache, toks, tables, ctx)  # another weights dict: eager
    fn(eng.params, eng.cache, toks, tables[:, :4], ctx)  # another table width: eager
    assert len(calls) == 1 and eng.graphs.eager_runs == 2
    eng.refresh_params(eng.params)
    assert len(eng.graphs) == 0


def test_decode_workspace_is_kept_and_never_grown_in_a_capture(monkeypatch):
    """ops/cuda/paged_attention.py `_workspace`: a larger plan replaces the
    stream's workspace but keeps the old one alive (a graph may launch on
    it); under a capture it may reuse, never allocate."""
    from deepspeed_tpu_torch.ops.cuda import paged_attention as PA

    dev, stream = torch.device("cpu"), -7
    retired = len(PA._RETIRED)
    try:
        a = PA._workspace(dev, stream, 10, 10)
        assert PA._workspace(dev, stream, 10, 10) is a
        b = PA._workspace(dev, stream, 100, 10)
        assert b is not a and PA._RETIRED[-1] is a and len(PA._RETIRED) == retired + 1
        monkeypatch.setattr(PA, "_capturing", lambda device: True)
        assert PA._workspace(dev, stream, 50, 10) is b
        with pytest.raises(RuntimeError, match="before capturing"):
            PA._workspace(dev, stream, 1000, 10)
    finally:
        PA._WORKSPACE.pop((None, stream), None)
        del PA._RETIRED[retired:]
