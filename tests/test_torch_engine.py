"""Port inference engine held against the JAX engine, both in f32 on the
CPU (the JAX engine on its default CPU path, the port on the plain
versions of its kernels), from the same numpy-made parameters.

One scripted run drives both engines through prefill, single-token
put decodes, a chunked continuation, a prefix-cache hit, a prefix hit
that copies its tail block (COW), and greedy decode_multi. Logits agree
within rtol/atol 1e-4 (same math, another summation order); greedy
tokens are identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SERVE, jax_config, numpy_params, to_jax, torch_config
from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.utils.convert import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
STATS = ("lookup_hits", "lookup_misses", "cached_tokens", "prompt_tokens",
         "cow_copies", "indexed_blocks")


def _engines(seed=1):
    jc, pc = jax_config(), torch_config()
    tree = numpy_params(jc, seed=seed)
    jeng = jax_init_inference(to_jax(tree), jc, dict(SERVE), dtype=jnp.float32)
    peng = init_inference(params_from_numpy(tree, pc, device="cpu"), pc, dict(SERVE),
                          dtype=torch.float32, device="cpu")
    return jeng, peng


@pytest.fixture(scope="module")
def scripted_run():
    """Run the same put() sequence on both engines; record every step."""
    jeng, peng = _engines()
    r = np.random.default_rng(11)
    p0, p1, p2 = (r.integers(0, 512, n).astype(np.int32) for n in (20, 33, 7))
    steps = {
        "prefill": ([0, 1, 2], [p0, p1, p2]),
        "decode": ([0], [np.array([17], np.int32)]),
        "chunk": ([1], [r.integers(0, 512, 3).astype(np.int32)]),
        "decode2": ([0, 2], [np.array([3], np.int32), np.array([4], np.int32)]),
        # uid 1's first two 16-token blocks are indexed: a hit + 5-token suffix
        "prefix_hit": ([3], [np.concatenate([p1[:32], r.integers(0, 512, 5)]).astype(np.int32)]),
        # the whole prompt matches: capped at len-1, the tail block is COW'd
        "prefix_cow": ([4], [p1[:32].copy()]),
    }
    out = {}
    for name, (uids, toks) in steps.items():
        lj = jeng.put(uids, [t.copy() for t in toks])
        lp = peng.put(uids, [t.copy() for t in toks])
        out[name] = (np.asarray(lj), lp, jeng.prefix_cache_stats(), peng.prefix_cache_stats())
    uids = [0, 1, 2]
    tables = peng.state.block_table(uids, peng.config.blocks_per_seq, peng.pad_block)
    np.testing.assert_array_equal(
        tables, jeng.state.block_table(uids, jeng.config.blocks_per_seq, jeng.pad_block))
    ctx = np.array([peng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
    toks = np.array([7, 8, 9], np.int32)
    jg, jl, jeng.cache, _ = jeng.decode_multi_fn(3, 10)(
        jeng.params, jeng.cache, jnp.asarray(toks), jnp.asarray(tables), jnp.asarray(ctx))
    pg, pl_, peng.cache, _ = peng.decode_multi_fn(3, 10)(
        peng.params, peng.cache, toks, tables, ctx)
    out["decode_multi"] = (np.asarray(jg), pg.numpy(), np.asarray(jl), pl_.numpy())
    return out


@pytest.mark.parametrize("step", ["prefill", "decode", "chunk", "decode2",
                                  "prefix_hit", "prefix_cow"])
def test_put_logits_match_jax_engine(scripted_run, step):
    lj, lp, _, _ = scripted_run[step]
    assert lp.shape == lj.shape
    np.testing.assert_allclose(lp, lj, **TOL)
    assert (lp.argmax(-1) == lj.argmax(-1)).all()


@pytest.mark.parametrize("step", ["prefill", "prefix_hit", "prefix_cow"])
def test_prefix_cache_counters_match(scripted_run, step):
    _, _, sj, sp = scripted_run[step]
    assert {k: sp[k] for k in STATS} == {k: sj[k] for k in STATS}


def test_prefix_paths_were_taken(scripted_run):
    _, _, _, hit = scripted_run["prefix_hit"]
    _, _, _, cow = scripted_run["prefix_cow"]
    assert hit["lookup_hits"] == 1 and hit["cached_tokens"] == 32
    assert cow["lookup_hits"] == 2 and cow["cow_copies"] == 1


def test_decode_multi_greedy_tokens_identical(scripted_run):
    jg, pg, jl, pl_ = scripted_run["decode_multi"]
    assert pg.shape == (10, 3)
    np.testing.assert_array_equal(pg, jg)
    assert len(np.unique(pg)) > 3  # the tokens actually move
    np.testing.assert_allclose(pl_, jl, **TOL)


class TestSurface:
    def _params(self):
        return params_from_numpy(numpy_params(jax_config()), torch_config(), device="cpu")

    def test_no_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_inference(self._params(), torch_config(), dict(SERVE))

    @pytest.mark.parametrize("config,exc", [
        ({"tp_size": 2}, NotImplementedError),
        ({"kv_cache_dtype": "int8", "tp_size": 2}, NotImplementedError),
        ({"moe_census": True}, NotImplementedError),
        ({"no_such_knob": 1}, TypeError),
        ({"max_batch_size": "8"}, TypeError),
        ({"prefix_cache": {"enabled": True, "bogus": 1}}, TypeError),
        ({"kv_cache_dtype": "fp8"}, ValueError),
    ])
    def test_unknown_and_unported_knobs_raise(self, config, exc):
        with pytest.raises(exc):
            init_inference(self._params(), torch_config(), {**SERVE, **config},
                           device="cpu")

    def test_unported_entry_points_raise(self):
        eng = init_inference(self._params(), torch_config(), dict(SERVE),
                             dtype=torch.float32, device="cpu")
        # weight quantization serves (tests/test_torch_quant_weights.py); with
        # offload it raises, as offload alone does
        for kw in ({"quantization": {"bits": 8}, "offload": {"device": "cpu"}},
                   {"offload": {"device": "cpu"}}):
            with pytest.raises(NotImplementedError):
                init_inference(self._params(), torch_config(), dict(SERVE), device="cpu",
                               **kw)
        # generate() and the KV transfer are ported (tests/test_torch_scheduler.py,
        # tests/test_torch_kv_handoff.py): they serve instead of raising
        out = eng.generate([[1, 2]], max_new_tokens=3)
        assert len(out) == 1 and len(out[0]) == 3
        eng.put([0], [np.arange(20, dtype=np.int32)])
        payload = eng.export_kv(0)
        eng.import_kv(1, payload)
        assert eng.state.get(1).seen_tokens == 20

    def test_query_and_capacity(self):
        eng = init_inference(self._params(), torch_config(), dict(SERVE),
                             dtype=torch.float32, device="cpu")
        eng.put([5], [np.arange(20, dtype=np.int32)])
        q = eng.query(5)
        assert q["seen_tokens"] == 20
        assert eng.kv_bytes_per_token() == 2 * 2 * 2 * 128 * 4  # L * (K+V) * KV*D * f32
        assert eng.can_schedule([6], [SERVE["max_seq_len"]])
        assert not eng.can_schedule([6], [SERVE["max_seq_len"] + 1])
        eng.flush(5)
        assert eng.query(5)["seen_tokens"] == 0
