"""Port model layer (deepspeed_tpu_torch/models + inference/model.py) held
against the JAX package: the config and init surface, and prefill /
decode logits from the same numpy-made parameters, in f32 at rtol/atol
1e-4 (the same math; matrix products and transcendental functions summed
and rounded in another order by XLA and by PyTorch on the CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_config, numpy_params, to_jax, torch_config
from deepspeed_tpu.inference import model as JM
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu_torch.inference import model as PM
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.utils.convert import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)


class TestConfigAndInit:
    def test_same_fields_and_derived_sizes(self):
        assert ([f.name for f in dataclasses.fields(PT.TransformerConfig)]
                == [f.name for f in dataclasses.fields(JT.TransformerConfig)])
        for over in ({}, {"n_kv_heads": 1}, {"variant": "gpt2"}, {"d_ff": 384}):
            jc, pc = jax_config(**over), torch_config(**over)
            assert (pc.kv_heads, pc.head_dim, pc.ff_dim) == (jc.kv_heads, jc.head_dim, jc.ff_dim)
            assert PT.param_count(pc) == JT.param_count(jc)
            np.testing.assert_allclose(PT.rope_inv_freq(pc).numpy(),
                                       np.asarray(JT.rope_inv_freq(jc)), rtol=1e-6)

    def test_flagship_param_count(self):
        flagship = dict(vocab_size=32000, n_layers=24, n_heads=8, d_model=1024,
                        max_seq=2048, variant="llama")
        n = PT.param_count(PT.TransformerConfig(**flagship))
        assert n == JT.param_count(JT.TransformerConfig(**flagship)) == 341_099_520

    def test_init_leaf_names_and_shapes_match(self):
        jc, pc = jax_config(n_kv_heads=1), torch_config(n_kv_heads=1)
        jp = JT.init(jc, jax.random.PRNGKey(0))
        pp = PT.init(pc, torch.Generator().manual_seed(0), device="cpu")
        assert sorted(pp) == sorted(jp)
        assert {k: tuple(v.shape) for k, v in pp["layers"].items()} == \
               {k: tuple(v.shape) for k, v in jp["layers"].items()}
        assert pp["embed"].shape == jp["embed"].shape

    @pytest.mark.parametrize("bad", [
        {"remat": "bogus"}, {"variant": "t5"}, {"rope_scaling_type": "yarn"},
        {"shared_ln": True}, {"attention_window_pattern": (0, 8, 8)},
    ])
    def test_post_init_checks_match(self, bad):
        with pytest.raises(ValueError):
            jax_config(**bad)
        with pytest.raises(ValueError):
            torch_config(**bad)

    @pytest.mark.parametrize("over", [
        {"n_experts": 2}, {"sliding_window": 8}, {"alibi": True},
        {"variant": "gpt2"}, {"attention_impl": "sparse"}, {"use_flash": False},
    ])
    def test_unserved_configs_raise(self, over):
        with pytest.raises(NotImplementedError):
            PM.check_served(torch_config(**over))

    def test_convert_rejects_mismatched_tree(self):
        cfg = jax_config()
        tree = numpy_params(cfg)
        tree["layers"]["wq"] = tree["layers"]["wq"][:, :, :1]
        with pytest.raises(ValueError, match="wq"):
            params_from_numpy(tree, torch_config(), device="cpu")
        tree = numpy_params(cfg)
        del tree["ln_f_scale"]
        with pytest.raises(ValueError, match="ln_f_scale"):
            params_from_numpy(tree, torch_config(), device="cpu")


@pytest.fixture(scope="module")
def pair():
    jc, pc = jax_config(n_kv_heads=1), torch_config(n_kv_heads=1)  # GQA, G = 2
    tree = numpy_params(jc, seed=3)
    jparams = JM.prepare(to_jax(tree), jc)
    pparams = PM.prepare(params_from_numpy(tree, pc, device="cpu"), pc)
    return jc, pc, jparams, pparams


def _caches(jc, pc, nblk=24, bs=16):
    return (JM.init_cache(jc, nblk, bs, jnp.float32),
            PM.init_cache(pc, nblk, bs, torch.float32, torch.device("cpu")))


def _cache_close(jcache, pcache):
    for a, b in zip(jcache.k + jcache.v, pcache.k + pcache.v):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


class TestForwardParity:
    def _prefill(self, pair, rng):
        jc, pc, jp, pp = pair
        B, Tp, NB = 3, 48, 4
        toks = rng.integers(0, jc.vocab_size, (B, Tp)).astype(np.int32)
        n_real = np.array([48, 17, 0], np.int32)  # last row is batch padding
        tables = np.arange(B * NB, dtype=np.int32).reshape(B, NB)
        jcache, pcache = _caches(jc, pc)
        jl, jcache = JM.prefill_batch(jp, jcache, jnp.asarray(toks), jnp.asarray(n_real),
                                      jnp.asarray(tables), jc, use_kernel=False)
        pl_, pcache = PM.prefill_batch(pp, pcache, torch.from_numpy(toks),
                                       torch.from_numpy(n_real), torch.from_numpy(tables), pc)
        return jl, pl_, jcache, pcache, tables, n_real

    def test_prefill_logits_and_cache(self, pair, rng):
        jl, pl_, jcache, pcache, _, _ = self._prefill(pair, rng)
        np.testing.assert_allclose(pl_[:2].numpy(), np.asarray(jl)[:2], **TOL)
        _cache_close(jcache, pcache)

    @pytest.mark.parametrize("unique_rows", [True, False])
    def test_decode_step_logits_and_cache(self, pair, rng, unique_rows):
        jc, pc, jp, pp = pair
        _, _, jcache, pcache, tables, n_real = self._prefill(pair, rng)
        # rows 0, 1 continue prompts 0, 1; row 2 is padding (ctx 0)
        toks = rng.integers(0, jc.vocab_size, (3,)).astype(np.int32)
        ctx = np.array([49, 18, 0], np.int32)
        tb = tables.copy()
        tb[2] = 23  # pad rows' tables point at a scratch block
        jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(toks), jnp.asarray(tb),
                                    jnp.asarray(ctx), jc, use_kernel=False,
                                    unique_rows=unique_rows)
        pl_, pcache = PM.decode_step(pp, pcache, torch.from_numpy(toks), torch.from_numpy(tb),
                                     torch.from_numpy(ctx), pc, use_kernel=True,
                                     unique_rows=unique_rows)
        np.testing.assert_allclose(pl_[:2].numpy(), np.asarray(jl)[:2], **TOL)
        _cache_close(jcache, pcache)

    def test_decode_multi_tokens_identical(self, pair, rng):
        jc, pc, jp, pp = pair
        _, _, jcache, pcache, tables, _ = self._prefill(pair, rng)
        toks = np.array([5, 9, 0], np.int32)
        ctx = np.array([49, 18, 0], np.int32)
        tb = tables.copy()
        tb[2] = 23
        jg, jl, _, _ = JM.decode_multi(jp, jcache, jnp.asarray(toks), jnp.asarray(tb),
                                       jnp.asarray(ctx), jc, n_steps=8, use_kernel=False)
        pg, pl_, _, _ = PM.decode_multi(pp, pcache, torch.from_numpy(toks),
                                        torch.from_numpy(tb), torch.from_numpy(ctx), pc,
                                        n_steps=8)
        np.testing.assert_array_equal(pg[:, :2].numpy(), np.asarray(jg)[:, :2])
        np.testing.assert_allclose(pl_[:2].numpy(), np.asarray(jl)[:2], **TOL)
