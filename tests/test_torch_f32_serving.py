"""f32 serving and DeepSpeed's v1 inference keys, the port against the JAX
package on the CPU.

- init_inference's v1 keys (the JAX package's TestV1ConfigCompat,
  tests/test_inference.py): "fp16" serves bf16 and "max_out_tokens" is
  max_seq_len, "int8" quantizes the weights groupwise (bits 8, group 128),
  "checkpoint" and "injection_policy" raise with the reference's words;
  each held against the JAX engine built from the same config and the
  same numpy-made weights (dtype, max_seq_len, int8 leaves bit for bit,
  error types; the bf16 engines, fed the JAX f32 engine's tokens: the
  port's logits within 1.5x RMS / 2x max of the JAX bf16 engine's error
  against the f32 ones, greedy tokens equal wherever the f32 top-2 gap
  exceeds both engines' errors). "fp32" engines, on f32 and on int8 KV pools, give
  the JAX f32 engine's greedy tokens. tensor_parallel > 1 and a config
  offload raise, naming ROADMAP A11 and A14.
- the int8 quantizer on f32 rows whose quotients lie within an ulp of a
  .5 tie, NaN, inf and subnormal slices: bit-identical to the JAX
  package's quantize_kv_rows (subnormal slices where this JAX keeps them).
- the wrappers' dtype routing through their pure helpers (no card needed):
  f32 routes to the f32 libraries, a mixed dtype raises, f32 backward and
  f32 inputs that need a gradient on the card raise naming B6.

Each JAX engine is built once per module (engines compile per program).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SERVE, jax_config, numpy_params, to_jax, torch_config
from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.inference.quantization import QuantizedWeight as JaxQuantizedWeight
from deepspeed_tpu.ops.pallas import paged_attention as JP
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.inference.quantization import QuantizedWeight
from deepspeed_tpu_torch.ops import cuda as PK
from deepspeed_tpu_torch.ops.cuda import _common as PC
from deepspeed_tpu_torch.ops.cuda import flash_attention as PF
from deepspeed_tpu_torch.ops.cuda import paged_attention as PP
from deepspeed_tpu_torch.utils.convert import params_from_numpy

# the reference test's engine geometry, in v1 keys
V1 = {"max_batch_size": 8, "kv_block_size": 8, "num_kv_blocks": 32, "min_prefill_bucket": 8}
DECODE_STEPS = 8


def _tree(seed=3):
    return numpy_params(jax_config(), seed=seed, std=0.3 / 2)


def _both(config, tree, **kw):
    """The JAX engine and the port's engine (on the CPU) of the same v1
    config and numpy weights."""
    jeng = jax_init_inference(to_jax(tree), jax_config(), dict(config), **kw)
    peng = init_inference(params_from_numpy(tree, torch_config(), device="cpu"), torch_config(),
                          dict(config), device="cpu", **kw)
    return jeng, peng


def _teacher_forced(engines, vocab=512, steps=DECODE_STEPS):
    """A prefill wave of two prompts, then `steps` single-token puts of
    both rows, each fed the first engine's greedy token, so that every
    engine sees the same contexts: each engine's logits [steps + 1, 2, V]."""
    r = np.random.default_rng(5)
    prompts = [r.integers(0, vocab, n).astype(np.int32) for n in (11, 15)]
    out = [[np.asarray(e.put([0, 1], [p.copy() for p in prompts]))] for e in engines]
    for _ in range(steps):
        toks = [np.array([t], np.int32) for t in out[0][-1].argmax(-1)]
        for e, o in zip(engines, out):
            o.append(np.asarray(e.put([0, 1], [t.copy() for t in toks])))
    for e in engines:  # the shared reference engine starts fresh next time
        e.flush(0)
        e.flush(1)
    return [np.stack(o) for o in out]


def _assert_bf16_engines_agree(jax_f32, jax_bf16, port_bf16):
    """Two bf16 engines (the frameworks round at different places), fed
    the JAX f32 engine's greedy tokens: the port's logits no further from
    the JAX f32 engine's than 1.5x (RMS) and 2x (max) the JAX bf16
    engine's are (the factors of chip_smoke.py's path checks), and its
    greedy token the JAX engines' at every step whose f32 top-2 gap exceeds
    the sum of the two bf16 engines' largest errors there."""
    ej, ep = np.abs(jax_bf16 - jax_f32), np.abs(port_bf16 - jax_f32)
    rms = lambda e: float(np.sqrt(np.mean(e.astype(np.float64) ** 2)))
    assert rms(ep) <= 1.5 * rms(ej) and ep.max() <= 2 * ej.max(), (rms(ep), rms(ej),
                                                                   ep.max(), ej.max())
    top2 = np.sort(jax_f32, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > ej.max(-1) + ep.max(-1)
    assert clear.sum() >= 4, clear  # the check decides some tokens
    want = jax_f32.argmax(-1)[clear]
    np.testing.assert_array_equal(jax_bf16.argmax(-1)[clear], want)
    np.testing.assert_array_equal(port_bf16.argmax(-1)[clear], want)


def _greedy(jeng, peng, vocab=512):
    """A prefill wave of two prompts, then greedy decode_multi over both
    rows: (JAX tokens, port tokens, the prefill argmaxes of both)."""
    r = np.random.default_rng(5)
    prompts = [r.integers(0, vocab, n).astype(np.int32) for n in (11, 15)]
    lj = np.asarray(jeng.put([0, 1], [p.copy() for p in prompts]))
    lp = peng.put([0, 1], [p.copy() for p in prompts])
    uids = [0, 1]
    tables = peng.state.block_table(uids, peng.config.blocks_per_seq, peng.pad_block)
    ctx = np.array([peng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
    toks = lj.argmax(-1).astype(np.int32)
    jg = jeng.decode_multi_fn(2, DECODE_STEPS)(jeng.params, jeng.cache, jnp.asarray(toks),
                                              jnp.asarray(tables), jnp.asarray(ctx))[0]
    pg = peng.decode_multi_fn(2, DECODE_STEPS)(peng.params, peng.cache, toks, tables, ctx)[0]
    return np.asarray(jg), pg.numpy(), lj.argmax(-1), lp.argmax(-1)


@pytest.fixture(scope="module")
def tree():
    return _tree()


@pytest.fixture(scope="module")
def jax_f32(tree):
    """The JAX f32 engine of the same weights: the bf16 engines' reference."""
    return jax_init_inference(to_jax(tree), jax_config(), {"dtype": "fp32", **V1})


@pytest.fixture(scope="module")
def fp16_engines(tree):
    return _both({"dtype": "fp16", "replace_with_kernel_inject": True,
                  "enable_cuda_graph": True, "max_out_tokens": 48, **V1}, tree)


@pytest.fixture(scope="module")
def int8_engines(tree):
    return _both({"dtype": "int8", "max_seq_len": 48, **V1}, tree)


@pytest.fixture(scope="module", params=["auto", "int8"])
def fp32_engines(request, tree):
    cfg = {"dtype": "fp32", "max_out_tokens": 64, "kv_cache_dtype": request.param, **V1}
    jeng, peng = _both(cfg, tree)
    return request.param, jeng, peng, _greedy(jeng, peng)


class TestV1ConfigCompat:
    """The JAX package's four TestV1ConfigCompat cases, held against its
    engine."""

    def test_dtype_and_noop_keys(self, fp16_engines, jax_f32):
        jeng, peng = fp16_engines
        assert jeng._dtype == jnp.bfloat16 and peng._dtype == torch.bfloat16  # fp16 -> bf16
        assert peng.config.max_seq_len == jeng.config.max_seq_len == 48
        _assert_bf16_engines_agree(*_teacher_forced([jax_f32, jeng, peng]))

    def test_int8_dtype_enables_ptq(self, int8_engines, jax_f32):
        jeng, peng = int8_engines
        assert jeng._dtype == jnp.bfloat16 and peng._dtype == torch.bfloat16
        jw, pw = jeng.params["layers"][0]["w_qkv"], peng.params["layers"][0]["w_qkv"]
        assert isinstance(jw, JaxQuantizedWeight) and isinstance(pw, QuantizedWeight)
        assert pw.bits == jw.bits == 8 and pw.dtype_name == jw.dtype_name == "bfloat16"
        assert pw.q.shape[-1] == 128 * pw.scale.shape[-1]  # groups of 128
        np.testing.assert_array_equal(pw.q.numpy(), np.asarray(jw.q))
        np.testing.assert_array_equal(pw.scale.float().numpy(),
                                      np.asarray(jw.scale.astype(jnp.float32)))
        _assert_bf16_engines_agree(*_teacher_forced([jax_f32, jeng, peng]))

    @pytest.mark.parametrize("key,value,words", [
        ("checkpoint", "/some/path.json", "init_inference_from_hf"),
        ("injection_policy", {"x": "y"}, "rules table"),
    ])
    def test_checkpoint_and_injection_policy_raise(self, tree, key, value, words):
        for build in (lambda c: jax_init_inference(to_jax(tree), jax_config(), c),
                      lambda c: init_inference(params_from_numpy(tree, torch_config(),
                                                                 device="cpu"),
                                               torch_config(), c, device="cpu")):
            with pytest.raises(NotImplementedError, match=words):
                build({key: value, **V1})


class TestFp32Serving:
    def test_v1_fp32_serves_f32(self, fp32_engines):
        pools, jeng, peng, _ = fp32_engines
        assert jeng._dtype == jnp.float32 and peng._dtype == torch.float32
        assert peng.config.max_seq_len == 64 and peng.kv_quant == (pools == "int8")
        pool = peng.cache.k[0]
        assert pool.dtype == (torch.int8 if pools == "int8" else torch.float32)
        assert all(w.dtype == torch.float32 for w in peng.params["layers"][0].values())

    def test_greedy_tokens_equal_the_jax_f32_engine(self, fp32_engines):
        _, _, _, (jg, pg, ja, pa) = fp32_engines
        np.testing.assert_array_equal(pa, ja)
        assert pg.shape == (DECODE_STEPS, 2)
        np.testing.assert_array_equal(pg, jg)
        assert len(np.unique(pg)) > 3  # the tokens move

    @pytest.mark.parametrize("spelling", ["fp32", "float", "double", "float32", torch.float32,
                                          np.float64, "torch.float64"])
    def test_f32_spellings(self, tree, spelling):
        peng = init_inference(params_from_numpy(tree, torch_config(), device="cpu"),
                              torch_config(), {"dtype": spelling, **SERVE}, device="cpu")
        assert peng._dtype == torch.float32

    @pytest.mark.parametrize("config,exc,words", [
        ({"dtype": "fp8"}, ValueError, "unsupported inference dtype"),
        ({"max_out_tokens": 32, "max_seq_len": 64}, ValueError, "conflicting max_out_tokens"),
        ({"tensor_parallel": {"tp_size": 2}, "tp_size": 4}, ValueError,
         "conflicting tensor_parallel"),
    ])
    def test_bad_v1_keys_raise_as_the_jax_engine(self, tree, config, exc, words):
        for build in (lambda c: jax_init_inference(to_jax(tree), jax_config(), c),
                      lambda c: init_inference(params_from_numpy(tree, torch_config(),
                                                                 device="cpu"),
                                               torch_config(), c, device="cpu")):
            with pytest.raises(exc, match=words):
                build({**V1, **config})

    @pytest.mark.parametrize("config,item", [
        ({"tensor_parallel": {"tp_size": 2}}, "A11"),
        ({"tensor_parallel": 2}, "A11"),
        ({"offload": {"device": "cpu"}}, "A14"),
    ])
    def test_tensor_parallel_and_offload_still_raise(self, tree, config, item):
        with pytest.raises(NotImplementedError, match=item):
            init_inference(params_from_numpy(tree, torch_config(), device="cpu"),
                           torch_config(), {**V1, "dtype": "fp32", **config}, device="cpu")

    def test_tensor_parallel_of_one_and_noop_keys_serve(self, tree):
        peng = init_inference(params_from_numpy(tree, torch_config(), device="cpu"),
                              torch_config(),
                              {**V1, "dtype": "fp32", "tensor_parallel": {"tp_size": 1},
                               "use_triton": True, "triangular_masking": True},
                              device="cpu")
        assert peng.config.tp_size == 1 and peng._dtype == torch.float32


def _tie_rows(seed, T=64, KV=4, D=128):
    """f32 rows whose quotients x / scale lie within an ulp of a .5 tie:
    each slice a random amax at element 0 and (k + 1/2) * scale nudged by
    -1, 0 or +1 ulp elsewhere; rows 0-4 hold a NaN, +inf, -inf, a NaN
    beside an inf, and zeros."""
    r = np.random.default_rng(seed)
    amax = r.uniform(0.5, 100.0, (T, KV, 1)).astype(np.float32)
    scale = amax * np.float32(1.0 / 127.0)
    x = ((r.integers(-126, 126, (T, KV, D)) + 0.5).astype(np.float32) * scale).astype(np.float32)
    nudge = r.integers(-1, 2, (T, KV, D))
    x = np.where(nudge > 0, np.nextafter(x, np.float32(np.inf)), x)
    x = np.where(nudge < 0, np.nextafter(x, np.float32(-np.inf)), x).astype(np.float32)
    x[..., :1] = amax
    x[0, :, 5] = np.nan
    x[1, :, 3] = np.inf
    x[2, :, D - 1] = -np.inf
    x[3, :, 0], x[3, :, D // 2] = np.nan, np.inf
    x[4] = 0.0
    return x


def test_f32_row_quantizer_near_ties_matches_jax():
    k, v = _tie_rows(1), _tie_rows(2)
    q = k[5:] / (np.abs(k[5:]).max(-1, keepdims=True) * np.float32(1.0 / 127.0))
    assert (np.abs(np.abs(q - np.trunc(q)) - 0.5) < 1e-4).mean() > 0.9  # at the ties
    want = [np.asarray(a) for a in JP.quantize_kv_rows(jnp.asarray(k), jnp.asarray(v))]
    got = [a.numpy() for a in PP.quantize_kv_rows(torch.from_numpy(k), torch.from_numpy(v))]
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the quantizing write (the CPU route of the f32 kernel's wrapper) writes the same
    NBLK, bs, KV, D = 8, 8, 4, 128
    pools = [torch.zeros((NBLK, bs, KV, D), dtype=torch.int8) for _ in "kv"] + \
        [torch.zeros((NBLK, bs, KV)) for _ in "kv"]
    slots = torch.arange(64, dtype=torch.int32)
    PP.paged_kv_write_int8(*pools, torch.from_numpy(k), torch.from_numpy(v), slots)
    np.testing.assert_array_equal(pools[0].reshape(64, KV, D).numpy(), want[0])
    np.testing.assert_array_equal(pools[3].reshape(64, KV).numpy(), want[3])


def test_f32_row_quantizer_subnormal_slices():
    """A subnormal amax keeps its subnormal scale and full codes in the port
    (IEEE f32, as on the card); compared with JAX only where this JAX CPU
    run keeps subnormals (it may flush them: scale 1, codes 0)."""
    x = np.full((2, 2, 80), 3e-39, np.float32)
    x[:, :, ::3] = -5e-39
    x[1, 1] = np.float32(1e-44)
    got = PP.quantize_kv_rows(torch.from_numpy(x), torch.from_numpy(x))
    assert 0 < float(got[1][0, 0]) < np.finfo(np.float32).tiny
    assert int(got[0][0, 0, 0]) == -127
    jc, js, _, _ = (np.asarray(a) for a in JP.quantize_kv_rows(jnp.asarray(x), jnp.asarray(x)))
    if js[0, 0] == 1.0:  # this XLA CPU run flushed the subnormal scale
        assert not jc.any()
    else:
        np.testing.assert_array_equal(got[0].numpy(), jc)
        np.testing.assert_array_equal(got[1].numpy(), js)


class TestDtypeRouting:
    """The wrappers' dtype routing, through their pure helpers."""

    def test_flash_forward_routes_f32_to_its_own_library(self):
        q = torch.zeros(1, 4, 2, 64)
        assert PF._elem_dtype("flash_fwd", q) == torch.float32
        assert PF.library_name("flash_fwd", torch.float32) == "flash_fwd_f32"
        assert PF.library_name("flash_fwd", torch.bfloat16) == "flash_fwd"
        assert PF.library_name("flash_bwd", torch.float16) == "flash_bwd+DS_F16"

    @pytest.mark.parametrize("what", ["flash_bwd_dq", "flash_bwd_dkv"])
    def test_f32_backward_raises_naming_b6(self, what):
        with pytest.raises(TypeError, match="B6's training half"):
            PF._elem_dtype(what, torch.zeros(1, 4, 2, 64))

    def test_f32_inputs_that_need_a_gradient_raise_on_the_card_only(self):
        with pytest.raises(TypeError, match="B6's training half"):
            PF.check_no_f32_grad(torch.float32, True, True)
        PF.check_no_f32_grad(torch.float32, True, False)   # serving: no gradient
        PF.check_no_f32_grad(torch.float32, False, True)   # the CPU's plain backward
        PF.check_no_f32_grad(torch.bfloat16, True, True)

    def test_f32_autograd_on_the_cpu_runs_the_plain_backward(self):
        q = torch.randn(1, 8, 2, 64, requires_grad=True)
        k, v = torch.randn(1, 8, 2, 64), torch.randn(1, 8, 2, 64)
        o, _ = PF.flash_attention(q, k, v)
        o.sum().backward()
        assert q.grad is not None and torch.isfinite(q.grad).all()

    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("fused", [False, True])
    def test_decode_dtypes_follow_q(self, quant, fused):
        want = PP.decode_dtypes("x", torch.zeros(2, 4, 64), quant, fused)
        assert want["q"] == torch.float32
        assert want["k_cache"] == (torch.int8 if quant else torch.float32)
        if fused:
            assert want["k_new"] == want["v_new"] == torch.float32
        assert PP.library_name("paged_decode", torch.float32) == "paged_decode_f32"
        assert PP.library_name("paged_decode", torch.bfloat16) == "paged_decode"
        bf = PP.decode_dtypes("x", torch.zeros(2, 4, 64, dtype=torch.bfloat16), quant, fused)
        assert bf["q"] == torch.bfloat16

    def test_mixed_dtypes_raise(self):
        q = torch.zeros(2, 4, 64)
        want = PP.decode_dtypes("paged_decode_fused", q, False, True)
        tensors = {"q": q, "k_cache": torch.zeros(3, 8, 4, 64),
                   "k_new": torch.zeros(2, 4, 64, dtype=torch.bfloat16)}
        with pytest.raises(TypeError, match="k_new has dtype torch.bfloat16"):
            PC.check_dtypes("paged_decode_fused", tensors, want)
        tensors["k_new"] = tensors["k_new"].float()
        PC.check_dtypes("paged_decode_fused", tensors, want)
        with pytest.raises(TypeError, match="bf16 or f32"):
            PP.serve_dtype("paged_kv_write", torch.zeros(2, dtype=torch.float16))
        with pytest.raises(TypeError, match="bf16 or f32"):
            PP.decode_dtypes("x", torch.zeros(2, 4, 64, dtype=torch.float64), False, False)

    def test_every_f32_launch_has_its_counter(self):
        assert set(PK.MODES["f32"]) == {
            "flash_fwd", "paged_kv_write", "paged_kv_write_int8", "paged_decode_fused",
            "paged_decode_attention", "paged_decode_fused_int8", "paged_decode_attention_int8"}
        assert "flash_bwd_dq" not in PK.MODES["f32"]
        assert PK.mode_launch_counts("f32") == {f"{n}[f32]": 0 for n in PK.MODES["f32"]}
