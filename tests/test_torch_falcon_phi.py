"""Falcon- and Phi-class serving of the port held against the JAX package on
the CPU, from the same numpy-made inputs.

The port's plain versions (what its wrappers run on CPU tensors, and what
its CUDA kernels are held against on the card by tests/test_torch_cuda.py
and chip_smoke.py) against the JAX package's functions, run as its own
tests run them here: Pallas kernels in interpret mode, beside their XLA
oracles. The two modes of this slice: query groups wider than 8 (Falcon-7B
has 71 query heads over one KV head) and head_dim 80 (Phi-2).

- paged decode in all four modes (f32 and int8 pools, plain and fused) at
  groups 12 over 1 and 16 over 2, head_dim 80 and 64: against the
  interpret-mode JAX paged_decode_attention (its fused mode with k_new:
  the route the JAX package takes where D % 128 != 0) and
  paged_decode_attention_xla, at 5e-5 (KERNEL_VS_ORACLE_ATOL of
  tests/test_torch_paged_quant.py); the fused modes' written rows (codes
  and scales on int8) bit-identical;
- the flash forward (o and lse) at head_dim 80 and at GQA 12 over 1
  against the interpret-mode JAX kernel and `_xla_attention` at 2e-4
  (tests/test_flash_attention.py's pin);
- three tiny engines against the JAX engine: a Falcon-7B form (parallel
  residual, one shared LayerNorm, multi-query, 12 query heads over 1), a
  Falcon-40B form (parallel residual, two LayerNorms, GQA 32 over 2) and a
  Phi-2 form (head_dim 80, partial rotary 0.4, biases, an untied biased
  lm_head): prefill, decode, chunked continuation, prefix hit and
  decode_multi, logits within 1e-4 on f32 pools and 2e-3 on int8 pools
  (the tolerances the window and ALiBi engine tests pin), greedy tokens
  identical; the parallel residual and the lm_head bias bite;
- params_from_numpy on the lm_head_b leaf and the shared_ln layout (no
  ln2 leaves); chip_smoke.py's FALCON_7B and PHI_2 against the JAX
  package's config_from_hf of tiiuae/falcon-7b's and microsoft/phi-2's
  config.json (6,921,720,704 and 2,779,683,840 parameters in both
  packages);
- every form, and a sequential Llama-class model at head_dim 80, trains
  (check_trained, make_loss_fn; the head_dim-80 model's loss and
  gradients against the JAX package's); tests/test_torch_falcon_phi_train.py
  holds their training against the JAX package in full.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (FALCON_PHI as MODELS, FALCON_PHI_STD as STD, PHI_2_TINY, SERVE,
                           flatten, numpy_params, to_jax)
from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import attention as JA
from deepspeed_tpu.ops.pallas import flash_attention as JF
from deepspeed_tpu.ops.pallas import paged_attention as JP
from deepspeed_tpu.utils.hf_checkpoint import config_from_hf
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.inference import model as PM
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops.cuda import flash_attention as PF
from deepspeed_tpu_torch.ops.cuda import paged_attention as PP
from deepspeed_tpu_torch.utils.convert import params_from_numpy
from deepspeed_tpu_torch.utils.tree import leaves

FLASH_TOL = dict(rtol=2e-4, atol=2e-4)
KERNEL_VS_ORACLE_ATOL = 5e-5
TOL = {"auto": dict(rtol=1e-4, atol=1e-4), "int8": dict(rtol=2e-3, atol=2e-3)}
# tiiuae/falcon-7b and microsoft/phi-2 config.json, the values
# config_from_hf reads
FALCON_7B_HF = {"architectures": ["FalconForCausalLM"], "vocab_size": 65024,
                "hidden_size": 4544, "num_hidden_layers": 32, "num_attention_heads": 71,
                "multi_query": True, "new_decoder_architecture": False, "parallel_attn": True,
                "bias": False, "alibi": False, "layer_norm_epsilon": 1e-05}
PHI_2_HF = {"architectures": ["PhiForCausalLM"], "vocab_size": 51200, "hidden_size": 2560,
            "intermediate_size": 10240, "num_hidden_layers": 32, "num_attention_heads": 32,
            "num_key_value_heads": 32, "max_position_embeddings": 2048,
            "partial_rotary_factor": 0.4, "rope_theta": 10000.0, "layer_norm_eps": 1e-05,
            "tie_word_embeddings": False}


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_bh(x):
    B, S, h, D = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * h, S, D)


# ---------------------------------------------------------------------------
# paged decode: wide groups and head_dim 80
# ---------------------------------------------------------------------------

def _decode_case(rng, H, KV, D, quant, S=4, bs=16, NB=20, NBLK=84):
    """Rows: ctx 5, 130 (mid-block), 300 and a pad row (ctx 0); f32 pools
    or int8 codes and scales made by the JAX package's quantize_kv_rows."""
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    kf = rng.standard_normal((NBLK, bs, KV, D)).astype(np.float32)
    vf = rng.standard_normal((NBLK, bs, KV, D)).astype(np.float32)
    if quant:
        qk, ks, qv, vs = (np.asarray(a) for a in JP.quantize_kv_rows(
            jnp.asarray(kf.reshape(-1, KV, D)), jnp.asarray(vf.reshape(-1, KV, D))))
        pools = (qk.reshape(kf.shape), qv.reshape(kf.shape), ks.reshape(NBLK, bs, KV),
                 vs.reshape(NBLK, bs, KV))
    else:
        pools = (kf, vf)
    tbl = rng.permutation(NBLK - 1)[:S * NB].reshape(S, NB).astype(np.int32)
    tbl[S - 1] = NBLK - 1  # the pad row's table points at a scratch block
    ctx = np.array([5, 130, 300, 0], np.int32)[:S]
    return q, pools, tbl, ctx


def _jscale(pools):
    return dict(zip(("k_scale", "v_scale"), (jnp.asarray(s) for s in pools[2:])))


DECODE_SHAPES = {"g12_kv1_d80": (12, 1, 80), "g16_kv2_d80": (32, 2, 80),
                 "g12_kv1_d64": (12, 1, 64)}


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
def test_decode_plain_matches_jax_kernel_and_oracle(rng, quant, shape):
    H, KV, D = DECODE_SHAPES[shape]
    q, pools, tbl, ctx = _decode_case(rng, H, KV, D, quant)
    j = [jnp.asarray(a) for a in (q, *pools[:2], tbl, ctx)]
    with jax.default_matmul_precision("highest"):
        kern = JP.paged_decode_attention(*j, **_jscale(pools))
        oracle = JP.paged_decode_attention_xla(*j, **_jscale(pools))
    args = [_t(a) for a in (q, *pools[:2], tbl, ctx)]
    scales = [_t(s) for s in pools[2:]]
    out = PP.paged_decode_attention_plain(*args, *scales)
    live = ctx > 0  # the JAX versions leave pad rows as garbage
    for ref in (kern, oracle):
        np.testing.assert_allclose(out.numpy()[live], np.asarray(ref)[live],
                                   atol=KERNEL_VS_ORACLE_ATOL, rtol=0)
    assert not out.numpy()[~live].any()
    # the wrappers on CPU tensors are the plain versions
    wrap = PP.paged_decode_attention_int8 if quant else PP.paged_decode_attention
    assert torch.equal(wrap(*args, *scales), out)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("shape", sorted(DECODE_SHAPES))
def test_decode_fused_matches_jax_fused_mode(rng, quant, shape):
    """The fused write+attend mode against #4's fused mode of the JAX
    package (paged_decode_attention with k_new: the route its engine takes
    at head_dim 64 and 80, where paged_decode_fused's D % 128 == 0 fails),
    on f32 and int8 pools: the written rows (codes and scales on int8)
    bit-identical, the outputs within KERNEL_VS_ORACLE_ATOL of the JAX
    kernel and of the oracle over its written pools."""
    H, KV, D = DECODE_SHAPES[shape]
    q, pools, tbl, ctx = _decode_case(rng, H, KV, D, quant)
    S, bs = q.shape[0], pools[0].shape[1]
    kn, vn = (rng.standard_normal((S, KV, D)).astype(np.float32) for _ in range(2))
    pos = np.maximum(ctx - 1, 0)
    slots = np.where(ctx > 0, tbl[np.arange(S), pos // bs] * bs + pos % bs, -1).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (q, *pools[:2], tbl, ctx, kn, vn, slots)]
    with jax.default_matmul_precision("highest"):
        ref, *jpools = JP.paged_decode_attention(
            *jargs[:5], k_new=jargs[5], v_new=jargs[6], slots=jargs[7], **_jscale(pools))
        oracle = JP.paged_decode_attention_xla(
            jargs[0], *jpools[:2], jargs[3], jargs[4],
            **(dict(k_scale=jpools[2], v_scale=jpools[3]) if quant else {}))
    ppools = [_t(a.copy()) for a in pools]
    fused = PP.paged_decode_fused_int8 if quant else PP.paged_decode_fused
    out, *written = fused(_t(q), ppools[0], ppools[1], _t(tbl), _t(ctx), _t(kn), _t(vn),
                          _t(slots), *ppools[2:])
    assert all(w is p for w, p in zip(written, ppools))  # in place
    for w, g in zip(jpools, ppools):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    live = ctx > 0
    for r in (ref, oracle):
        np.testing.assert_allclose(out.numpy()[live], np.asarray(r)[live],
                                   atol=KERNEL_VS_ORACLE_ATOL, rtol=0)


def test_int8_quantizer_at_head_dim_80_is_the_jax_one(rng):
    """quantize_kv_rows at head_dim 80 (the slices the kernels pad to 96
    lanes with zeros) bit-identical to the JAX package's, .5 ties and zero
    rows included."""
    x = rng.standard_normal((40, 3, 80)).astype(np.float32)
    x[:4] = rng.integers(-126, 126, (4, 3, 80)) + 0.5
    x[:4, :, 79] = 127.0  # scale exactly 1: every other element a .5 tie
    x[4:6] = 0.0
    want = [np.asarray(a) for a in JP.quantize_kv_rows(jnp.asarray(x), jnp.asarray(-x))]
    got = PP.quantize_kv_rows(_t(x), _t(-x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

FLASH_CASES = {"d80": (4, 4, 80), "d80_gqa": (8, 2, 80), "mqa_g12_d64": (12, 1, 64)}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax_kernel_and_xla(rng, case):
    H, KV, D = FLASH_CASES[case]
    B, S = 1, 100  # S no multiple of the 64-row blocks
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    with jax.default_matmul_precision("highest"):
        jo, jlse = JF._flash_fwd(_to_bh(q), _to_bh(k), _to_bh(v), None, True, 64, 64, H, KV)
        xla = JA._xla_attention(q, JA._repeat_kv(k, H // KV), JA._repeat_kv(v, H // KV))
    o, lse = PF.flash_attention_plain(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo).reshape(B, H, S, D)
                               .transpose(0, 2, 1, 3), **FLASH_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(B, H, S), **FLASH_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(xla), **FLASH_TOL)
    # the CPU wrapper is the plain version
    fo, flse = PF.flash_fwd(_t(q), _t(k), _t(v))
    assert torch.equal(fo, o) and torch.equal(flse, lse)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _pool_arrays(cache):
    return [np.asarray(a) for a in cache.k + cache.v + list(cache.k_scale or [])
            + list(cache.v_scale or [])]


def _sync(peng, jeng):
    """Copy the JAX engine's pools into the port's (int8: one code flips at
    a .5 boundary now and then between the two frameworks' f32 k/v)."""
    c = peng.cache
    for dst, src in zip(c.k + c.v + list(c.k_scale or []) + list(c.v_scale or []),
                        _pool_arrays(jeng.cache)):
        dst.copy_(_t(src))


def _scripted(model, kv_cache_dtype):
    """The same put() sequence on a JAX and a port engine: a 13-token
    prompt beside a 40-token one, 6 greedy single-token decodes of the
    first (the fused mode), a 3-token continuation of the second (the plain
    decode mode), a prefix hit on the second's first two blocks (a 5-token
    suffix through the plain decode mode) and greedy decode_multi. int8
    pools start each put from the JAX engine's pools."""
    over = MODELS[model]
    jc, pc = JT.TransformerConfig(**over), PT.TransformerConfig(**over)
    tree = numpy_params(jc, seed=7, std=STD[model])
    cfg = dict(SERVE, kv_cache_dtype=kv_cache_dtype)
    jeng = jax_init_inference(to_jax(tree), jc, dict(cfg, decode_impl="pallas"),
                              dtype=jnp.float32)
    peng = init_inference(params_from_numpy(tree, pc, device="cpu"), pc, cfg,
                          dtype=torch.float32, device="cpu")
    quant = kv_cache_dtype == "int8"
    r = np.random.default_rng(13)
    p0, p1 = (r.integers(0, 512, n).astype(np.int32) for n in (13, 40))
    out = {"prefill": [], "decode": [], "chunk": [], "prefix_hit": []}

    def put(name, uids, toks):
        if quant:
            _sync(peng, jeng)
        lj = np.asarray(jeng.put(uids, [t.copy() for t in toks]))
        lp = peng.put(uids, [t.copy() for t in toks])
        out[name].append((lj, lp))
        return lj, lp

    lj, lp = put("prefill", [0, 1], [p0, p1])
    for _ in range(6):
        tok = int(np.argmax(lj[0]))
        assert tok == int(np.argmax(lp[0]))
        lj, lp = put("decode", [0], [np.array([tok], np.int32)])
    put("chunk", [1], [r.integers(0, 512, 3).astype(np.int32)])
    put("prefix_hit", [2], [np.concatenate([p1[:32], r.integers(0, 512, 5)]).astype(np.int32)])
    if quant:
        _sync(peng, jeng)
    uids = [0, 1]
    tables = peng.state.block_table(uids, peng.config.blocks_per_seq, peng.pad_block)
    ctx = np.array([peng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
    toks = np.array([7, 8], np.int32)
    jg, jl, jeng.cache, _ = jeng.decode_multi_fn(2, 10)(  # the JAX call donates its cache
        jeng.params, jeng.cache, jnp.asarray(toks), jnp.asarray(tables), jnp.asarray(ctx))
    pg, pl_, _, _ = peng.decode_multi_fn(2, 10)(peng.params, peng.cache, toks, tables, ctx)
    out["decode_multi"] = (np.asarray(jg), pg.numpy(), np.asarray(jl), pl_.numpy())
    out["stats"] = (jeng.prefix_cache_stats(), peng.prefix_cache_stats())
    out["kv_cache_dtype"] = kv_cache_dtype
    return out


@pytest.fixture(scope="module", params=[(m, kv) for m in sorted(MODELS) for kv in ("auto",
                                                                                   "int8")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def scripted_run(request):
    return _scripted(*request.param)


@pytest.mark.parametrize("step", ["prefill", "decode", "chunk", "prefix_hit"])
def test_engine_put_logits_match_jax_engine(scripted_run, step):
    assert scripted_run[step]
    tol = TOL[scripted_run["kv_cache_dtype"]]
    for lj, lp in scripted_run[step]:
        assert lp.shape == lj.shape
        np.testing.assert_allclose(lp, lj, **tol)
        assert (lp.argmax(-1) == lj.argmax(-1)).all()


def test_engine_decode_multi_tokens_identical(scripted_run):
    jg, pg, jl, pl_ = scripted_run["decode_multi"]
    assert pg.shape == (10, 2)
    np.testing.assert_array_equal(pg, jg)
    assert len(np.unique(pg)) > 3  # the tokens actually move
    np.testing.assert_allclose(pl_, jl, **TOL[scripted_run["kv_cache_dtype"]])


def test_engine_prefix_hit_was_taken(scripted_run):
    sj, sp = scripted_run["stats"]
    assert sp["lookup_hits"] == sj["lookup_hits"] == 1
    assert sp["cached_tokens"] == sj["cached_tokens"] == 32


def _put_logits(over, tree, **change):
    cfg = PT.TransformerConfig(**over)
    eng = init_inference(params_from_numpy(tree, cfg, device="cpu"), cfg, SERVE,
                         dtype=torch.float32, device="cpu")
    eng.params.update(change)
    return eng.put([0], [np.arange(30, dtype=np.int32) * 7])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_parallel_residual_bites_in_the_engine(name):
    """The same weights read as a sequential-residual model (two norms:
    ln2 = ln1 where the form shares one) give other logits, by far more
    than the 1e-4 tolerance above: the runs above are parallel-residual
    runs."""
    over = MODELS[name]
    tree = numpy_params(JT.TransformerConfig(**over), seed=7, std=STD[name])
    seq_tree = {k: v for k, v in tree.items() if k != "layers"}
    seq_tree["layers"] = dict(tree["layers"])
    for leaf in ("scale", "bias"):
        if over["shared_ln"] and f"ln1_{leaf}" in tree["layers"]:
            seq_tree["layers"][f"ln2_{leaf}"] = tree["layers"][f"ln1_{leaf}"]
    seq = dict(over, parallel_residual=False, shared_ln=False)
    a = _put_logits(over, tree)
    b = _put_logits(seq, seq_tree)
    assert np.abs(a - b).max() > 1e-2


def test_lm_head_bias_is_added_to_the_logits():
    """Phi-2's lm_head bias: the logits are those without it plus the bias,
    in f32, and serving the same weights with the bias at zero moves them."""
    tree = numpy_params(JT.TransformerConfig(**PHI_2_TINY), seed=7, std=STD["phi_2"])
    with_b = _put_logits(PHI_2_TINY, tree)
    without = _put_logits(PHI_2_TINY, tree,
                          lm_head_b=torch.zeros(PHI_2_TINY["vocab_size"]))
    np.testing.assert_allclose(with_b - without, np.broadcast_to(tree["lm_head_b"],
                                                                 with_b.shape),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# parameters, configs, training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_params_from_numpy_takes_the_family_leaves(name):
    """lm_head_b carried across as it is; a shared_ln form has no ln2
    leaves, in either package's layout; the serving layout fuses the
    q/k/v biases and keeps the rest."""
    over = MODELS[name]
    jc, pc = JT.TransformerConfig(**over), PT.TransformerConfig(**over)
    tree = numpy_params(jc, seed=4)
    got = params_from_numpy(tree, pc, device="cpu")
    flat = {**{k: v for k, v in got.items() if k != "layers"},
            **{f"layers/{k}": v for k, v in got["layers"].items()}}
    assert set(flat) == set(PT._param_shapes(pc))
    assert ("layers/ln2_scale" in flat) == (not over["shared_ln"])
    assert ("lm_head_b" in flat) == over.get("lm_head_bias", False)
    if "lm_head_b" in flat:
        np.testing.assert_array_equal(flat["lm_head_b"].numpy(), tree["lm_head_b"])
        bad = dict(tree)
        del bad["lm_head_b"]
        with pytest.raises(ValueError, match="lm_head_b"):
            params_from_numpy(bad, pc, device="cpu")
    assert PT.param_count(pc) == _jax_param_count(jc)
    lp = PM.prepare(got, pc)["layers"][0]
    assert ("b_qkv" in lp) == over["qkv_bias"] and "wq" not in lp
    assert ("ln2_scale" in lp) == (not over["shared_ln"])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_served_but_training_still_raises(name):
    """(Named when training raised for these forms.) Every served form now
    trains: check_trained accepts it, make_loss_fn builds, and one loss
    and backward on the CPU is finite and reaches every leaf."""
    cfg = PT.TransformerConfig(**MODELS[name])
    assert PT.unported_features(cfg) == []
    PM.check_served(cfg)
    PT.check_trained(cfg)
    params = params_from_numpy(numpy_params(JT.TransformerConfig(**MODELS[name]), seed=3,
                                            std=STD[name]), cfg, device="cpu")
    live = [p.requires_grad_() for p in leaves(params)]
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    loss = PT.make_loss_fn(cfg, loss_chunks=4)(params, {"tokens": tokens}, None)
    grads = torch.autograd.grad(loss, live)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() and g.abs().max() > 0
                                        for g in grads)


def test_training_raises_at_head_dim_80_alone():
    """(Named when the flash backward lacked head_dim 80.) A sequential
    Llama-class model at head_dim 80 is served and trained: its loss and
    every gradient match jax.value_and_grad of the JAX package's loss
    (f32, rtol 1e-4 and atol 1e-4 of each leaf's largest gradient, the pin
    of tests/test_torch_alibi_train.py), under remat save_attn_qkv and
    chunked CE."""
    over = dict(vocab_size=512, n_layers=2, n_heads=4, d_model=320)
    cfg = PT.TransformerConfig(**over, remat="save_attn_qkv")
    PM.check_served(cfg)
    PT.check_trained(cfg)
    assert cfg.head_dim == 80
    jc = JT.TransformerConfig(**over)
    tree = numpy_params(jc, seed=5, std=0.3 * (256 / 320) ** 0.5)
    batch = {"tokens": np.random.default_rng(2).integers(0, 512, (2, 33)).astype(np.int32)}
    jl, jg = jax.value_and_grad(JT.make_loss_fn(jc, loss_chunks=4))(to_jax(tree), batch, None)
    params = params_from_numpy(tree, cfg, device="cpu")
    live = [p.requires_grad_() for p in leaves(params)]
    loss = PT.make_loss_fn(cfg, loss_chunks=4)(params, batch, None)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4, atol=1e-4)
    ref = flatten(jax.tree.map(np.asarray, jg))
    assert list(ref) == list(flatten(params))
    for g, r in zip(torch.autograd.grad(loss, live), ref.values()):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_param_count(cfg):
    """The JAX package's parameter count from the shapes its init makes,
    summed in Python ints: its own param_count multiplies each leaf's shape
    in int32, which wraps for Falcon-7B's [32, 4544, 18176] MLP leaves
    (2,642,935,808 elements)."""
    shapes = jax.tree.leaves(jax.eval_shape(lambda k: JT.init(cfg, k), jax.random.PRNGKey(0)))
    return sum(math.prod(s.shape) for s in shapes)


@pytest.mark.parametrize("name,hf,n_params,shape", [
    ("FALCON_7B", FALCON_7B_HF, 6_921_720_704, (64, 1, 18176, 64)),
    ("PHI_2", PHI_2_HF, 2_779_683_840, (80, 32, 10240, 32)),
])
def test_chip_smoke_config_is_config_from_hf(name, hf, n_params, shape):
    """chip_smoke.py's FALCON_7B and PHI_2 dicts are, field by field, the
    JAX package's config_from_hf of the published config.json, and count
    the same parameters in both packages."""
    want = config_from_hf(hf)
    got = PT.TransformerConfig(**getattr(_chip_smoke(), name))
    for f in dataclasses.fields(JT.TransformerConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert PT.param_count(got) == _jax_param_count(want) == n_params
    assert (got.head_dim, got.kv_heads, got.ff_dim, PT.rope_dim(got)) == shape
    assert PT.unported_features(got) == []
