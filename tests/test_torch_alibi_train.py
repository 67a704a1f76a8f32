"""ALiBi (Bloom-class) training of the port held against the JAX package on
the CPU, from the same numpy-made inputs.

- the flash backward's plain version with ALiBi slopes
  (`flash_attention_bwd_plain(alibi=)`, the recompute-from-lse math that
  kernels #2 and #3 implement) against jax.grad of the JAX flash kernel
  run in interpret mode and of `_xla_attention(alibi=)`, in f32 at 2e-3
  (the pin of tests/test_flash_attention.py): MHA, GQA, window 40 with
  ALiBi, a sequence that is no multiple of the 64-row blocks, falcon-rw's
  1/sqrt(head_dim) slope scale; in bf16 (P and dS rounded to bf16, as the
  kernels do) against jax.grad of the interpret-mode kernel under the
  tolerance the CUDA kernels are held to (`bwd_mismatch`), which planted
  faults in the backward's slopes fail (rotated by one head, sign
  flipped, with GQA the KV head's slope);
- `make_loss_fn` loss and every parameter's gradient for a tiny Bloom-class
  model (gpt2 variant, ALiBi, LayerNorm, biases, tanh GELU, an embedding
  LayerNorm) and a tiny falcon-rw-class one (llama variant, LayerNorm, erf
  GELU, biases, alibi_slope_scale) against jax.value_and_grad of the JAX
  loss, f32 at rtol 1e-4 and atol 1e-4 of each leaf's largest gradient,
  for every remat mode the port maps and with and without chunked CE;
  the training forward's logits against the JAX forward;
- a port engine against a JAX engine over 5 steps on a tiny Bloom-class
  model (AdamW with weight decay, clipping, linear WarmupLR, GAS 2), held
  as tests/test_torch_train.py holds the Llama trajectory;
- flops_per_token and logical_specs of the Bloom-class leaves, the CPU
  wrappers of #2/#3 with slopes, the ctypes signatures against the C
  entry points, and chip_smoke.py's falcon-rw-1b config against the JAX
  package's config_from_hf of its config.json.
"""

import dataclasses
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as pds
from _torch_parity import TINY, flatten, numpy_params, to_jax
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import attention as JA
from deepspeed_tpu.ops.pallas import flash_attention as JF
from deepspeed_tpu.utils.hf_checkpoint import config_from_hf
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops import cuda as PK
from deepspeed_tpu_torch.ops.cuda import build as PB
from deepspeed_tpu_torch.ops.cuda import flash_attention as PF
from deepspeed_tpu_torch.utils.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.utils.tree import leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
FLASH_TOL = dict(rtol=2e-3, atol=2e-3)
TOL = dict(rtol=1e-4, atol=1e-4)
# the tiny configs of tests/test_torch_alibi.py: Bloom-class, 2 heads of
# 128; falcon-rw-class (config_from_hf of a FalconConfig with alibi=True,
# parallel_attn=False, bias=True, multi_query=False), 4 heads of 64
BLOOM_TINY = dict(TINY, variant="gpt2", alibi=True, embedding_layernorm=True,
                  activation="gelu")
FALCON_RW_TINY = dict(TINY, n_heads=4, norm_type="layer", gated_mlp=False,
                      activation="gelu_exact", qkv_bias=True, attn_out_bias=True,
                      mlp_bias=True, alibi=True, alibi_slope_scale=1.0 / 8.0)
MODELS = {"bloom": BLOOM_TINY, "falcon_rw": FALCON_RW_TINY}
# tiiuae/falcon-rw-1b config.json, the values config_from_hf reads
FALCON_RW_1B_HF = {"architectures": ["FalconForCausalLM"], "vocab_size": 50304,
                   "hidden_size": 2048, "n_layer": 24, "n_head": 32, "alibi": True,
                   "bias": True, "parallel_attn": False, "multi_query": False,
                   "layer_norm_epsilon": 1e-05, "tie_word_embeddings": True}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# the flash backward with ALiBi
# ---------------------------------------------------------------------------

# (S, H, KV, D, window, slope scale)
BWD_CASES = {"mha": (128, 4, 4, 64, 0, 1.0), "gqa": (128, 4, 2, 128, 0, 1.0),
             "window_40": (128, 4, 2, 64, 40, 1.0), "ragged_s": (100, 4, 4, 64, 0, 1.0),
             "falcon_rw_scale": (128, 4, 4, 64, 0, 1.0 / 8.0)}


def _bwd_inputs(rng, case):
    S, H, KV, D, window, scale = BWD_CASES[case]
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((1, S, H, D), (1, S, KV, D), (1, S, KV, D), (1, S, H, D)))
    slopes = (JA.alibi_slopes(H) * np.float32(scale)).astype(np.float32)
    return q, k, v, do, slopes, window


def _jax_grads(attn, q, k, v, do):
    return jax.grad(lambda q, k, v: jnp.sum(attn(q, k, v).astype(jnp.float32)
                                            * do.astype(jnp.float32)),
                    argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_backward_matches_jax_kernel_and_xla_grads(rng, case):
    q, k, v, do, slopes, window = _bwd_inputs(rng, case)
    H, KV = q.shape[2], k.shape[2]
    jq, jk, jv, jdo, js = (jnp.asarray(a) for a in (q, k, v, do, slopes))
    kernel = _jax_grads(lambda q, k, v: JF.flash_attention(q, k, v, causal=True, block_q=64,
                                                           block_k=64, window=window, alibi=js),
                        jq, jk, jv, jdo)
    xla = _jax_grads(lambda q, k, v: JA._xla_attention(q, JA._repeat_kv(k, H // KV),
                                                       JA._repeat_kv(v, H // KV),
                                                       window=window, alibi=js),
                     jq, jk, jv, jdo)
    pq, pk, pv, pdo, ps = (_t(a) for a in (q, k, v, do, slopes))
    o, lse = PF.flash_attention_plain(pq, pk, pv, window, ps)
    got = PF.flash_attention_bwd_plain(pq, pk, pv, o, lse, pdo, window, ps)
    for name, g, a, b in zip(("dq", "dk", "dv"), got, kernel, xla):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), err_msg=name, **FLASH_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(b), err_msg=name, **FLASH_TOL)
    # the bias bites in every gradient
    plain = PF.flash_attention_bwd_plain(pq, pk, pv, *PF.flash_attention_plain(pq, pk, pv,
                                                                               window),
                                         pdo, window)
    for g, p in zip(got, plain):
        assert np.abs(g.numpy() - p.numpy()).max() > 1e-2


def _faults(slopes, H, KV):
    G = H // KV
    out = {None: slopes, "slopes_rotated_by_one_head": np.roll(slopes, 1),
           "bias_sign_flipped": -slopes}
    if G > 1:
        out["kv_head_slope_for_q_head"] = slopes[np.arange(H) // G]  # slopes[kv]
    return out


@pytest.mark.parametrize("case", ["gqa", "window_40", "ragged_s"])
def test_kernel_rounding_matches_jax_kernel_in_bf16(rng, case):
    """On bf16 inputs the JAX kernel rounds P and dS to bf16 before its
    products, and so does the port's plain backward. From the JAX
    forward's own o and lse, the port's plain backward with the same
    slopes is within the tolerance the CUDA kernels are held to
    (`bwd_mismatch`) of jax.grad of the interpret-mode kernel. With the
    backward's slopes spoiled (the forward's lse kept), every gradient
    fails it: the slopes rotated by one head, the bias's sign flipped,
    and with GQA each q head given its KV head's slope."""
    q, k, v, do, slopes, window = _bwd_inputs(rng, case)
    H, KV = q.shape[2], k.shape[2]
    B, S, _, D = q.shape
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    js = jnp.asarray(slopes)
    # the JAX forward kernel's own o and lse (the residuals of its rule)
    to_bh = lambda x: x.transpose(0, 2, 1, 3).reshape(-1, S, D)
    o, lse = JF._flash_fwd(to_bh(jq), to_bh(jk), to_bh(jv), js, True, 64, 64, H, KV,
                           window=window, alibi=True)
    o = np.asarray(o, np.float32).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    lse = _t(np.asarray(lse).reshape(B, H, S))
    attn = dict(causal=True, block_q=64, block_k=64, window=window, alibi=js)
    ref = _jax_grads(lambda q, k, v: JF.flash_attention(q, k, v, **attn), jq, jk, jv, jdo)
    q_, k_, v_, o_, do_ = (_t(np.asarray(a, np.float32)).to(torch.bfloat16)
                           for a in (jq, jk, jv, o, jdo))
    for fault, fs in _faults(slopes, H, KV).items():
        got = PF.flash_attention_bwd_plain(q_, k_, v_, o_, lse, do_, window, _t(fs))
        for i, name in enumerate(("dq", "dk", "dv")):
            stats = PF.bwd_mismatch(_t(np.asarray(ref[i], np.float32)), got[i])
            if fault is None:
                assert stats["n_over"] == 0, (name, stats)
            else:
                assert stats["n_over"] > 0, (name, fault, stats)


def test_cpu_wrappers_are_the_plain_alibi_backward(rng):
    q, k, v, do, slopes, window = _bwd_inputs(rng, "window_40")
    pq, pk, pv, pdo, ps = (_t(a) for a in (q, k, v, do, slopes))
    PK.reset_launch_counts()
    for w in (0, window):
        o, lse = PF.flash_fwd(pq, pk, pv, w, ps)
        delta = PF._delta(o, pdo)
        ref = PF.flash_attention_bwd_plain(pq, pk, pv, o, lse, pdo, w, ps)
        got = (PF.flash_bwd_dq(pq, pk, pv, pdo, lse, delta, w, ps),) + \
            PF.flash_bwd_dkv(pq, pk, pv, pdo, lse, delta, w, ps)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        assert all(torch.equal(g, r) for g, r in zip(
            PF.flash_attention_bwd(pq, pk, pv, o, lse, pdo, w, ps), ref))
    assert PK.launch_counts() == {n: 0 for n in PK.WRAPPERS}  # CPU: plain versions
    assert {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"} <= set(PK.MODES["alibi"])
    assert set(PK.mode_launch_counts("alibi").values()) == {0}


@pytest.mark.parametrize("source", sorted(PB.SIGNATURES))
def test_ctypes_signatures_match_the_c_entry_points(source):
    """Each C entry point a wrapper calls through ctypes takes as many
    arguments as build.SIGNATURES declares for it (a pointer more or less
    would shift every argument after it)."""
    text = (ROOT / "deepspeed_tpu_torch" / "csrc" / f"{source}.cu").read_text()
    for fn, argtypes in PB.SIGNATURES[source].items():
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert m, fn
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), (fn, params)
        for p, a in zip(params, argtypes):
            assert ("*" in p) == (a is PB._P), (fn, p)


# ---------------------------------------------------------------------------
# model loss, gradients and logits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batch():
    r = np.random.default_rng(2)
    tokens = r.integers(0, TINY["vocab_size"], (2, 33)).astype(np.int32)
    mask = np.ones_like(tokens)
    mask[1, 20:] = 0
    return {"tokens": tokens, "mask": mask}


@pytest.fixture(scope="module")
def jax_refs(batch):
    """JAX loss and gradients per (model, loss_chunks), one remat mode:
    every remat mode of the JAX package computes the same values (remat
    trades memory, not arithmetic), so the port's three modes are held
    against one reference each."""
    out = {}
    for model, over in MODELS.items():
        jc = JT.TransformerConfig(**over)
        tree = numpy_params(jc, seed=5)
        for chunks in (1, 4):
            loss, grads = jax.value_and_grad(JT.make_loss_fn(jc, loss_chunks=chunks))(
                to_jax(tree), batch, None)
            out[model, chunks] = (tree, float(loss), jax.tree.map(np.asarray, grads))
    return out


@pytest.mark.parametrize("loss_chunks", [1, 4])
@pytest.mark.parametrize("remat", ["none", "full", "save_attn_qkv"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_loss_and_grads_match_jax_value_and_grad(jax_refs, batch, model, remat, loss_chunks):
    tree, jl, jg = jax_refs[model, loss_chunks]
    pc = PT.TransformerConfig(**MODELS[model], remat=remat)
    live = tree_map(lambda p: p.requires_grad_(), params_from_numpy(tree, pc, device="cpu"))
    loss = PT.make_loss_fn(pc, loss_chunks=loss_chunks)(live, batch, None)
    grads = dict(zip(flatten(live), (g.numpy() for g in torch.autograd.grad(loss,
                                                                            leaves(live)))))
    np.testing.assert_allclose(loss.item(), jl, **TOL)
    ref = {k: np.asarray(v) for k, v in flatten(jg).items()}
    assert sorted(grads) == sorted(ref)
    for name, g in grads.items():
        if name == "layers/bk":
            # exactly zero: a key bias shifts every score of a row by the
            # same q . bk, which the softmax ignores; both packages' values
            # are rounding noise, each held under the atol of wk, its sibling
            limit = 1e-4 * np.abs(ref["layers/wk"]).max()
            assert max(np.abs(g).max(), np.abs(ref[name]).max()) < limit
            continue
        np.testing.assert_allclose(g, ref[name], rtol=1e-4, atol=1e-4 * np.abs(ref[name]).max(),
                                   err_msg=name)
        if name.startswith(("layers/b", "embed_ln", "ln_f_bias")):  # the Bloom leaves train
            assert np.abs(g).max() > 1e-3, name


@pytest.mark.parametrize("model", sorted(MODELS))
def test_logits_match_jax_forward(jax_refs, batch, model):
    tree = jax_refs[model, 1][0]
    jc, pc = JT.TransformerConfig(**MODELS[model]), PT.TransformerConfig(**MODELS[model])
    toks = batch["tokens"][:, :-1]
    ref = JT.forward(to_jax(tree), jnp.asarray(toks), jc)
    got = PT.forward(params_from_numpy(tree, pc, device="cpu"), torch.from_numpy(toks), pc)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    # ALiBi bites: every slope 0 gives other logits
    flat = PT.TransformerConfig(**dict(MODELS[model], alibi_slope_scale=0.0))
    other = PT.forward(params_from_numpy(tree, flat, device="cpu"), torch.from_numpy(toks), flat)
    assert np.abs(other.detach().numpy() - np.asarray(ref)).max() > 1e-2


@pytest.mark.parametrize("model", sorted(MODELS))
def test_flops_per_token_and_logical_specs_match(model):
    jc, pc = JT.TransformerConfig(**MODELS[model]), PT.TransformerConfig(**MODELS[model])
    assert pc.flops_per_token(64) == jc.flops_per_token(64)
    assert pc.flops_per_token() == jc.flops_per_token()
    assert PT.logical_specs(pc) == JT.logical_specs(jc)
    assert PT.param_count(pc) == JT.param_count(jc)


# ---------------------------------------------------------------------------
# engine trajectory on a tiny Bloom-class model
# ---------------------------------------------------------------------------

ENGINE_MODEL = dict(vocab_size=128, n_layers=2, n_heads=4, d_model=64, max_seq=32,
                    variant="gpt2", alibi=True, embedding_layernorm=True, activation="gelu")
ENGINE_CONFIG = {
    "train_batch_size": 16,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4,
                                                 "warmup_max_lr": 1e-3,
                                                 "warmup_num_steps": 4,
                                                 "warmup_type": "linear"}},
    "gradient_clipping": 1.0,
    "seed": 7,
    "steps_per_print": 1000,
}
N_STEPS = 5


@pytest.fixture(scope="module")
def trajectories():
    jc = JT.TransformerConfig(**ENGINE_MODEL)
    pc = PT.TransformerConfig(**ENGINE_MODEL)
    tree = numpy_params(jc, seed=9, std=0.05)
    r = np.random.default_rng(4)
    batches = [{"tokens": r.integers(0, 128, (16, 33)).astype(np.int32)}
               for _ in range(N_STEPS)]
    jeng = jds.initialize(dict(ENGINE_CONFIG, mesh={"data": -1}), loss_fn=JT.make_loss_fn(jc),
                          params=to_jax(tree), param_logical_specs=JT.logical_specs(jc))
    peng = pds.initialize(dict(ENGINE_CONFIG), loss_fn=PT.make_loss_fn(pc),
                          params=params_from_numpy(tree, pc, device="cpu"),
                          param_logical_specs=PT.logical_specs(pc), device="cpu")
    jm = [jeng.train_batch(b) for b in batches]
    pm = [peng.train_batch(b) for b in batches]
    return jm, pm, jax.tree.map(np.asarray, jeng.state.params), params_to_numpy(
        peng.state.params)


def test_engine_lr_identical(trajectories):
    jm, pm = trajectories[:2]
    assert [m["lr"] for m in pm] == [m["lr"] for m in jm]


@pytest.mark.parametrize("metric", ["loss", "grad_norm"])
def test_engine_metric_matches(trajectories, metric):
    jm, pm = trajectories[:2]
    np.testing.assert_allclose([m[metric] for m in pm], [m[metric] for m in jm], rtol=2e-4)


def test_engine_final_params_match(trajectories):
    """As tests/test_torch_train.py's Llama trajectory: five AdamW steps
    move a weight by at most 5e-3, and Adam's per-weight normalisation
    lets an f32 rounding difference in a gradient near zero move a step
    far more than the rounding itself; rtol 1e-5 and atol 1e-5 (a
    hundredth of one full step), every Bloom leaf (biases, LayerNorm
    biases, the embedding LayerNorm) included and moved. The key bias bk
    is the exception: its exact gradient is zero (the softmax ignores a
    shift of a whole row), so each engine's Adam turns its own f32 noise
    into steps of up to noise / (noise + eps) x lr. It is held within a
    tenth of the summed learning rates; a real gradient would move it by
    about the whole sum."""
    jm, pm, jparams, pparams = trajectories
    ref = flatten(jparams)
    start = flatten(numpy_params(JT.TransformerConfig(**ENGINE_MODEL), seed=9, std=0.05))
    assert sorted(flatten(pparams)) == sorted(ref)
    for name, got in flatten(pparams).items():
        if name == "layers/bk":
            np.testing.assert_allclose(got, ref[name], rtol=0,
                                       atol=0.1 * sum(m["lr"] for m in pm), err_msg=name)
            continue
        np.testing.assert_allclose(got, ref[name], rtol=1e-5, atol=1e-5, err_msg=name)
        assert np.abs(got - start[name]).max() > 1e-4, name


# ---------------------------------------------------------------------------
# chip_smoke.py's falcon-rw-1b config
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_falcon_rw_is_config_from_hf_of_falcon_rw_1b():
    """chip_smoke.py's FALCON_RW dict is, field by field, the JAX package's
    config_from_hf of tiiuae/falcon-rw-1b's config.json (LayerNorm, erf
    GELU, a 4 x d_model MLP, biases, head_dim 64, slope scale 1/8), and
    counts the same parameters in both packages."""
    want = config_from_hf(FALCON_RW_1B_HF)
    got = PT.TransformerConfig(**_chip_smoke().FALCON_RW)
    for f in dataclasses.fields(JT.TransformerConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert PT.param_count(got) == JT.param_count(want) == 1_311_625_216
    assert (got.head_dim, got.kv_heads, got.ff_dim, got.alibi_slope_scale) == (64, 32, 8192,
                                                                               0.125)
    assert PT.unported_features(got) == []
    PT.check_trained(got)
