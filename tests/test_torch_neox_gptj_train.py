"""GPT-NeoX- and GPT-J-class training of the port held against the JAX
package on the CPU, from the same numpy-made inputs.

- the flash backward's plain version (`flash_attention_bwd_plain`, the
  recompute-from-lse math that kernels #2 and #3 implement) at head_dim 96
  (GPT-NeoX-20B) and 256 (GPT-J-6B), each in two cases: GQA (4 query
  heads over one KV head) with the window 40 at S 100 (no multiple of the
  64-row tiles), and MHA with ALiBi slopes; against jax.vjp of the JAX
  flash kernel run in interpret mode and of `_xla_attention`, in f32 at
  2e-4 (the pin of
  tests/test_torch_falcon_phi_train.py); in bf16 (P and dS rounded to
  bf16, as the kernels do) from the JAX forward's own o and lse against
  jax.grad of the interpret-mode kernel under the tolerance the CUDA
  kernels are held to (`bwd_mismatch`), which the planted faults of the
  card checks fail: the gradients' columns 80-95 (D 96) or 128-255 (D
  256) zeroed, and the scores taken over the first 64 or 128 dims;
- `make_loss_fn` loss and every parameter's gradient for the tiny GPT-NeoX
  and GPT-J forms of tests/_torch_parity.py (NEOX_GPTJ) against
  jax.value_and_grad of the JAX loss, f32 at rtol 1e-4 and atol 1e-4 of
  each leaf's largest gradient, in every remat mode the port maps and with
  and without chunked CE; the training forward's logits against the JAX
  forward;
- a port engine against a JAX engine over 5 steps on a tiny GPT-J form
  (one head of 256, interleaved partial rotary, an lm_head bias; AdamW
  with weight decay, clipping, linear WarmupLR): lr, loss, grad_norm and
  the final parameters;
- flops_per_token, logical_specs and param_count of both forms, the CPU
  wrappers of #2/#3 and their d96/d256 counters, and chip_smoke.py's two
  training configs (GPT-NeoX-20B's and GPT-J-6B's widths 4 layers deep).

Every JAX reference is jitted (one compile, not one per op), the model
references are built once per module, and the JAX kernel runs in one
block of up to 128 rows: the file's time is mostly JAX compiles, which
the tier-1 run's parallel workers slow several times over.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as pds
from _torch_parity import GPT_J_TINY, NEOX_GPTJ, NEOX_GPTJ_STD, flatten, numpy_params, to_jax
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import attention as JA
from deepspeed_tpu.ops.pallas import flash_attention as JF
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops import cuda as PK
from deepspeed_tpu_torch.ops.cuda import flash_attention as PF
from deepspeed_tpu_torch.utils.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.utils.tree import leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
FLASH_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# the flash backward at head_dim 96 and 256
# ---------------------------------------------------------------------------

# (S, H, KV, D, window, alibi): S 100 is no multiple of the 64-row tiles
BWD_CASES = {f"d{D}_{name}": (S, H, KV, D, window, alibi)
             for D in (96, 256)
             for name, (S, H, KV, window, alibi) in {
                 "gqa_4_over_1_window_40_s100": (100, 4, 1, 40, False),
                 "mha_alibi": (128, 2, 2, 0, True)}.items()}
BLOCK = 128  # the JAX kernel's block_q and block_k (capped at S)
ZERO_FROM = {96: 80, 256: 128}  # the zeroed gradient columns' first
SCORE_DIMS = {96: 64, 256: 128}  # the dims the spoiled scores are taken over


def _bwd_inputs(rng, case):
    S, H, KV, D, window, alibi = BWD_CASES[case]
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((1, S, H, D), (1, S, KV, D), (1, S, KV, D), (1, S, H, D)))
    slopes = JA.alibi_slopes(H).astype(np.float32) if alibi else None
    return q, k, v, do, window, slopes


def _jax_grads(attn, q, k, v, do):
    return jax.jit(jax.grad(lambda q, k, v: jnp.sum(attn(q, k, v).astype(jnp.float32)
                                                    * do.astype(jnp.float32)),
                            argnums=(0, 1, 2)))(q, k, v)


def _jax_kernel(window, slopes):
    js = None if slopes is None else jnp.asarray(slopes)
    return lambda q, k, v: JF.flash_attention(q, k, v, causal=True, block_q=BLOCK,
                                              block_k=BLOCK, window=window, alibi=js)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_backward_matches_jax_kernel_and_xla_grads(rng, case):
    q, k, v, do, window, slopes = _bwd_inputs(rng, case)
    G = q.shape[2] // k.shape[2]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    js = None if slopes is None else jnp.asarray(slopes)
    kernel = _jax_grads(_jax_kernel(window, slopes), jq, jk, jv, jdo)
    xla = _jax_grads(lambda q, k, v: JA._xla_attention(q, JA._repeat_kv(k, G),
                                                       JA._repeat_kv(v, G), window=window,
                                                       alibi=js), jq, jk, jv, jdo)
    pq, pk, pv, pdo = (_t(a) for a in (q, k, v, do))
    ps = None if slopes is None else _t(slopes)
    o, lse = PF.flash_attention_plain(pq, pk, pv, window, ps)
    got = PF.flash_attention_bwd_plain(pq, pk, pv, o, lse, pdo, window, ps)
    for name, g, a, b in zip(("dq", "dk", "dv"), got, kernel, xla):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), err_msg=name, **FLASH_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(b), err_msg=name, **FLASH_TOL)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_kernel_rounding_matches_jax_kernel_in_bf16(rng, case):
    """On bf16 inputs the JAX kernel rounds P and dS to bf16 before its
    products, and so does the port's plain backward. From the JAX
    forward's own o and lse, the port's plain backward is within the
    tolerance the CUDA kernels are held to (`bwd_mismatch`) of jax.grad of
    the interpret-mode kernel, and each planted fault of the card checks
    (the gradients' columns from ZERO_FROM zeroed; the scores over the
    first SCORE_DIMS dims) fails it in every gradient."""
    q, k, v, do, window, slopes = _bwd_inputs(rng, case)
    B, S, H, D = q.shape
    KV = k.shape[2]
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    to_bh = lambda x: x.transpose(0, 2, 1, 3).reshape(-1, S, D)
    js = None if slopes is None else jnp.asarray(slopes)
    bq = min(BLOCK, S)
    o, lse = jax.jit(lambda q, k, v: JF._flash_fwd(q, k, v, js, True, bq, bq, H, KV, window,
                                                   slopes is not None))(
        to_bh(jq), to_bh(jk), to_bh(jv))
    o = np.asarray(o, np.float32).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    lse = _t(np.asarray(lse).reshape(B, H, S))
    ref = [_t(np.asarray(r, np.float32))
           for r in _jax_grads(_jax_kernel(window, slopes), jq, jk, jv, jdo)]
    q_, k_, v_, o_, do_ = (_t(np.asarray(a, np.float32)).to(torch.bfloat16)
                           for a in (jq, jk, jv, o, jdo))
    ps = None if slopes is None else _t(slopes)
    got = PF.flash_attention_bwd_plain(q_, k_, v_, o_, lse, do_, window, ps)
    for name, r, g in zip(("dq", "dk", "dv"), ref, got):
        stats = PF.bwd_mismatch(r, g)
        assert stats["n_over"] == 0, (name, stats)
    q_cut = q_.clone()
    q_cut[..., SCORE_DIMS[D]:] = 0
    spoiled = PF.flash_attention_bwd_plain(q_cut, k_, v_, o_, lse, do_, window, ps)
    for name, r, g, s in zip(("dq", "dk", "dv"), ref, got, spoiled):
        zeroed = g.clone()
        zeroed[..., ZERO_FROM[D]:] = 0
        assert PF.bwd_mismatch(r, zeroed)["n_over"] > 0, name
        assert PF.bwd_mismatch(r, s)["n_over"] > 0, name


def test_cpu_wrappers_are_the_plain_backward_and_count_the_new_modes(rng):
    """On CPU tensors the #2/#3 wrappers are the plain backward at D 96 and
    256, and launch nothing; both wrappers carry the d96 and d256 counters
    (ops.cuda.MODES), and kernel #3's group split counts 64-key blocks at
    256 and 128-key blocks below."""
    PK.reset_launch_counts()
    for case in ("d96_gqa_4_over_1_window_40_s100", "d256_mha_alibi"):
        q, k, v, do, window, slopes = _bwd_inputs(rng, case)
        q, k, v, do = (_t(a) for a in (q, k, v, do))
        sl = None if slopes is None else _t(slopes)
        o, lse = PF.flash_fwd(q, k, v, window, sl)
        delta = PF._delta(o, do)
        ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do, window, sl)
        got = (PF.flash_bwd_dq(q, k, v, do, lse, delta, window, sl),) + PF.flash_bwd_dkv(
            q, k, v, do, lse, delta, window, sl)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    assert PK.launch_counts() == {n: 0 for n in PK.WRAPPERS}
    for mode in ("d96", "d256"):
        assert {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"} <= set(PK.MODES[mode])
        assert set(PK.mode_launch_counts(mode).values()) == {0}
    assert [PF.dkv_key_block(D) for D in (64, 80, 96, 128, 256)] == [128, 128, 128, 128, 64]


# ---------------------------------------------------------------------------
# model loss, gradients and logits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batch():
    r = np.random.default_rng(2)
    tokens = r.integers(0, 512, (2, 33)).astype(np.int32)
    mask = np.ones_like(tokens)
    mask[1, 20:] = 0
    return {"tokens": tokens, "mask": mask}


@pytest.fixture(scope="module")
def jax_refs(batch):
    """JAX loss and gradients per (model, loss_chunks), built once for the
    module in one remat mode: every remat mode of the JAX package computes
    the same values (remat trades memory, not arithmetic), so the port's
    three modes are held against one reference each."""
    out = {}
    for model, over in NEOX_GPTJ.items():
        jc = JT.TransformerConfig(**over)
        tree = numpy_params(jc, seed=5, std=NEOX_GPTJ_STD[model])
        for chunks in (1, 4):
            loss, grads = jax.jit(jax.value_and_grad(JT.make_loss_fn(jc, loss_chunks=chunks)))(
                to_jax(tree), batch, None)
            out[model, chunks] = (tree, float(loss), jax.tree.map(np.asarray, grads))
    return out


def _shift_invariant_bk(cfg, bk):
    """A key bias adds the same q . bk to every score of a row, which the
    softmax ignores, except in the rotated dims: (rotated part,
    shift-invariant part, whose gradient is exactly zero)."""
    R = PT.rope_dim(cfg)
    return bk[..., :R], bk[..., R:]


def _loss_and_grads(pc, tree, batch, loss_chunks):
    live = tree_map(lambda p: p.requires_grad_(), params_from_numpy(tree, pc, device="cpu"))
    loss = PT.make_loss_fn(pc, loss_chunks=loss_chunks)(live, batch, None)
    return loss.item(), dict(zip(flatten(live), (g.numpy() for g in torch.autograd.grad(
        loss, leaves(live)))))


@pytest.mark.parametrize("loss_chunks", [1, 4])
@pytest.mark.parametrize("remat", ["none", "full", "save_attn_qkv"])
@pytest.mark.parametrize("model", sorted(NEOX_GPTJ))
def test_loss_and_grads_match_jax_value_and_grad(jax_refs, batch, model, remat, loss_chunks):
    tree, jl, jg = jax_refs[model, loss_chunks]
    pc = PT.TransformerConfig(**NEOX_GPTJ[model], remat=remat)
    loss, grads = _loss_and_grads(pc, tree, batch, loss_chunks)
    np.testing.assert_allclose(loss, jl, **TOL)
    ref = {k: np.asarray(v) for k, v in flatten(jg).items()}
    assert sorted(grads) == sorted(ref)
    for name, g in grads.items():
        r = ref[name]
        if name == "layers/bk":  # the GPT-NeoX form's key bias
            # the shift-invariant dims: both packages' values are rounding
            # noise, each held under the atol of wk, its sibling
            (g, g0), (r, r0) = _shift_invariant_bk(pc, g), _shift_invariant_bk(pc, r)
            assert max(np.abs(g0).max(), np.abs(r0).max()) < 1e-4 * np.abs(ref["layers/wk"]).max()
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=name)
        assert np.abs(g).max() > 1e-3, name  # every leaf trains


@pytest.mark.parametrize("model", sorted(NEOX_GPTJ))
def test_logits_match_jax_forward(jax_refs, batch, model):
    """The training forward's logits, at rtol 1e-4 and atol 1e-4 of the
    largest |logit| (as the gradients are held)."""
    tree = jax_refs[model, 1][0]
    jc, pc = JT.TransformerConfig(**NEOX_GPTJ[model]), PT.TransformerConfig(**NEOX_GPTJ[model])
    toks = batch["tokens"][:, :-1]
    ref = np.asarray(jax.jit(lambda p, t: JT.forward(p, t, jc))(to_jax(tree), jnp.asarray(toks)))
    got = PT.forward(params_from_numpy(tree, pc, device="cpu"), torch.from_numpy(toks), pc)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("model", sorted(NEOX_GPTJ))
def test_flops_per_token_and_logical_specs_match(model):
    jc, pc = JT.TransformerConfig(**NEOX_GPTJ[model]), PT.TransformerConfig(**NEOX_GPTJ[model])
    assert pc.flops_per_token(64) == jc.flops_per_token(64)
    assert pc.flops_per_token() == jc.flops_per_token()
    assert PT.logical_specs(pc) == JT.logical_specs(jc)
    assert PT.param_count(pc) == JT.param_count(jc)


# ---------------------------------------------------------------------------
# engine trajectory on a tiny GPT-J form
# ---------------------------------------------------------------------------

# one head of 256 (rotary on 64 of its dims, interleaved), max_seq 32
ENGINE_MODEL = dict(GPT_J_TINY, vocab_size=128, n_heads=1, d_model=256, d_ff=512, max_seq=32)
ENGINE_CONFIG = {
    "train_batch_size": 16,
    "gradient_accumulation_steps": 1,
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
    assert pc.head_dim == 256 and pc.rope_interleaved and pc.lm_head_bias
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
    """As tests/test_torch_falcon_phi_train.py's Phi-2 trajectory: rtol
    1e-5 and atol 1e-5 (a hundredth of one full AdamW step), every GPT-J
    leaf (the lm_head and its bias, the shared LayerNorm, the MLP biases)
    included and moved."""
    jm, pm, jparams, pparams = trajectories
    ref = flatten(jparams)
    start = flatten(numpy_params(JT.TransformerConfig(**ENGINE_MODEL), seed=9, std=0.05))
    assert sorted(flatten(pparams)) == sorted(ref)
    assert "lm_head_b" in ref
    for name, got in flatten(pparams).items():
        np.testing.assert_allclose(got, ref[name], rtol=1e-5, atol=1e-5, err_msg=name)
        assert np.abs(got - start[name]).max() > 1e-4, name


# ---------------------------------------------------------------------------
# chip_smoke.py's two training configs
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("phase,model,micro_batch,mode", [
    ("train_neox", "GPT_NEOX_20B", 2, "d96"),
    ("train_gptj", "GPT_J_6B", 4, "d256"),
])
def test_chip_smoke_train_configs(phase, model, micro_batch, mode):
    """train_neox and train_gptj are chip_smoke.py's GPT_NEOX_20B and
    GPT_J_6B (the JAX package's config_from_hf of the published
    config.json, held by tests/test_torch_neox_gptj.py) with only the
    depth (4 layers), the remat policy and use_flash changed; check_trained
    accepts both, and their step runs every flash launch in the phase's
    head-dim mode."""
    cs = _chip_smoke()
    cfg, B, S, path, got_mode = cs.TRAIN_LONG[phase]
    served = getattr(cs, model)
    changed = {k for k in set(cfg) | set(served) if cfg.get(k) != served.get(k)}
    assert changed <= {"n_layers", "remat", "use_flash"}
    assert (cfg["n_layers"], cfg["remat"], cfg["use_flash"]) == (4, "save_attn_qkv", True)
    assert (B, S, path, got_mode) == (micro_batch, 2048, (2, 2048), mode)
    pc = PT.TransformerConfig(**cfg)
    PT.check_trained(pc)
    PT.check_trained(PT.TransformerConfig(**served))
    assert pc.head_dim == int(mode[1:])
