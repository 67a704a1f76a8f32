"""Falcon- and Phi-class training of the port held against the JAX package
on the CPU, from the same numpy-made inputs.

- the flash backward's plain version (`flash_attention_bwd_plain`, the
  recompute-from-lse math that kernels #2 and #3 implement) in the two
  modes of this slice, head_dim 80 (Phi-2) and query groups wider than 8
  (Falcon-7B: 71 over one), against jax.vjp of the JAX flash kernel run in
  interpret mode and of `_xla_attention`, in f32 at 2e-4 (the pin of
  tests/test_torch_falcon_phi.py's flash forward): D 80 with G 1, D 80 at
  GQA 20 over 2 (groups of 10), D 64 at 12 over 1, D 64 at 32 over 2
  (groups of 16); in bf16 (P and dS rounded to bf16, as the kernels do)
  from the JAX forward's own o and lse against jax.grad of the
  interpret-mode kernel under the tolerance the CUDA kernels are held to
  (`bwd_mismatch`), which the planted faults of this slice fail: at
  head_dim 80 the gradients' columns 64-79 zeroed and the scores taken
  over the first 64 dims; in a wide group dk and dv summed without the
  group's last chunk of 8 heads and, with more than one KV head, each q
  head given KV head (h // 8) % KV (a group capped at 8);
- `make_loss_fn` loss and every parameter's gradient for the three forms
  of tests/test_torch_falcon_phi.py (Falcon-7B: parallel residual, one
  shared LayerNorm, 12 query heads over 1; Falcon-40B: two LayerNorms,
  GQA 32 over 2; Phi-2: head_dim 80, partial rotary, biases, an untied
  biased lm_head) against jax.value_and_grad of the JAX loss, f32 at rtol
  1e-4 and atol 1e-4 of each leaf's largest gradient, in every remat mode
  the port maps and with and without chunked CE;
- the training forward's logits against the JAX forward, for the three
  forms and a sequential Llama-class model at head_dim 80; the lm_head
  bias and the parallel residual bite;
- a port engine against a JAX engine over 5 steps on a tiny Phi-2 form
  (AdamW with weight decay on every leaf, the lm_head bias included,
  clipping, linear WarmupLR, GAS 2), held as
  tests/test_torch_alibi_train.py holds the Bloom trajectory;
- flops_per_token, logical_specs and param_count of the three forms, the
  CPU wrappers of #2/#3 and their new mode counters, and chip_smoke.py's
  two training configs (Falcon-7B's width 4 layers deep, Phi-2 whole).
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
from _torch_parity import FALCON_PHI, FALCON_PHI_STD, PHI_2_TINY, flatten, numpy_params, to_jax
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
# the three forms, and a sequential Llama-class model at head_dim 80 (4
# heads of 80, rotary over the whole head)
MODELS = dict(FALCON_PHI, llama_d80=dict(vocab_size=512, n_layers=2, n_heads=4, d_model=320,
                                         max_seq=256, variant="llama"))
STD = dict(FALCON_PHI_STD, llama_d80=0.3 * (256 / 320) ** 0.5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# the flash backward at head_dim 80 and in wide query groups
# ---------------------------------------------------------------------------

# (S, H, KV, D): S 100 is no multiple of the 64-row tiles
BWD_CASES = {"d80_g1": (128, 4, 4, 80), "d80_gqa_20_over_2": (100, 20, 2, 80),
             "d64_12_over_1": (128, 12, 1, 64), "d64_32_over_2": (100, 32, 2, 64)}


def _bwd_inputs(rng, case):
    S, H, KV, D = BWD_CASES[case]
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((1, S, H, D), (1, S, KV, D), (1, S, KV, D), (1, S, H, D)))


def _jax_vjp(attn, q, k, v, do):
    _, vjp = jax.vjp(attn, q, k, v)
    return vjp(do)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_backward_matches_jax_kernel_and_xla_grads(rng, case):
    q, k, v, do = _bwd_inputs(rng, case)
    G = q.shape[2] // k.shape[2]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    kernel = _jax_vjp(lambda q, k, v: JF.flash_attention(q, k, v, causal=True, block_q=64,
                                                         block_k=64), jq, jk, jv, jdo)
    xla = _jax_vjp(lambda q, k, v: JA._xla_attention(q, JA._repeat_kv(k, G), JA._repeat_kv(v, G)),
                   jq, jk, jv, jdo)
    pq, pk, pv, pdo = (_t(a) for a in (q, k, v, do))
    o, lse = PF.flash_attention_plain(pq, pk, pv)
    got = PF.flash_attention_bwd_plain(pq, pk, pv, o, lse, pdo)
    for name, g, a, b in zip(("dq", "dk", "dv"), got, kernel, xla):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), err_msg=name, **FLASH_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(b), err_msg=name, **FLASH_TOL)


def _first_64_dims(t):
    t = t.clone()
    t[..., 64:] = 0
    return t


def _faults(q, k, v, o, lse, do):
    """The planted faults of the slice's two modes, as what a wrong kernel
    would output from the same residuals (bf16 tensors; a mode's faults
    only where its case has it). Returns {fault: (dq, dk, dv)}."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    out = {}
    good = PF.flash_attention_bwd_plain(q, k, v, o, lse, do)
    if D == 80:
        out["columns_64_79_zeroed"] = tuple(_first_64_dims(g) for g in good)
        out["scores_over_first_64_dims"] = PF.flash_attention_bwd_plain(_first_64_dims(q), k, v,
                                                                        o, lse, do)
    if G > 8:
        # dk, dv of each group summed without its last chunk of 8 heads
        keep = torch.arange(H).reshape(KV, G)[:, :8 * ((G - 1) // 8)].flatten()
        part = PF._bwd_plain(q[:, :, keep], k, v, lse[:, keep], PF._delta(o, do)[:, keep],
                             do[:, :, keep])
        out["last_chunk_of_8_dropped"] = (good[0],) + part[1:]
    if G > 8 and KV > 1:
        # each q head h given KV head (h // 8) % KV: a group capped at 8
        idx = (torch.arange(H) // 8) % KV
        capped = PF.flash_attention_bwd_plain(q, k[:, :, idx], v[:, :, idx], o, lse, do)
        fold = lambda g: torch.zeros(B, S, KV, D).index_add_(2, idx, g.float()).to(g.dtype)
        out["q_head_given_kv_head_h_div_8"] = (capped[0], fold(capped[1]), fold(capped[2]))
    return out


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_kernel_rounding_matches_jax_kernel_in_bf16(rng, case):
    """On bf16 inputs the JAX kernel rounds P and dS to bf16 before its
    products, and so does the port's plain backward. From the JAX
    forward's own o and lse, the port's plain backward is within the
    tolerance the CUDA kernels are held to (`bwd_mismatch`) of jax.grad of
    the interpret-mode kernel, and every planted fault of the case's modes
    fails it in at least one gradient it touches."""
    q, k, v, do = _bwd_inputs(rng, case)
    B, S, H, D = q.shape
    KV = k.shape[2]
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    to_bh = lambda x: x.transpose(0, 2, 1, 3).reshape(-1, S, D)
    o, lse = JF._flash_fwd(to_bh(jq), to_bh(jk), to_bh(jv), None, True, 64, 64, H, KV)
    o = np.asarray(o, np.float32).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    lse = _t(np.asarray(lse).reshape(B, H, S))
    ref = jax.grad(lambda q, k, v: jnp.sum(
        JF.flash_attention(q, k, v, causal=True, block_q=64, block_k=64).astype(jnp.float32)
        * jdo.astype(jnp.float32)), argnums=(0, 1, 2))(jq, jk, jv)
    ref = [_t(np.asarray(r, np.float32)) for r in ref]
    q_, k_, v_, o_, do_ = (_t(np.asarray(a, np.float32)).to(torch.bfloat16)
                           for a in (jq, jk, jv, o, jdo))
    got = PF.flash_attention_bwd_plain(q_, k_, v_, o_, lse, do_)
    for name, r, g in zip(("dq", "dk", "dv"), ref, got):
        stats = PF.bwd_mismatch(r, g)
        assert stats["n_over"] == 0, (name, stats)
    faults = _faults(q_, k_, v_, o_, lse, do_)
    assert faults  # every case runs in at least one of the two modes
    for fault, grads in faults.items():
        over = {name: PF.bwd_mismatch(r, g)["n_over"]
                for name, r, g in zip(("dq", "dk", "dv"), ref, grads)}
        touched = ("dk", "dv") if fault == "last_chunk_of_8_dropped" else ("dq", "dk", "dv")
        assert all(over[n] > 0 for n in touched), (fault, over)


def test_cpu_wrappers_are_the_plain_backward_and_count_the_new_modes(rng):
    """On CPU tensors the #2/#3 wrappers are the plain backward at D 80 and
    in a wide group, and launch nothing; both wrappers carry the
    wide-group and head_dim-80 counters (ops.cuda.MODES)."""
    PK.reset_launch_counts()
    for case in ("d80_gqa_20_over_2", "d64_12_over_1"):
        q, k, v, do = (_t(a) for a in _bwd_inputs(rng, case))
        o, lse = PF.flash_fwd(q, k, v)
        delta = PF._delta(o, do)
        ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do)
        got = (PF.flash_bwd_dq(q, k, v, do, lse, delta),) + PF.flash_bwd_dkv(q, k, v, do, lse,
                                                                              delta)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    assert PK.launch_counts() == {n: 0 for n in PK.WRAPPERS}
    for mode in ("wide_group", "d80"):
        assert {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"} <= set(PK.MODES[mode])
        assert set(PK.mode_launch_counts(mode).values()) == {0}


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
    """JAX loss and gradients per (model, loss_chunks), one remat mode:
    every remat mode of the JAX package computes the same values (remat
    trades memory, not arithmetic), so the port's three modes are held
    against one reference each."""
    out = {}
    for model, over in MODELS.items():
        jc = JT.TransformerConfig(**over)
        tree = numpy_params(jc, seed=5, std=STD[model])
        for chunks in (1, 4):
            loss, grads = jax.value_and_grad(JT.make_loss_fn(jc, loss_chunks=chunks))(
                to_jax(tree), batch, None)
            out[model, chunks] = (tree, float(loss), jax.tree.map(np.asarray, grads))
    return out


def _shift_invariant_bk(cfg, bk):
    """The entries of a key-bias gradient that are exactly zero: a key
    bias adds the same q . bk to every score of a row, which the softmax
    ignores, except in the rotated dims, where rope turns it into a
    position-dependent term. Returns (rotated part, shift-invariant part)."""
    R = PT.rope_dim(cfg) if cfg.use_rope else 0
    return bk[..., :R], bk[..., R:]


def _loss_and_grads(pc, tree, batch, loss_chunks):
    live = tree_map(lambda p: p.requires_grad_(), params_from_numpy(tree, pc, device="cpu"))
    loss = PT.make_loss_fn(pc, loss_chunks=loss_chunks)(live, batch, None)
    return loss.item(), dict(zip(flatten(live), (g.numpy() for g in torch.autograd.grad(
        loss, leaves(live)))))


def _assert_grads_match(pc, grads, jg):
    ref = {k: np.asarray(v) for k, v in flatten(jg).items()}
    assert sorted(grads) == sorted(ref)
    for name, g in grads.items():
        r = ref[name]
        if name == "layers/bk":
            # the shift-invariant dims: both packages' values are rounding
            # noise, each held under the atol of wk, its sibling
            (g, g0), (r, r0) = _shift_invariant_bk(pc, g), _shift_invariant_bk(pc, r)
            limit = 1e-4 * np.abs(ref["layers/wk"]).max()
            assert max(np.abs(g0).max(), np.abs(r0).max()) < limit
            if not g.size:
                continue
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=name)
        assert np.abs(g).max() > 1e-3, name  # every leaf trains, lm_head_b and ln2 included


@pytest.mark.parametrize("loss_chunks", [1, 4])
@pytest.mark.parametrize("remat", ["none", "full", "save_attn_qkv"])
@pytest.mark.parametrize("model", sorted(FALCON_PHI))
def test_loss_and_grads_match_jax_value_and_grad(jax_refs, batch, model, remat, loss_chunks):
    tree, jl, jg = jax_refs[model, loss_chunks]
    pc = PT.TransformerConfig(**MODELS[model], remat=remat)
    loss, grads = _loss_and_grads(pc, tree, batch, loss_chunks)
    np.testing.assert_allclose(loss, jl, **TOL)
    _assert_grads_match(pc, grads, jg)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_logits_match_jax_forward(jax_refs, batch, model):
    """rtol 1e-4 and atol 1e-4 of the largest |logit|, as the gradients
    are held: at d_model 2048 (the Falcon-40B form) the two frameworks'
    f32 sums of terms the size of the largest logits (~12) differ by up to
    ~1e-5 of it, which an absolute 1e-4 misses on a logit near zero."""
    tree = jax_refs[model, 1][0]
    jc, pc = JT.TransformerConfig(**MODELS[model]), PT.TransformerConfig(**MODELS[model])
    toks = batch["tokens"][:, :-1]
    ref = np.asarray(JT.forward(to_jax(tree), jnp.asarray(toks), jc))
    got = PT.forward(params_from_numpy(tree, pc, device="cpu"), torch.from_numpy(toks), pc)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("model", sorted(FALCON_PHI))
def test_parallel_residual_bites_in_training(jax_refs, batch, model):
    """The same weights read as a sequential-residual model (ln2 = ln1
    where the form shares one) give other logits, by far more than the
    tolerance above."""
    over = MODELS[model]
    tree = jax_refs[model, 1][0]
    seq_tree = dict(tree, layers=dict(tree["layers"]))
    if over["shared_ln"]:
        for leaf in ("scale", "bias"):
            if f"ln1_{leaf}" in tree["layers"]:
                seq_tree["layers"][f"ln2_{leaf}"] = tree["layers"][f"ln1_{leaf}"]
    pc = PT.TransformerConfig(**over)
    sc = PT.TransformerConfig(**dict(over, parallel_residual=False, shared_ln=False))
    toks = torch.from_numpy(batch["tokens"][:, :-1])
    a = PT.forward(params_from_numpy(tree, pc, device="cpu"), toks, pc)
    b = PT.forward(params_from_numpy(seq_tree, sc, device="cpu"), toks, sc)
    assert (a - b).abs().max().item() > 1e-2


def test_lm_head_bias_bites_in_training(jax_refs, batch):
    """Phi-2's lm_head bias: the training forward's logits are those with
    the bias zeroed plus the bias, and its gradient is the summed softmax
    residual of every counted token (JAX's, at the pin above)."""
    tree = jax_refs["phi_2", 1][0]
    pc = PT.TransformerConfig(**PHI_2_TINY)
    toks = torch.from_numpy(batch["tokens"][:, :-1])
    params = params_from_numpy(tree, pc, device="cpu")
    with_b = PT.forward(params, toks, pc)
    params["lm_head_b"] = torch.zeros_like(params["lm_head_b"])
    without = PT.forward(params, toks, pc)
    np.testing.assert_allclose((with_b - without).detach().numpy(),
                               np.broadcast_to(tree["lm_head_b"], with_b.shape),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(tree["lm_head_b"]).max() > 1e-2


@pytest.mark.parametrize("model", sorted(FALCON_PHI))
def test_flops_per_token_and_logical_specs_match(model):
    jc, pc = JT.TransformerConfig(**MODELS[model]), PT.TransformerConfig(**MODELS[model])
    assert pc.flops_per_token(64) == jc.flops_per_token(64)
    assert pc.flops_per_token() == jc.flops_per_token()
    assert PT.logical_specs(pc) == JT.logical_specs(jc)
    assert PT.param_count(pc) == JT.param_count(jc)


# ---------------------------------------------------------------------------
# engine trajectory on a tiny Phi-2 form
# ---------------------------------------------------------------------------

ENGINE_MODEL = dict(PHI_2_TINY, vocab_size=128, n_heads=2, d_model=160, d_ff=640, max_seq=32)
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
    """As tests/test_torch_alibi_train.py's Bloom trajectory: rtol 1e-5 and
    atol 1e-5 (a hundredth of one full AdamW step), every Phi-2 leaf (the
    lm_head and its bias, the shared LayerNorm, the biases) included and
    moved. The key bias bk's shift-invariant dims (past the partial
    rotary's 32) have an exactly zero gradient, so each engine's Adam
    turns its own f32 noise into steps of up to noise / (noise + eps) x
    lr: they are held within a tenth of the summed learning rates, where a
    real gradient would move them by about the whole sum."""
    jm, pm, jparams, pparams = trajectories
    pc = PT.TransformerConfig(**ENGINE_MODEL)
    ref = flatten(jparams)
    start = flatten(numpy_params(JT.TransformerConfig(**ENGINE_MODEL), seed=9, std=0.05))
    assert sorted(flatten(pparams)) == sorted(ref)
    assert "lm_head_b" in ref
    for name, got in flatten(pparams).items():
        if name == "layers/bk":
            (got, got0), (r, r0) = (_shift_invariant_bk(pc, x) for x in (got, ref[name]))
            np.testing.assert_allclose(got0, r0, rtol=0, atol=0.1 * sum(m["lr"] for m in pm),
                                       err_msg=name)
            np.testing.assert_allclose(got, r, rtol=1e-5, atol=1e-5, err_msg=name)
            continue
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


@pytest.mark.parametrize("phase,model,n_layers,micro_batch,mode", [
    ("train_falcon", "FALCON_7B", 4, 4, "wide_group"),
    ("train_phi", "PHI_2", 32, 2, "d80"),
])
def test_chip_smoke_train_configs(phase, model, n_layers, micro_batch, mode):
    """train_falcon and train_phi are chip_smoke.py's FALCON_7B and PHI_2
    (the JAX package's config_from_hf of the published config.json, held
    by tests/test_torch_falcon_phi.py) with only the depth, the remat
    policy and use_flash changed; check_trained accepts both, and their
    step runs every flash launch in the phase's kernel mode."""
    cs = _chip_smoke()
    cfg, B, S, path, got_mode = cs.TRAIN_LONG[phase]
    served = getattr(cs, model)
    changed = {k for k in set(cfg) | set(served) if cfg.get(k) != served.get(k)}
    assert changed <= {"n_layers", "remat", "use_flash"}
    assert (cfg["n_layers"], cfg["remat"], cfg["use_flash"]) == (n_layers, "save_attn_qkv", True)
    assert (B, S, path, got_mode) == (micro_batch, 2048, (2, 2048), mode)
    pc = PT.TransformerConfig(**cfg)
    PT.check_trained(pc)
    PT.check_trained(PT.TransformerConfig(**served))
    assert (pc.kv_heads, pc.n_heads // pc.kv_heads, pc.head_dim) == (
        (1, 71, 64) if mode == "wide_group" else (32, 1, 80))
