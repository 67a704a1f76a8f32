"""fp16 mixed-precision training of the port held against the JAX package
on the CPU, from the same numpy-made inputs:

- the dynamic loss scaler (`runtime/precision.py`: init_loss_scale,
  update_loss_scale) bit for bit against the JAX functions at every step
  of a 40-step overflow sequence, over static scales, hysteresis 1, 2 and
  3 with consecutive hysteresis on and off, a small window and the
  minimum scale;
- the flash backward's plain version in f16 (`flash_attention_bwd_plain`,
  P and dS rounded to f16 as kernels #2 and #3 round them) against
  jax.grad of the interpret-mode JAX kernel in f16 under `bwd_mismatch`'s
  f16 tolerance, which planted faults fail (P and dS rounded to bf16 on
  their way to f16; every gradient 2% too large); the same dO scaled until
  f16's dS overflows gives non-finite gradients in the same elements in
  both, and all finite one scale below;
- a tiny Llama-form model trained with "fp16": {"enabled": true} in the
  JAX engine and the port's (one JAX engine per case, built once for the
  module): skip flags, loss scale and lr equal exactly, loss and grad
  norm at the f32 trajectory test's rtol 2e-4 (tests/test_torch_train.py),
  the final master at its 1e-5 as each leaf's error RMS and at half of
  one lr step elementwise (test_final_master_matches says why), every
  overflow decision at least 4x
  from f16's edge (the same step overflows at a quarter of the scale, a
  clean one at four times it), and a static always-overflowing scale
  leaving the master, the moments, the step and the lr bit-unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as pds
from _torch_parity import flatten, numpy_params, to_jax
from deepspeed_tpu.config.config import FP16Config as JFP16Config
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops.pallas import flash_attention as JF
from deepspeed_tpu.runtime import precision as JP
from deepspeed_tpu_torch.config.config import FP16Config as PFP16Config
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops.cuda import flash_attention as PF
from deepspeed_tpu_torch.runtime import precision as PP
from deepspeed_tpu_torch.utils.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.utils.tree import leaves, tree_map


# ---------------------------------------------------------------------------
# the dynamic loss scaler
# ---------------------------------------------------------------------------

SCALER_CASES = {
    "static": dict(loss_scale=1024.0),
    "hysteresis_1": dict(hysteresis=1, loss_scale_window=4),
    "hysteresis_2": dict(hysteresis=2, loss_scale_window=4),
    "hysteresis_3": dict(hysteresis=3, loss_scale_window=4),
    "hysteresis_2_consecutive": dict(hysteresis=2, consecutive_hysteresis=True,
                                     loss_scale_window=4),
    "hysteresis_3_consecutive": dict(hysteresis=3, consecutive_hysteresis=True,
                                     loss_scale_window=4),
    "window_2": dict(hysteresis=2, loss_scale_window=2),
    "minimum_floor": dict(hysteresis=1, initial_scale_power=4, min_loss_scale=4.0,
                          loss_scale_window=5),
}
# overflows in runs of one to five, clean runs of one to six: every branch
# (spend, backoff, floor, grow, refill) is taken in every case
OVERFLOWS = [bool(x) for x in "1011100100000110111110000001000000111001"]


@pytest.mark.parametrize("case", sorted(SCALER_CASES))
def test_loss_scaler_matches_jax_bit_for_bit(case):
    over = dict(SCALER_CASES[case], enabled=True)
    jcfg, pcfg = JFP16Config(**over), PFP16Config(**over)
    js, ps = JP.init_loss_scale(jcfg), PP.init_loss_scale(pcfg)
    update = jax.jit(lambda s, f: JP.update_loss_scale(s, f, jcfg))
    seen = {float(ps.scale)}
    for i, found in enumerate(OVERFLOWS):
        js = update(js, jnp.bool_(found))
        ps = PP.update_loss_scale(ps, torch.tensor(found), pcfg)
        assert ps.scale.dtype == torch.float32 and ps.good_steps.dtype == torch.int32
        got = (np.float32(ps.scale).view(np.int32), int(ps.good_steps), int(ps.hysteresis_left))
        want = (np.float32(js.scale).view(np.int32), int(js.good_steps),
                int(js.hysteresis_left))
        assert got == want, (case, i)
        seen.add(float(ps.scale))
    if case == "static":
        assert seen == {1024.0}
    else:
        assert len(seen) > 2, seen  # the scale moved both ways
    if case == "minimum_floor":
        assert min(seen) == 4.0


# ---------------------------------------------------------------------------
# the flash backward in f16 against the JAX kernel
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _bwd_via_bf16(q, k, v, lse, delta, do):
    """The plain backward with P and dS rounded to bf16 on their way to
    f16: what a kernel whose A fragments went through bf16 would give."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    p = torch.exp(PF._causal_logits(q, k) - lse[..., None].float())
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, PF._repeat_kv(v, G).float())
    ds = p * (dp - delta[..., None].float()) / D ** 0.5
    p, ds = (x.to(torch.bfloat16).to(q.dtype).float() for x in (p, ds))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, PF._repeat_kv(k, G).float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).reshape(B, S, KV, G, D).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(B, S, KV, G, D).sum(3)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def _jax_f16_case(q, k, v, do):
    """jax.grad of the interpret-mode JAX kernel on f16 inputs, with its
    forward's o and lse (handed to the port's plain backward)."""
    attn = dict(causal=True, block_q=64, block_k=64)
    q, k, v, do = (jnp.asarray(a, jnp.float16) for a in (q, k, v, do))
    o, lse = JF.flash_attention_with_lse(q, k, v, **attn)
    grads = jax.grad(lambda q, k, v: jnp.sum(JF.flash_attention(q, k, v, **attn)
                                             .astype(jnp.float32) * do.astype(jnp.float32)),
                     argnums=(0, 1, 2))(q, k, v)
    to16 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.float16)
    return [to16(g) for g in grads], to16(o), _t(np.asarray(lse))


@pytest.mark.parametrize("S", [128, 100])
@pytest.mark.parametrize("KV", [2, 1])
@pytest.mark.parametrize("fault", [None, "p_and_ds_via_bf16", "scale_1.02"])
def test_plain_f16_backward_matches_jax_kernel(rng, S, KV, fault):
    """On f16 inputs the JAX kernel rounds P and dS to f16 before its
    products, and so does the port's plain backward: from the JAX
    forward's o and lse it is held against jax.grad of the interpret-mode
    kernel under bwd_mismatch's f16 tolerance (the limit kernels #2 and #3
    are held to on the card). P and dS rounded through bf16, or every
    gradient 2% too large, fail it."""
    B, H, D = 1, 2, 128
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D))]
    jgrads, o, lse = _jax_f16_case(*arrays)
    q, k, v, do = (_t(a).to(torch.float16) for a in arrays)
    ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do)
    if fault == "p_and_ds_via_bf16":
        ref = _bwd_via_bf16(q, k, v, lse, PF._delta(o, do), do)
    elif fault == "scale_1.02":
        ref = tuple((r.float() * 1.02).half() for r in ref)
    for name, jg, r in zip(("dq", "dk", "dv"), jgrads, ref):
        assert r.dtype == torch.float16
        stats = PF.bwd_mismatch(r, jg)
        assert stats["passed"] == (fault is None), (name, fault, stats)


@pytest.mark.parametrize("KV", [2, 1])
def test_f16_overflow_parity_with_jax_kernel(rng, KV):
    """dO scaled by powers of two until f16's dS overflows
    (PF.f16_overflow_scales, every decision clear of the edge): the port's
    plain backward and jax.grad of the JAX kernel are non-finite in the
    same elements, at least one of dq's, and one scale below both are
    finite everywhere and agree under the f16 tolerance."""
    B, S, H, D = 1, 128, 2, 64
    q, k = (rng.standard_normal(s).astype(np.float32) / 8 for s in ((B, S, H, D),
                                                                      (B, S, KV, D)))
    v = 64 * rng.standard_normal((B, S, KV, D)).astype(np.float32)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    q_, k_, v_, do_ = (_t(a).to(torch.float16) for a in (q, k, v, do))
    o, lse = PF.flash_attention_plain(q_, k_, v_)
    s_over, s_below, stats = PF.f16_overflow_scales(q_, k_, v_, o, lse, do_)
    for s, over in ((s_over, True), (s_below, False)):
        jgrads, jo, jlse = _jax_f16_case(q, k, v, (do_.float() * s).numpy())
        got = PF.flash_attention_bwd_plain(q_, k_, v_, jo, jlse, (do_.float() * s).half())
        for name, g, jg in zip(("dq", "dk", "dv"), got, jgrads):
            assert torch.equal(~torch.isfinite(g), ~torch.isfinite(jg)), (name, s, stats)
            if not over:
                assert torch.isfinite(g).all()
                assert PF.bwd_mismatch(g, jg)["passed"], (name, s)
        assert bool((~torch.isfinite(got[0])).any()) == over, stats


# ---------------------------------------------------------------------------
# fp16 engine trajectory
# ---------------------------------------------------------------------------

FP16_MODEL = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=64, max_seq=32,
                  variant="llama")
FP16_CONFIG = {
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
# dynamic scaling from 2^8 (far below this model's overflow), doubling
# after two clean steps; at PLANTED the scale is set to 2^40 in both
# engines for one step (an overflow far past the edge), then restored
DYNAMIC = {"enabled": True, "initial_scale_power": 8, "loss_scale_window": 2, "hysteresis": 2}
STATIC_OVERFLOW = {"enabled": True, "loss_scale": 2.0 ** 40}
N_STEPS, PLANTED, PLANT = 6, 3, 2.0 ** 40


def _overflows(pc, params16, batches, scale):
    """Whether the f16 model's scaled gradients (the engine's backward at
    `scale`, every micro-batch) hold an inf or a NaN."""
    loss_fn = PT.make_loss_fn(pc)
    norm2 = 0.0
    for micro in batches:
        live = tree_map(lambda p: p.detach().requires_grad_(), params16)
        loss = loss_fn(live, micro, None)
        grads = torch.autograd.grad(loss * scale, leaves(live))
        norm2 += sum(float(g.float().square().sum()) for g in grads)
    return not np.isfinite(norm2)


def _run(fp16, plant):
    jc, pc = JT.TransformerConfig(**FP16_MODEL), PT.TransformerConfig(**FP16_MODEL)
    tree = numpy_params(jc, seed=9, std=0.05)
    r = np.random.default_rng(4)
    batches = [{"tokens": r.integers(0, 128, (16, 33)).astype(np.int32)}
               for _ in range(N_STEPS)]
    config = dict(FP16_CONFIG, fp16=fp16)
    jeng = jds.initialize(dict(config, mesh={"data": -1}), loss_fn=JT.make_loss_fn(jc),
                          params=to_jax(tree), param_logical_specs=JT.logical_specs(jc))
    peng = pds.initialize(dict(config), loss_fn=PT.make_loss_fn(pc),
                          params=params_from_numpy(tree, pc, device="cpu"),
                          param_logical_specs=PT.logical_specs(pc), device="cpu")
    jm, pm, margins, snaps = [], [], [], []
    for i, b in enumerate(batches):
        keep = None
        if plant and i == PLANTED:
            # the JAX step donates its state: keep copies placed as the originals
            copy = lambda x: jax.device_put(np.asarray(x), x.sharding)
            keep = (jax.tree.map(copy, jeng.state.loss_scale), peng.state.loss_scale)
            jls = jeng.state.loss_scale
            jeng.state = dataclasses.replace(jeng.state, loss_scale=jls._replace(
                scale=jax.device_put(np.float32(PLANT), jls.scale.sharding)))
            peng.state.loss_scale = keep[1]._replace(scale=torch.tensor(PLANT))
        scale = float(peng.state.loss_scale.scale)
        micro = [{"tokens": torch.from_numpy(b["tokens"][8 * j:8 * j + 8])} for j in range(2)]
        snaps.append([t.clone() for t in leaves(peng.state.master) + leaves(peng.state.opt)
                      + [peng.state.step]])
        margins.append((_overflows(pc, peng.state.params, micro, scale / 4),
                        _overflows(pc, peng.state.params, micro, scale * 4)))
        jm.append(jeng.train_batch(b))
        pm.append(peng.train_batch(b))
        if keep is not None:
            jeng.state = dataclasses.replace(jeng.state, loss_scale=keep[0])
            peng.state.loss_scale = keep[1]
    snaps.append([t.clone() for t in leaves(peng.state.master) + leaves(peng.state.opt)
                  + [peng.state.step]])
    jmaster = jax.tree.map(np.asarray, jeng.state.master)
    return jm, pm, margins, snaps, jmaster, params_to_numpy(peng.state.master), peng


@pytest.fixture(scope="module")
def dynamic():
    return _run(DYNAMIC, plant=True)


@pytest.fixture(scope="module")
def static_overflow():
    return _run(STATIC_OVERFLOW, plant=False)


class TestFp16Trajectory:
    def test_skips_scale_and_lr_identical(self, dynamic):
        jm, pm = dynamic[:2]
        for key in ("skipped", "loss_scale", "lr"):
            assert [m[key] for m in pm] == [m[key] for m in jm], key
        assert [m["skipped"] for m in pm] == [float(i == PLANTED) for i in range(N_STEPS)]
        assert len({m["loss_scale"] for m in pm}) > 1  # the scale grew

    def test_every_overflow_decision_has_a_margin(self, dynamic):
        """A step that overflowed also overflows at a quarter of its scale,
        and a clean one stays clean at four times it: |grad| x scale is at
        least 4x from f16's edge, so XLA's and torch's roundings cannot
        decide it differently."""
        pm, margins = dynamic[1], dynamic[2]
        for m, (at_quarter, at_four) in zip(pm, margins):
            assert (at_quarter, at_four) == ((True, True) if m["skipped"] else (False, False))

    @pytest.mark.parametrize("metric", ["loss", "grad_norm"])
    def test_metric_matches(self, dynamic, metric):
        jm, pm = dynamic[:2]
        live = [i for i, m in enumerate(pm) if not m["skipped"]]
        np.testing.assert_allclose([pm[i][metric] for i in live], [jm[i][metric] for i in live],
                                   rtol=2e-4)
        assert not np.isfinite(pm[PLANTED]["grad_norm"])
        assert not np.isfinite(jm[PLANTED]["grad_norm"])

    def test_final_master_matches(self, dynamic):
        """The f32 trajectory test's 1e-5 holds here for the error's RMS
        over each leaf, not for every element: the two packages round the
        f16 backward's sums in other orders (gradients a few f16 ulps
        apart, 2^-11 relative where f32 differs by 2^-24), and Adam, which
        divides each gradient by its own running RMS, turns that into up
        to ~0.4 of one step on ~1% of the weights (measured: RMS 2e-6 to
        5e-6 beside each leaf's movement of 1.3e-3, the largest element
        4e-4). So each leaf is held to an error RMS of 1e-5 and every
        element to half of one step at the peak lr, 5e-4."""
        jmaster, pmaster = dynamic[4:6]
        for name, got in flatten(pmaster).items():
            err = got - flatten(jmaster)[name]
            assert np.sqrt(np.mean(err ** 2)) <= 1e-5, name
            assert np.abs(err).max() <= 5e-4, name

    def test_skipped_step_leaves_state_bit_unchanged(self, dynamic):
        snaps, peng = dynamic[3], dynamic[6]
        before, after = snaps[PLANTED], snaps[PLANTED + 1]
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert int(peng.state.step) == N_STEPS - 1 and peng.global_steps == N_STEPS

    def test_static_overflowing_scale_skips_every_step(self, static_overflow):
        jm, pm, _, snaps = static_overflow[:4]
        assert [m["skipped"] for m in pm] == [m["skipped"] for m in jm] == [1.0] * N_STEPS
        assert [m["loss_scale"] for m in pm] == [m["loss_scale"] for m in jm] == [PLANT] * N_STEPS
        assert [m["lr"] for m in pm] == [m["lr"] for m in jm] == [pm[0]["lr"]] * N_STEPS
        assert all(torch.equal(a, b) for a, b in zip(snaps[0], snaps[-1]))
        peng = static_overflow[6]
        assert int(peng.state.step) == 0 and peng.get_lr() == pm[0]["lr"]

    def test_fp16_engine_state_and_dtypes(self):
        pc = PT.TransformerConfig(**FP16_MODEL)
        peng = pds.initialize(dict(FP16_CONFIG, fp16=DYNAMIC), loss_fn=PT.make_loss_fn(pc),
                              param_init_fn=lambda g: PT.init(pc, g, device="cpu"),
                              device="cpu")
        assert peng.state.params["embed"].dtype == torch.float16
        assert peng.state.master["embed"].dtype == torch.float32
        ls = peng.state.loss_scale
        assert (ls.scale.dtype, ls.good_steps.dtype, ls.hysteresis_left.dtype,
                peng.state.step.dtype) == (torch.float32, torch.int32, torch.int32, torch.int32)
        metrics = peng.train_batch_async({"tokens": np.zeros((16, 33), np.int32)})
        assert sorted(metrics) == ["grad_norm", "loss", "loss_scale", "lr", "skipped"]
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in metrics.values())
