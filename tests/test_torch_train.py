"""Port training slice held against the JAX package on the CPU, from the
same numpy-made inputs:

- the flash backward's plain version (`flash_attention_bwd_plain`, the
  recompute-from-lse math kernels #2 and #3 implement) against jax.grad
  of the JAX flash kernel run in interpret mode and of the XLA oracle, in
  f32 at 2e-3 (the pin of tests/test_flash_attention.py); in bf16 (P and
  dS rounded to bf16, as the kernels do) against jax.grad of the
  interpret-mode kernel under the tolerance the CUDA kernels are held to
  (`bwd_mismatch`), which planted faults fail;
- the flash autograd Function against autograd through the dense plain
  forward (1e-5: the same math, another summation order);
- `make_loss_fn` loss and every parameter's gradient against
  jax.value_and_grad of the JAX loss, f32 at rtol 1e-4 and atol 1e-4 of
  each leaf's largest gradient, for every remat mode the slice maps onto
  torch.utils.checkpoint and with and without chunked CE;
- a port engine against a JAX engine over 5 steps (AdamW with weight
  decay, clipping, linear WarmupLR, GAS 2): lr identical (the log warmup
  agrees within one float32 ulp, tests/test_torch_runtime.py, since XLA's
  log1p is not numpy's), loss and grad_norm at
  rtol 2e-4 (the pin tests/test_engine.py uses between layouts), final
  master parameters as stated in the test;
- a bf16 smoke run whose loss falls on a fixed batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as pds
from _torch_parity import flatten, jax_config, numpy_params, to_jax, torch_config
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import attention as JA
from deepspeed_tpu.ops.pallas import flash_attention as JF
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops import cuda as PK
from deepspeed_tpu_torch.ops.cuda import flash_attention as PF
from deepspeed_tpu_torch.utils.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.utils.tree import leaves, tree_map

FLASH_TOL = dict(rtol=2e-3, atol=2e-3)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _qkv(rng, B, S, H, KV, D):
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))


class TestFlashBackward:
    @pytest.mark.parametrize("S", [128, 100])
    @pytest.mark.parametrize("KV", [2, 1])
    def test_plain_matches_jax_kernel_and_xla_grads(self, rng, S, KV):
        B, H, D = 1, 2, 128
        q, k, v, do = _qkv(rng, B, S, H, KV, D)

        def vjp(attn):
            return jax.grad(lambda q, k, v: jnp.sum(attn(q, k, v) * do),
                            argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

        kernel = vjp(lambda q, k, v: JF.flash_attention(q, k, v, causal=True,
                                                        block_q=64, block_k=64))
        xla = vjp(lambda q, k, v: JA._xla_attention(q, JA._repeat_kv(k, H // KV),
                                                    JA._repeat_kv(v, H // KV)))
        o, lse = PF.flash_attention_plain(_t(q), _t(k), _t(v))
        got = PF.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, lse, _t(do))
        for name, g, a, b in zip(("dq", "dk", "dv"), got, kernel, xla):
            np.testing.assert_allclose(g.numpy(), np.asarray(a), err_msg=name, **FLASH_TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(b), err_msg=name, **FLASH_TOL)

    @pytest.mark.parametrize("fault", [None, "scale_1.02", "skip_last_diag_tile"])
    @pytest.mark.parametrize("S,KV", [(128, 2), (100, 1)])
    def test_kernel_rounding_matches_jax_kernel_in_bf16(self, rng, S, KV, fault):
        """On bf16 inputs the JAX kernel rounds P and dS to bf16 before its
        products, and so does the port's plain backward. From the JAX
        forward's own o and lse, the port's plain backward is held against
        jax.grad of the interpret-mode kernel under the tolerance the CUDA
        kernels are held to (`bwd_mismatch`), and sits far closer to it than
        the same math on f32 inputs, which rounds nothing. Two faults
        planted in the JAX gradients (all 2% too large; the causal block of
        the last 64 queries and keys left out) fail that tolerance."""
        B, H, D = 1, 2, 128
        q, k, v, do = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(rng, B, S, H, KV, D))
        attn = dict(causal=True, block_q=64, block_k=64)
        o, lse = JF.flash_attention_with_lse(q, k, v, **attn)
        ref = jax.grad(lambda q, k, v: jnp.sum(JF.flash_attention(q, k, v, **attn)
                                               .astype(jnp.float32) * do.astype(jnp.float32)),
                       argnums=(0, 1, 2))(q, k, v)
        q_, k_, v_, o_, do_ = (_t(a).to(torch.bfloat16) for a in (q, k, v, o, do))
        lse_ = _t(np.array(lse))
        rounded = PF.flash_attention_bwd_plain(q_, k_, v_, o_, lse_, do_)
        f32 = PF.flash_attention_bwd_plain(q_.float(), k_.float(), v_.float(), o_.float(),
                                           lse_, do_.float())
        t = S - 64
        last = lambda x: x[:, t:].contiguous()
        skipped = PF._bwd_plain(last(q_), last(k_), last(v_), lse_[:, :, t:].contiguous(),
                                PF._delta(o_, do_)[:, :, t:].contiguous(), last(do_))
        for i, name in enumerate(("dq", "dk", "dv")):
            jax_grad = _t(ref[i]).clone()
            if fault is None:
                stats = PF.bwd_mismatch(jax_grad, rounded[i])
                assert stats["n_over"] == 0, (name, stats)
                assert stats["err_rms"] < 0.1 * PF.bwd_mismatch(jax_grad, f32[i])["err_rms"]
                continue
            if fault == "scale_1.02":
                jax_grad = jax_grad * 1.02
            else:
                jax_grad[:, t:] -= skipped[i].float()
            stats = PF.bwd_mismatch(jax_grad.to(torch.bfloat16), rounded[i])
            assert stats["n_over"] > 0, (name, fault, stats)

    @pytest.mark.parametrize("KV", [4, 1])
    def test_function_matches_autograd_through_plain(self, rng, KV):
        q, k, v, do = (_t(a) for a in _qkv(rng, 2, 37, 4, KV, 64))
        PK.reset_launch_counts()
        leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(PF.flash_attention(*leaves_)[0], leaves_, do)
        leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(PF.flash_attention_plain(*leaves_)[0], leaves_, do)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        assert PK.launch_counts() == {n: 0 for n in PK.WRAPPERS}  # CPU: plain versions

    def test_cpu_wrappers_are_the_plain_backward(self, rng):
        q, k, v, do = (_t(a) for a in _qkv(rng, 1, 50, 4, 2, 128))
        o, lse = PF.flash_attention_plain(q, k, v)
        delta = PF._delta(o, do)
        ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do)
        got = (PF.flash_bwd_dq(q, k, v, do, lse, delta),) + PF.flash_bwd_dkv(q, k, v, do,
                                                                              lse, delta)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r.numpy())

    @pytest.mark.parametrize("mode", [{"window": 8, "alibi": [0.5, 0.25]},
                                      {"alibi": [0.5, 0.25]}])
    def test_window_and_alibi_raise(self, rng, mode):
        """(Named for the refusal it pinned until the flash backward took
        ALiBi.) The flash Function's gradient with ALiBi slopes, with and
        without a window, equals autograd through the dense plain forward
        (1e-5: the same math, another summation order); the slopes carry
        no gradient."""
        q, k, v, do = (_t(a) for a in _qkv(rng, 1, 16, 2, 2, 64))
        slopes = torch.tensor(mode["alibi"])
        window = mode.get("window", 0)
        leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
        o, _ = PF.flash_attention(*leaves_, **mode)
        got = torch.autograd.grad(o, leaves_, do)
        leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(PF.flash_attention_plain(*leaves_, window, slopes)[0],
                                  leaves_, do)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        # the bias bites in the gradient too
        plain = PF.flash_attention_bwd_plain(q, k, v, *PF.flash_attention_plain(q, k, v, window),
                                             do, window)
        assert np.abs(plain[0].numpy() - got[0].numpy()).max() > 1e-2

    def test_window_runs(self, rng):
        """The sliding-window mode no longer raises: flash_attention(window=8)
        is the banded plain version on the CPU, and differentiable."""
        q, k, v, do = (_t(a).requires_grad_() for a in _qkv(rng, 1, 16, 2, 2, 64))
        o, lse = PF.flash_attention(q, k, v, window=8)
        ref, ref_lse = PF.flash_attention_plain(q, k, v, 8)
        assert torch.equal(o, ref) and torch.equal(lse, ref_lse)
        o.backward(do.detach())
        assert all(torch.isfinite(x.grad).all() for x in (q, k, v))

    def test_lse_cotangent_raises(self, rng):
        q, k, v, _ = (_t(a).requires_grad_() for a in _qkv(rng, 1, 16, 2, 2, 64))
        _, lse = PF.flash_attention(q, k, v)
        with pytest.raises(NotImplementedError, match="B3"):
            lse.sum().backward()


# ---------------------------------------------------------------------------
# model loss and gradients
# ---------------------------------------------------------------------------

def _jax_loss_and_grads(jc, tree, batch, loss_chunks):
    loss_fn = JT.make_loss_fn(jc, loss_chunks=loss_chunks)
    loss, grads = jax.value_and_grad(loss_fn)(to_jax(tree), batch, None)
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(pc, tree, batch, loss_chunks):
    params = params_from_numpy(tree, pc, device="cpu")
    live = tree_map(lambda p: p.requires_grad_(), params)
    loss = PT.make_loss_fn(pc, loss_chunks=loss_chunks)(live, batch, None)
    grads = torch.autograd.grad(loss, leaves(live))
    names = list(flatten(live))
    return loss.item(), dict(zip(names, (g.numpy() for g in grads)))


def _assert_grads_close(got, ref_tree):
    ref = {k: np.asarray(v) for k, v in flatten(ref_tree).items()}
    assert sorted(got) == sorted(ref)
    for name, g in got.items():
        r = ref[name]
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(),
                                   err_msg=name)


@pytest.fixture(scope="module")
def loss_case():
    jc = jax_config(n_kv_heads=1)
    tree = numpy_params(jc, seed=5)
    r = np.random.default_rng(2)
    tokens = r.integers(0, jc.vocab_size, (2, 33)).astype(np.int32)
    mask = np.ones_like(tokens)
    mask[1, 20:] = 0
    return tree, {"tokens": tokens, "mask": mask}


class TestLossAndGrads:
    @pytest.mark.parametrize("loss_chunks", [1, 4])
    @pytest.mark.parametrize("remat", ["none", "full", "save_attn_qkv"])
    def test_matches_jax_value_and_grad(self, loss_case, remat, loss_chunks):
        tree, batch = loss_case
        jc = jax_config(n_kv_heads=1, remat=remat)
        pc = torch_config(n_kv_heads=1, remat=remat)
        jl, jg = _jax_loss_and_grads(jc, tree, batch, loss_chunks)
        pl_, pg = _port_loss_and_grads(pc, tree, batch, loss_chunks)
        np.testing.assert_allclose(pl_, jl, rtol=1e-4, atol=1e-4)
        _assert_grads_close(pg, jg)

    def test_logits_match_jax_forward(self, loss_case):
        tree, batch = loss_case
        jc, pc = jax_config(n_kv_heads=1), torch_config(n_kv_heads=1)
        toks = batch["tokens"][:, :-1]
        ref = JT.forward(to_jax(tree), jnp.asarray(toks), jc)
        got = PT.forward(params_from_numpy(tree, pc, device="cpu"), torch.from_numpy(toks), pc)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)

    def test_flops_per_token_and_logical_specs_match(self):
        for over in ({}, {"n_kv_heads": 1}):
            jc, pc = jax_config(**over), torch_config(**over)
            assert pc.flops_per_token(64) == jc.flops_per_token(64)
            assert pc.flops_per_token() == jc.flops_per_token()
            assert PT.logical_specs(pc) == JT.logical_specs(jc)


# ---------------------------------------------------------------------------
# engine trajectory
# ---------------------------------------------------------------------------

ENGINE_MODEL = dict(vocab_size=128, n_layers=2, n_heads=4, d_model=64, max_seq=32,
                    variant="llama")
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
    jparams = jax.tree.map(np.asarray, jeng.state.params)
    return jm, pm, jparams, params_to_numpy(peng.state.params), peng


class TestEngineTrajectory:
    def test_lr_identical(self, trajectories):
        jm, pm = trajectories[:2]
        assert [m["lr"] for m in pm] == [m["lr"] for m in jm]

    @pytest.mark.parametrize("metric", ["loss", "grad_norm"])
    def test_metric_matches(self, trajectories, metric):
        jm, pm = trajectories[:2]
        np.testing.assert_allclose([m[metric] for m in pm], [m[metric] for m in jm],
                                   rtol=2e-4)

    def test_final_params_match(self, trajectories):
        """Five AdamW steps move a weight by at most 5 x lr_max = 5e-3.
        Adam divides each gradient by its own running RMS, so an f32
        rounding difference in a gradient near zero moves that weight's
        step by far more than the rounding itself: the bound is a hundredth
        of one full step, 1e-5 absolute, beside rtol 1e-5 (the largest gap
        seen on these inputs was 1.2e-6, in w_gate)."""
        jparams, pparams = trajectories[2:4]
        for name, got in flatten(pparams).items():
            ref = flatten(jparams)[name]
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg=name)

    def test_counters_and_accessors(self, trajectories):
        peng = trajectories[4]
        assert peng.global_steps == peng.state.step == N_STEPS
        assert peng.get_global_grad_norm() == trajectories[1][-1]["grad_norm"]
        assert peng.get_lr() == pytest.approx(1e-3)
        assert (peng.train_micro_batch_size_per_gpu, peng.gradient_accumulation_steps) == (8, 2)


def test_bf16_loss_falls_on_a_fixed_batch():
    pc = PT.TransformerConfig(**ENGINE_MODEL, remat="save_attn_qkv")
    eng = pds.initialize({"train_micro_batch_size_per_gpu": 4, "bf16": {"enabled": True},
                          "optimizer": {"type": "adamw", "params": {"lr": 1e-3,
                                                                    "weight_decay": 0.1}},
                          "zero_optimization": {"stage": 1}, "gradient_clipping": 1.0},
                         loss_fn=PT.make_loss_fn(pc, loss_chunks=4),
                         param_init_fn=lambda g: PT.init(pc, g, device="cpu"), device="cpu")
    batch = {"tokens": np.random.default_rng(0).integers(0, 128, (4, 33)).astype(np.int32)}
    losses = [eng.train_batch(batch)["loss"] for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert eng.state.params["embed"].dtype == torch.bfloat16
    assert eng.state.master["embed"].dtype == torch.float32
    assert np.isfinite(eng.eval_batch(batch))


def test_train_batch_async_returns_tensors():
    pc = PT.TransformerConfig(**ENGINE_MODEL)
    eng = pds.initialize({"train_micro_batch_size_per_gpu": 2},
                         loss_fn=PT.make_loss_fn(pc),
                         param_init_fn=lambda g: PT.init(pc, g, device="cpu"), device="cpu")
    batch = {"tokens": np.zeros((2, 9), np.int32)}
    metrics = eng.train_batch_async(batch)
    assert sorted(metrics) == ["grad_norm", "loss", "lr", "skipped"]
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in metrics.values())
    assert eng.global_steps == 1
