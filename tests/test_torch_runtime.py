"""Port runtime pieces of the training slice held against the JAX package:
config parsing (the tests/test_config.py cases this slice covers), LR
schedules (the tests/test_lr_schedules.py cases, and every schedule's
float32 values beside the JAX package's), Adam/AdamW updates (1e-6 over
several steps, f32), the precision helpers, and every knob the slice
leaves out raising NotImplementedError."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as pds
from deepspeed_tpu.ops import optimizers as JO
from deepspeed_tpu.runtime import lr_schedules as JL
from deepspeed_tpu.runtime import precision as JP
from deepspeed_tpu_torch.config import parse_config
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.ops import optimizers as PO
from deepspeed_tpu_torch.runtime import lr_schedules as PL
from deepspeed_tpu_torch.runtime import precision as PP
from deepspeed_tpu_torch.utils.convert import params_to_numpy


# ---------------------------------------------------------------------------
# config (cases of tests/test_config.py)
# ---------------------------------------------------------------------------

class TestConfig:
    def test_defaults(self):
        cfg = parse_config({})
        assert cfg.zero_stage == 0
        assert not cfg.bf16.enabled
        assert cfg.gradient_clipping == 0.0
        assert cfg.compute_dtype == torch.float32

    @pytest.mark.parametrize("given, want", [
        ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2}, (32, 2, 2)),
        ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 2}, (32, 2, 2)),
        ({"train_batch_size": 32, "gradient_accumulation_steps": 2}, (32, 2, 2)),
        ({"train_micro_batch_size_per_gpu": 4}, (32, 4, 1)),
    ])
    def test_batch_triangle(self, given, want):
        cfg = parse_config(given)
        cfg.resolve_batch_sizes(dp_world_size=8)
        assert (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
                cfg.gradient_accumulation_steps) == want

    @pytest.mark.parametrize("given", [
        {"train_batch_size": 30, "train_micro_batch_size_per_gpu": 2,
         "gradient_accumulation_steps": 2},
        {},
    ])
    def test_batch_triangle_rejects(self, given):
        with pytest.raises(ValueError):
            parse_config(given).resolve_batch_sizes(dp_world_size=8)

    def test_precision_exclusive(self):
        with pytest.raises(ValueError):
            parse_config({"bf16": {"enabled": True}, "fp16": {"enabled": True}})

    def test_json_file_roundtrip(self, tmp_path):
        p = tmp_path / "ds_config.json"
        p.write_text(json.dumps({
            "train_micro_batch_size_per_gpu": 1,
            "zero_optimization": {"stage": 3, "param_persistence_threshold": 100},
            "bf16": {"enabled": True},
            "optimizer": {"type": "AdamW", "params": {"lr": 2e-4, "betas": [0.9, 0.95]}},
        }))
        cfg = parse_config(str(p))
        assert cfg.zero_optimization.stage == 3
        assert cfg.zero_optimization.param_persistence_threshold == 100
        assert cfg.optimizer.type == "AdamW"
        assert cfg.compute_dtype == torch.bfloat16

    @pytest.mark.parametrize("bad", [
        {"train_micro_batch_sized_per_gpu": 1},
        {"zero_optimization": {"stag": 1}},
        {"bf16": {"enabled": "yes"}},
    ])
    def test_unknown_key_or_wrong_type_rejected(self, bad):
        with pytest.raises(TypeError):
            parse_config(bad)

    def test_stock_reference_config_parses(self):
        cfg = parse_config({
            "train_batch_size": 8,
            "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10}},
            "gradient_clipping": 1.0,
            "fp16": {"enabled": True, "auto_cast": False, "hysteresis": 2},
            "zero_optimization": {
                "stage": 3, "allgather_partitions": True, "allgather_bucket_size": 2e8,
                "overlap_comm": True, "reduce_scatter": True, "reduce_bucket_size": 2e8,
                "contiguous_gradients": True, "stage3_prefetch_bucket_size": 5e7,
                "stage3_param_persistence_threshold": 1e5, "stage3_max_live_parameters": 1e9,
                "stage3_max_reuse_distance": 1e9,
                "stage3_gather_16bit_weights_on_model_save": True, "sub_group_size": 1e9,
                "round_robin_gradients": True,
            },
            "gradient_predivide_factor": 1.0,
            "wall_clock_breakdown": False,
        })
        assert cfg.zero_optimization.stage == 3
        assert cfg.zero_optimization.param_persistence_threshold == 1e5

    @pytest.mark.parametrize("extra", [
        {"checkpoint": {"use_node_local_storage": True}},
        {"zero_optimization": {"stage": 3, "zero_quantized_nontrainable_weights": True}},
        {"prescale_gradients": True},
        {"sparse_attention": {"mode": "fixed"}},
        {"data_efficiency": {"enabled": True, "data_routing": {"enabled": True}}},
        {"gradient_predivide_factor": 2.0},
        {"curriculum_learning": {"enabled": True}},
        {"progressive_layer_drop": {"enabled": True}},
        {"compression_training": {"weight_quantization": {}}},
        {"elasticity": {"enabled": True}},
        {"communication_data_type": "fp16"},
    ])
    def test_unimplemented_knobs_raise(self, extra):
        with pytest.raises(NotImplementedError):
            parse_config({"train_micro_batch_size_per_gpu": 1, **extra})

    def test_disabled_blocks_and_noop_keys_parse(self):
        cfg = parse_config({"train_micro_batch_size_per_gpu": 1,
                            "autotuning": {"enabled": False},
                            "data_efficiency": {"enabled": False},
                            "zero_allow_untested_optimizer": True,
                            "communication_data_type": None})
        assert cfg.train_micro_batch_size_per_gpu == 1

    def test_activation_checkpointing_policy_validated(self):
        with pytest.raises(ValueError):
            parse_config({"activation_checkpointing": {"policy": "bogus"}})
        cfg = parse_config({"activation_checkpointing": {"policy": "dots"}})
        assert cfg.activation_checkpointing.policy == "dots"

    def test_mesh_config(self):
        cfg = parse_config({"mesh": {"data": 2, "model": 4}})
        sizes = cfg.mesh.axis_sizes()
        assert sizes["model"] == 4 and sizes["data"] == 2 and sizes["pipe"] == 1


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

def f(sched, step):
    return sched(step)


class TestLrSchedules:
    """The cases of tests/test_lr_schedules.py, on the port."""

    def test_warmup_reaches_max(self):
        s = PL.warmup_lr(warmup_min_lr=0.0, warmup_max_lr=1e-2, warmup_num_steps=100)
        assert f(s, 0) == pytest.approx(0.0, abs=1e-8)
        assert f(s, 100) == pytest.approx(1e-2, rel=1e-5)
        assert f(s, 1000) == pytest.approx(1e-2, rel=1e-5)

    def test_warmup_linear_monotone(self):
        s = PL.warmup_lr(warmup_max_lr=1e-2, warmup_num_steps=50, warmup_type="linear")
        vals = [f(s, i) for i in range(0, 60, 10)]
        assert all(b >= a for a, b in zip(vals, vals[1:]))

    def test_warmup_decay_hits_zero_and_respects_min_lr(self):
        s = PL.warmup_decay_lr(total_num_steps=200, warmup_max_lr=1e-2, warmup_num_steps=20)
        assert f(s, 200) == pytest.approx(0.0, abs=1e-6)
        assert f(s, 20) == pytest.approx(1e-2, rel=1e-4)
        s = PL.warmup_decay_lr(total_num_steps=100, warmup_min_lr=1e-4, warmup_max_lr=1e-2,
                               warmup_num_steps=10)
        assert f(s, 100) == pytest.approx(1e-4, rel=1e-4)
        assert f(s, 55) == pytest.approx(1e-4 + (1e-2 - 1e-4) * 0.5, rel=1e-4)

    def test_warmup_cosine_endpoints(self):
        s = PL.warmup_cosine_lr(total_num_steps=100, warmup_num_steps=10, lr=1e-2,
                                cos_min_ratio=0.1)
        assert f(s, 10) == pytest.approx(1e-2, rel=1e-3)
        assert f(s, 100) == pytest.approx(1e-3, rel=1e-2)

    def test_one_cycle_shape(self):
        s = PL.one_cycle(cycle_min_lr=1e-4, cycle_max_lr=1e-2, cycle_first_step_size=10)
        assert f(s, 0) == pytest.approx(1e-4, rel=1e-4)
        assert f(s, 10) == pytest.approx(1e-2, rel=1e-4)
        assert f(s, 20) == pytest.approx(1e-4, rel=1e-2)

    def test_build_schedule(self):
        s = PL.build_schedule("WarmupLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 5})
        assert f(s, 5) == pytest.approx(1e-3, rel=1e-4)
        s = PL.build_schedule("WarmupCosineLR", {"total_num_steps": 100,
                                                 "warmup_num_steps": 10}, base_lr=6e-4)
        assert f(s, 10) == pytest.approx(6e-4, rel=1e-3)
        s = PL.build_schedule(None, base_lr=3e-4)
        assert f(s, 0) == f(s, 1000) == pytest.approx(3e-4, rel=1e-6)
        with pytest.raises(ValueError):
            PL.build_schedule("NoSuchLR", {})

    @pytest.mark.parametrize("name, params, max_ulp", [
        ("WarmupLR", {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3, "warmup_num_steps": 40,
                      "warmup_type": "linear"}, 0),
        ("WarmupDecayLR", {"total_num_steps": 100, "warmup_min_lr": 1e-4,
                           "warmup_max_lr": 1e-2, "warmup_num_steps": 10,
                           "warmup_type": "linear"}, 0),
        ("WarmupLR", {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3, "warmup_num_steps": 40},
         1),
        ("WarmupCosineLR", {"total_num_steps": 100, "warmup_num_steps": 10,
                            "cos_min_ratio": 0.1, "warmup_min_ratio": 0.05}, 4),
        ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2, "cycle_first_step_size": 10,
                      "cycle_second_step_size": 15, "decay_step_size": 5,
                      "decay_lr_rate": 0.1}, 8),
        ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 7,
                         "lr_range_test_step_rate": 0.3}, 4),
        ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 7,
                         "lr_range_test_step_rate": 0.3, "lr_range_test_staircase": True}, 4),
    ])
    def test_float32_values_match_jax(self, name, params, max_ulp):
        """Linear warmup and decay are bit-identical to the JAX package's
        compiled float32; the others stay within `max_ulp` float32 ulps
        (XLA folds constant factors and has its own log1p and cos)."""
        js = jax.jit(JL.build_schedule(name, params, base_lr=6e-4))
        ps = PL.build_schedule(name, params, base_lr=6e-4)
        steps = range(120)
        want = np.array([float(js(jnp.int32(i))) for i in steps], np.float32)
        got = np.array([ps(i) for i in steps], np.float32)
        np.testing.assert_array_max_ulp(got, want, maxulp=max_ulp)


# ---------------------------------------------------------------------------
# optimizer and precision helpers
# ---------------------------------------------------------------------------

def _tree(r, scale=1.0):
    return {"a": (r.standard_normal((6, 5)) * scale).astype(np.float32),
            "layers": {"w": (r.standard_normal((2, 4, 3)) * scale).astype(np.float32),
                       "s": (r.standard_normal((2, 4)) * scale).astype(np.float32)}}


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v.copy()))
            for k, v in tree.items()}


class TestOptimizer:
    @pytest.mark.parametrize("kind, params", [
        ("adamw", {"lr": 1e-3, "weight_decay": 0.1}),
        ("adam", {"lr": 1e-3, "weight_decay": 0.1}),
        ("AdamW", {"betas": [0.8, 0.95], "eps": 1e-6}),
        ("fused_adam", {"bias_correction": False, "weight_decay": 0.01}),
    ])
    def test_updates_match_jax(self, kind, params):
        r = np.random.default_rng(3)
        p0 = _tree(r)
        jopt = JO.build_optimizer(kind, params)
        popt = PO.build_optimizer(kind, params)
        jp = jax.tree.map(jnp.asarray, p0)
        js = jopt.init(jp)
        pp = _torch_tree(p0)
        ps = popt.init(pp)
        for step in range(1, 5):
            g = _tree(r, scale=0.1)
            lr = 1e-3 * step
            jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.float32(lr),
                                 jnp.int32(step))
            out_p, out_s = popt.update(_torch_tree(g), ps, pp, lr, step)
            assert out_p is pp and out_s is ps  # in place
        for got, want in ((pp, jp), (ps["mu"], js["mu"]), (ps["nu"], js["nu"])):
            jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                                                 atol=1e-6),
                         params_to_numpy(got), want)

    @pytest.mark.parametrize("kind", ["lamb", "lion", "sgd", "adagrad", "OneBitAdam",
                                      "ZeroOneAdam"])
    def test_later_optimizers_raise(self, kind):
        with pytest.raises(NotImplementedError, match="A4"):
            PO.build_optimizer(kind, {})

    def test_unknown_optimizer(self):
        with pytest.raises(ValueError):
            PO.build_optimizer("nosuch", {})


class TestPrecision:
    def test_norm_clip_and_cast_match_jax(self):
        r = np.random.default_rng(5)
        g = _tree(r)
        jn = JP.global_grad_norm(jax.tree.map(jnp.asarray, g))
        pg = _torch_tree(g)
        pn = PP.global_grad_norm(pg)
        np.testing.assert_allclose(pn.item(), float(jn), rtol=1e-6)
        jc = JP.clip_grads_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0, jn)
        PP.clip_grads_by_global_norm(pg, 1.0, pn)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6),
                     params_to_numpy(pg), jc)
        before = params_to_numpy(pg)
        PP.clip_grads_by_global_norm(pg, 0.0, pn)  # max_norm <= 0: untouched
        jax.tree.map(np.testing.assert_array_equal, params_to_numpy(pg), before)
        cast = PP.cast_params({"x": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)},
                              torch.bfloat16)
        assert cast["x"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32

    def test_found_inf(self):
        g = _torch_tree(_tree(np.random.default_rng(6)))
        assert not bool(PP.found_inf_in_grads(g))
        assert not bool(PP.found_inf_in_grads({}))
        g["layers"]["w"][0, 0, 0] = float("nan")
        assert bool(PP.found_inf_in_grads(g))
        assert bool(JP.found_inf_in_grads({"w": jnp.asarray(g["layers"]["w"].numpy())}))


# ---------------------------------------------------------------------------
# what the slice leaves out raises
# ---------------------------------------------------------------------------

MODEL = dict(vocab_size=64, n_layers=1, n_heads=2, d_model=32, max_seq=16, variant="llama")


def _init(config, **kw):
    pc = PT.TransformerConfig(**MODEL)
    return pds.initialize({"train_micro_batch_size_per_gpu": 1, **config},
                          loss_fn=PT.make_loss_fn(pc),
                          param_init_fn=lambda g: PT.init(pc, g, device="cpu"),
                          device="cpu", **kw)


class TestLeftOutRaises:
    @pytest.mark.parametrize("config, kw", [
        ({"zero_optimization": {"stage": 2}}, {}),
        ({"zero_optimization": {"stage": 3}}, {}),
        ({"zero_optimization": {"stage": 1, "zero_hpz_partition_size": 2}}, {}),
        ({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}}, {}),
        ({"zero_optimization": {"stage": 1, "zero_quantized_gradients": True}}, {}),
        ({"fp16": {"enabled": True}}, {}),
        ({"bf16": {"enabled": True, "master_weights": False}}, {}),
        ({"mesh": {"data": 2}}, {}),
        ({"activation_checkpointing": {"policy": "dots"}}, {}),
        ({}, {"pipelined": True}),
        ({"optimizer": {"type": "lamb"}}, {}),
    ])
    def test_engine_raises(self, config, kw):
        with pytest.raises(NotImplementedError):
            _init(config, **kw)

    @pytest.mark.parametrize("over", [
        {"remat": "dots"}, {"remat": "save_attn"}, {"remat": "save_attn_mlp"},
        {"remat": "save_attn_dots"}, {"dropout": 0.1}, {"n_experts": 2},
        {"random_ltd_layer_range": (0, 1)}, {"sliding_window": 8}, {"alibi": True},
        {"variant": "gpt2"}, {"use_flash": False},
    ])
    def test_model_raises(self, over):
        with pytest.raises(NotImplementedError):
            PT.make_loss_fn(PT.TransformerConfig(**{**MODEL, **over}))

    def test_stages_zero_and_one_train_the_same(self):
        batch = {"tokens": np.random.default_rng(1).integers(0, 64, (1, 9)).astype(np.int32)}
        runs = []
        for stage in (0, 1):
            eng = _init({"zero_optimization": {"stage": stage}, "seed": 3})
            runs.append([eng.train_batch(batch)["loss"] for _ in range(3)])
        assert runs[0] == runs[1]

    def test_full_activation_checkpointing_gives_the_same_loss(self):
        batch = {"tokens": np.random.default_rng(1).integers(0, 64, (1, 9)).astype(np.int32)}
        runs = []
        for policy in ("none", "full"):
            eng = _init({"activation_checkpointing": {"policy": policy}, "seed": 3})
            runs.append([eng.train_batch(batch)["loss"] for _ in range(3)])
        np.testing.assert_allclose(runs[0], runs[1], rtol=1e-6)

    def test_gpu_is_the_default_device(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks the CPU-only refusal")
        pc = PT.TransformerConfig(**MODEL)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pds.initialize({"train_micro_batch_size_per_gpu": 1}, loss_fn=PT.make_loss_fn(pc),
                           param_init_fn=lambda g: PT.init(pc, g, device="cpu"))
