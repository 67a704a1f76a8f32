"""Config blocks of the port.

Counterpart of deepspeed_tpu/config/config.py. The JAX package builds its
configs on pydantic models with `extra="forbid"`; the port is plain
dataclasses (the GPU machine has no pydantic) with the same contract:
unknown keys raise `TypeError` (the dataclass constructor does that) and
a value of the wrong type raises `TypeError` in `check_field_types`.

`parse_config` takes the reference JSON schema. The training slice ports
the blocks one GPU trains with: the batch triangle, `optimizer`,
`scheduler`, `zero_optimization`, `bf16`, `fp16`,
`activation_checkpointing` and `mesh` (read only to refuse more than one
device). Every other block of the schema raises `NotImplementedError`
naming its later slice when it is present and enabled; a disabled one
parses. Reference keys with no meaning here are dropped with a warning,
as the JAX package drops them.
"""

import dataclasses
import json
import typing
from typing import Any, Dict, Optional, Union


def check_field_types(obj) -> None:
    """Raise TypeError for a field whose value is not of its declared type
    (bool is not accepted for int, nor int for bool; an int is accepted for
    float). Supports the plain field types the port's configs use."""
    hints = typing.get_type_hints(type(obj))
    for f in dataclasses.fields(obj):
        want = hints[f.name]
        val = getattr(obj, f.name)
        if want is bool:
            ok = isinstance(val, bool)
        elif want is int:
            ok = isinstance(val, int) and not isinstance(val, bool)
        elif want is float:
            ok = isinstance(val, (int, float)) and not isinstance(val, bool)
        elif want is str:
            ok = isinstance(val, str)
        else:
            continue
        if not ok:
            raise TypeError(
                f"{type(obj).__name__}.{f.name} must be {want.__name__}, "
                f"got {val!r}")


@dataclasses.dataclass
class PrefixCacheConfig:
    """Automatic prefix caching for the ragged inference engine
    (inference/ragged.py): content-addressed reuse of full KV blocks
    across sequences sharing a prompt prefix, vLLM-PagedAttention style.

    pool_blocks caps the LRU pool of retired-but-cached blocks
    (refcount 0, contents kept for future hits): -1 keeps every retired
    cached block until allocation pressure evicts it; 0 disables
    parking (blocks shared only while a live sequence holds them)."""

    enabled: bool = True
    pool_blocks: int = -1

    def __post_init__(self):
        check_field_types(self)


@dataclasses.dataclass
class PressureConfig:
    """Memory-pressure governor of the serving scheduler
    (inference/pressure.py PressureGovernor). Off by default: preemption
    then stays flush-and-recompute.

    Watermarks are LIVE block-pool occupancy fractions (parked prefix-cache
    blocks are evictable headroom, not pressure), scaled down when the
    warmup footprint crowds the device memory budget past
    `static_headroom` (PressureGovernor.watermark_scale):

      occupancy >= yellow    evict up to yellow_trim_blocks LRU-parked
                             prefix-cache blocks per iteration
      occupancy >= red       preemption victims spill their paged KV to
                             the bounded pinned-host tier (spill_host_mb;
                             resume = import_kv, recompute on any failure)
      occupancy >= brownout  speculative mode degrades to plain decode,
                             the prefill chunk shrinks by
                             brownout_chunk_div, admission caps at
                             brownout_admit requests per iteration

    hysteresis: the margin occupancy must clear a level's entry watermark
    by before the governor relaxes one level (per update)."""

    enabled: bool = False
    yellow: float = 0.65
    red: float = 0.85
    brownout: float = 0.95
    hysteresis: float = 0.05
    static_headroom: float = 0.8
    yellow_trim_blocks: int = 4
    spill_enabled: bool = True
    spill_host_mb: float = 256.0
    brownout_chunk_div: int = 4
    brownout_admit: int = 1

    def __post_init__(self):
        check_field_types(self)
        if not (0.0 < self.yellow <= self.red <= self.brownout <= 1.0):
            raise ValueError("pressure watermarks need 0 < yellow <= red <= brownout <= 1")
        if self.hysteresis < 0 or self.hysteresis >= self.yellow:
            raise ValueError("pressure.hysteresis must be in [0, yellow)")
        if self.static_headroom <= 0 or self.static_headroom > 1:
            raise ValueError("pressure.static_headroom must be in (0, 1]")
        if self.yellow_trim_blocks < 0 or self.spill_host_mb < 0:
            raise ValueError("yellow_trim_blocks and spill_host_mb must be >= 0")
        if self.brownout_chunk_div < 1 or self.brownout_admit < 0:
            raise ValueError("brownout_chunk_div must be >= 1, brownout_admit >= 0")


@dataclasses.dataclass
class ServingSchedulerConfig:
    """Continuous-batching serving scheduler (inference/scheduler.py
    ServingScheduler), the request-level control plane over the paged KV
    pool.

    max_num_batched_tokens: per-iteration token budget (Sarathi-Serve's
    chunked-prefill knob): decode rows spend 1 token each, prefill chunks
    fill the remainder. prefill_chunk: max prompt tokens one sequence feeds
    per iteration. decode_chunk: steady-state fused decode depth (one
    decode_multi program of decode_chunk tokens when every active sequence
    decodes). admission: 'fcfs' stops at the first waiting request that
    does not fit the KV pool; 'skip' scans past it. prefill_mode:
    'chunked' feeds prompts through the decode path in prefill_chunk
    pieces beside the decode rows; 'wave' prefills whole prompts through
    the batched prefill (the generate() path). warmup: run
    engine.warmup() at construction (on the GPU: capture the decode
    programs as CUDA graphs). hbm_budget_gb: device memory budget the
    warmup footprints are checked against (0 = the device's own).
    max_preemptions: starvation bound (a request preempted this many times
    is never chosen as a victim again; 0 = off). slo_classes: named TTFT
    deadlines in modeled seconds (inference/pressure.py cost model).
    pressure: the memory-pressure governor block (PressureConfig)."""

    max_num_batched_tokens: int = 256
    prefill_chunk: int = 32
    decode_chunk: int = 1
    admission: str = "fcfs"
    prefill_mode: str = "chunked"
    warmup: bool = True
    hbm_budget_gb: float = 0.0
    max_preemptions: int = 8
    slo_classes: Dict[str, float] = dataclasses.field(default_factory=dict)
    pressure: PressureConfig = dataclasses.field(default_factory=PressureConfig)

    def __post_init__(self):
        if isinstance(self.pressure, dict):
            self.pressure = PressureConfig(**self.pressure)
        if not isinstance(self.pressure, PressureConfig):
            raise TypeError("pressure must be a PressureConfig or a dict")
        if not isinstance(self.slo_classes, dict) or not all(
                isinstance(k, str) and isinstance(v, (int, float)) and not isinstance(v, bool)
                for k, v in self.slo_classes.items()):
            raise TypeError("slo_classes must map class names to deadlines in seconds")
        check_field_types(self)
        if self.max_preemptions < 0:
            raise ValueError("max_preemptions must be >= 0 (0 = off)")
        for name, dl in self.slo_classes.items():
            if dl <= 0:
                raise ValueError(f"slo_classes[{name!r}] deadline must be > 0 s")
        if self.admission not in ("fcfs", "skip"):
            raise ValueError(f"unknown admission policy '{self.admission}' "
                             "(expected fcfs|skip)")
        if self.prefill_mode not in ("chunked", "wave"):
            raise ValueError(f"unknown prefill_mode '{self.prefill_mode}' "
                             "(expected chunked|wave)")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.decode_chunk < 1:
            raise ValueError("decode_chunk must be >= 1")
        if self.max_num_batched_tokens < 1:
            raise ValueError("max_num_batched_tokens must be >= 1")
        if self.hbm_budget_gb < 0:
            raise ValueError("hbm_budget_gb must be >= 0 (0 = auto)")


# ---------------------------------------------------------------------------
# training config (the reference's DeepSpeedTPUConfig)
# ---------------------------------------------------------------------------

class _Block:
    """Base of the training config blocks: an integral float given for an
    int field becomes an int (JSON writes 1e5 for 100000; pydantic's lax
    mode accepts it too), nested dict blocks become their dataclasses, then
    every field's type is checked."""

    _nested: Dict[str, type] = {}

    def __post_init__(self):
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if hints[f.name] is int and isinstance(val, float) and val.is_integer():
                setattr(self, f.name, int(val))
            block = self._nested.get(f.name)
            if block is not None and isinstance(val, dict):
                setattr(self, f.name, block(**val))
        check_field_types(self)


@dataclasses.dataclass
class OffloadConfig(_Block):
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    pin_memory: bool = False


@dataclasses.dataclass
class ZeroConfig(_Block):
    """Fields and defaults of the reference's ZeroConfig. One GPU has no
    data-parallel peers, so stages 0 and 1 are the same math and the
    overlap knobs (overlap_comm, prefetch_depth, bucket_mb) have nothing to
    overlap; the engine refuses stage >= 2, offload, hpZ and the ZeRO++
    quantized collectives."""

    stage: int = 0
    param_persistence_threshold: int = 10_000
    zero_hpz_partition_size: int = 0
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    zero_quantized_nontrainable_weights: bool = False
    offload_optimizer: OffloadConfig = dataclasses.field(default_factory=OffloadConfig)
    offload_param: OffloadConfig = dataclasses.field(default_factory=OffloadConfig)
    overlap_comm: bool = True
    prefetch_depth: int = 1
    bucket_mb: float = 32.0
    contiguous_gradients: bool = True

    _nested = {"offload_optimizer": OffloadConfig, "offload_param": OffloadConfig}


@dataclasses.dataclass
class BF16Config(_Block):
    enabled: bool = False
    master_weights: bool = True


@dataclasses.dataclass
class FP16Config(_Block):
    enabled: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0


@dataclasses.dataclass
class OptimizerConfig(_Block):
    type: str = "adamw"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig(_Block):
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MeshConfig(_Block):
    """Axis sizes of the reference's device mesh (-1 on one axis: all
    remaining devices). The training slice runs on one GPU, so the engine
    accepts only a mesh whose axes all come to 1."""

    pipe: int = 1
    data: int = -1
    zero: int = 1
    expert: int = 1
    seq: int = 1
    model: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {"pipe": self.pipe, "data": self.data, "zero": self.zero,
                "expert": self.expert, "seq": self.seq, "model": self.model}


@dataclasses.dataclass
class ActivationCheckpointingConfig(_Block):
    """Engine-level remat of each micro-step's loss. 'none' and 'full'
    (torch.utils.checkpoint around the whole loss) run here; the
    dot-saving policies raise in the engine. partition_activations is an
    accepted no-op on one GPU (there is no model axis to partition over),
    as it is by design in the reference."""

    partition_activations: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    policy: str = "none"

    def __post_init__(self):
        super().__post_init__()
        if self.policy not in ("none", "full", "dots", "dots_no_batch"):
            raise ValueError(
                f"unknown activation_checkpointing.policy '{self.policy}' "
                "(expected none|full|dots|dots_no_batch)")


@dataclasses.dataclass
class DeepSpeedTPUConfig(_Block):
    """The config tree (the reference's DeepSpeedTPUConfig) as far as the
    training slice reads it."""

    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None

    steps_per_print: int = 10
    wall_clock_breakdown: bool = False
    gradient_clipping: float = 0.0
    prescale_gradients: bool = False
    seed: int = 1234

    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    zero_optimization: ZeroConfig = dataclasses.field(default_factory=ZeroConfig)
    bf16: BF16Config = dataclasses.field(default_factory=BF16Config)
    fp16: FP16Config = dataclasses.field(default_factory=FP16Config)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    activation_checkpointing: ActivationCheckpointingConfig = dataclasses.field(
        default_factory=ActivationCheckpointingConfig)

    _nested = {"optimizer": OptimizerConfig, "scheduler": SchedulerConfig,
               "zero_optimization": ZeroConfig, "bf16": BF16Config,
               "fp16": FP16Config, "mesh": MeshConfig,
               "activation_checkpointing": ActivationCheckpointingConfig}

    def __post_init__(self):
        super().__post_init__()
        for name in ("train_batch_size", "train_micro_batch_size_per_gpu",
                     "gradient_accumulation_steps"):
            val = getattr(self, name)
            if isinstance(val, float) and val.is_integer():
                setattr(self, name, int(val))
            elif val is not None and (not isinstance(val, int) or isinstance(val, bool)):
                raise TypeError(f"DeepSpeedTPUConfig.{name} must be int, got {val!r}")
        if self.bf16.enabled and self.fp16.enabled:
            raise ValueError("bf16 and fp16 cannot both be enabled")
        z = self.zero_optimization
        unimpl = []
        if z.zero_quantized_nontrainable_weights:
            unimpl.append("zero_optimization.zero_quantized_nontrainable_weights")
        if z.offload_param.device != "none" and z.stage != 3:
            raise ValueError("zero_optimization.offload_param requires zero stage 3")
        ac = self.activation_checkpointing
        if ac.cpu_checkpointing and ac.policy != "dots_no_batch":
            raise ValueError("activation_checkpointing.cpu_checkpointing requires "
                             "policy='dots_no_batch'")
        if self.prescale_gradients:
            unimpl.append("prescale_gradients")
        if unimpl:
            raise NotImplementedError(
                "config enables features not implemented in deepspeed_tpu: "
                + "; ".join(unimpl))

    def resolve_batch_sizes(self, dp_world_size: int) -> None:
        """Solve train = micro x GAS x dp_world, filling in missing values
        (the reference's resolution order: given two of (train, micro,
        GAS) derive the third; given one, assume the others)."""
        train, micro, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                             self.gradient_accumulation_steps)
        if train is not None and micro is not None and gas is None:
            if train % (micro * dp_world_size) != 0:
                raise ValueError(f"train_batch_size {train} not divisible by micro*dp = "
                                 f"{micro}*{dp_world_size}")
            gas = train // (micro * dp_world_size)
        elif train is not None and gas is not None and micro is None:
            if train % (gas * dp_world_size) != 0:
                raise ValueError(f"train_batch_size {train} not divisible by gas*dp = "
                                 f"{gas}*{dp_world_size}")
            micro = train // (gas * dp_world_size)
        elif micro is not None:
            gas = gas or 1
            train = train or micro * gas * dp_world_size
        elif train is not None:
            gas = gas or 1
            if train % (gas * dp_world_size) != 0:
                raise ValueError(f"train_batch_size {train} not divisible by gas*dp = "
                                 f"{gas}*{dp_world_size}")
            micro = train // (gas * dp_world_size)
        else:
            raise ValueError("config must set at least one of train_batch_size / "
                             "train_micro_batch_size_per_gpu")
        if train != micro * gas * dp_world_size:
            raise ValueError(f"batch triangle inconsistent: train={train} != micro={micro} "
                             f"x gas={gas} x dp={dp_world_size}")
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas

    @property
    def zero_stage(self) -> int:
        return self.zero_optimization.stage

    @property
    def compute_dtype(self):
        import torch

        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32


# Reference-era keys with no meaning here, dropped with a warning so stock
# reference configs parse (the same list as the JAX package's).
_REFERENCE_NOOP_KEYS: Dict[str, tuple] = {
    "": ("zero_allow_untested_optimizer", "sparse_gradients", "amp", "dump_state",
         "memory_breakdown", "gradient_predivide_factor", "dataloader_drop_last",
         "use_data_before_expert_parallel_"),
    "zero_optimization": (
        "allgather_partitions", "allgather_bucket_size", "reduce_scatter",
        "reduce_bucket_size", "stage3_prefetch_bucket_size",
        "stage3_max_live_parameters", "stage3_max_reuse_distance",
        "stage3_gather_16bit_weights_on_model_save", "sub_group_size",
        "round_robin_gradients", "ignore_unused_parameters", "legacy_stage1",
        "stage3_gather_fp16_weights_on_model_save", "elastic_checkpoint"),
    "fp16": ("auto_cast", "fp16_master_weights_and_grads"),
    "bf16": ("immediate_grad_update",),
    "activation_checkpointing": ("contiguous_memory_optimization",
                                 "synchronize_checkpoint_boundary", "profile"),
}

_REFERENCE_RENAMES: Dict[str, Dict[str, str]] = {
    "zero_optimization": {"stage3_param_persistence_threshold": "param_persistence_threshold"},
}

# Blocks and keys of the reference schema that later slices port (ROADMAP
# section A): present and enabled, each raises naming where it comes.
_LATER_SLICES: Dict[str, str] = {
    "communication_data_type": "slice 3, multi-GPU (ROADMAP A11)",
    "data_types": "slice 3, multi-GPU (ROADMAP A11)",
    "integrity": "slice 4, fleet and resilience (ROADMAP A16)",
    "comms_logger": "slice 3, multi-GPU (ROADMAP A11)",
    "flops_profiler": "slice 5 (ROADMAP A17)",
    "monitor": "slice 5 (ROADMAP A17)",
    "checkpoint": "slice 3, checkpointing (ROADMAP A15)",
    "nebula": "slice 3, checkpointing (ROADMAP A15)",
    "data_efficiency": "slice 5 (ROADMAP A17)",
    "aio": "slice 3, offload (ROADMAP A14)",
    "elasticity": "slice 4, fleet and resilience (ROADMAP A16)",
    "autotuning": "slice 5 (ROADMAP A17)",
    "curriculum_learning": "slice 5 (ROADMAP A17)",
    "progressive_layer_drop": "slice 5 (ROADMAP A17)",
    "compression_training": "slice 5 (ROADMAP A17)",
    "hybrid_engine": "slice 5 (ROADMAP A17)",
}


def _enabled(block) -> bool:
    """A block with an `enabled` key is on when that key is true; any other
    value is on when it is truthy (stock reference configs often carry
    disabled blocks, which parse)."""
    if isinstance(block, dict) and "enabled" in block:
        return bool(block["enabled"])
    return bool(block)


def _compat_filter(config: Dict[str, Any]) -> Dict[str, Any]:
    from ..utils.logging import logger

    config = {k: (dict(v) if isinstance(v, dict) else v) for k, v in config.items()}
    if _enabled(config.pop("sparse_attention", None)):
        raise NotImplementedError(
            "the sparse_attention config block has no engine-level consumer; sparse "
            "attention is set on the model: TransformerConfig(attention_impl='sparse', "
            "sparse_mode=..., sparse_block=...)")
    later = [k for k in _LATER_SLICES if k in config and _enabled(config.pop(k))]
    if later:
        raise NotImplementedError(
            "the training slice does not implement "
            + "; ".join(f"'{k}' (comes with {_LATER_SLICES[k]})" for k in later))
    if float(config.get("gradient_predivide_factor", 1.0) or 1.0) != 1.0:
        raise NotImplementedError("gradient_predivide_factor != 1.0 is not implemented")
    for path, keys in _REFERENCE_NOOP_KEYS.items():
        block = config if path == "" else config.get(path)
        if not isinstance(block, dict):
            continue
        dropped = [k for k in keys if k in block]
        for k in dropped:
            block.pop(k)
        if dropped:
            logger.warning(f"{path or 'config'}: ignoring reference-era keys with no "
                           f"meaning here: {dropped}")
    for path, renames in _REFERENCE_RENAMES.items():
        block = config.get(path)
        if isinstance(block, dict):
            for old, new in renames.items():
                if old in block and new not in block:
                    block[new] = block.pop(old)
    return config


def parse_config(config: Union[str, Dict[str, Any], DeepSpeedTPUConfig, None]
                 ) -> DeepSpeedTPUConfig:
    """Accept a path to a JSON file, a dict, or an already-built config.
    Reference no-op keys are dropped with a warning; unknown keys raise
    TypeError, and keys or blocks of later slices raise
    NotImplementedError."""
    if config is None:
        return DeepSpeedTPUConfig()
    if isinstance(config, DeepSpeedTPUConfig):
        return config
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    if not isinstance(config, dict):
        raise TypeError(f"config must be path/dict/DeepSpeedTPUConfig, got {type(config)}")
    return DeepSpeedTPUConfig(**_compat_filter(config))
