"""The training engine on one GPU.

Counterpart of deepspeed_tpu/runtime/engine.py (`TrainState`,
`DeepSpeedTPUEngine`): the engine owns an fp32 master copy of the
parameters, the optimizer state and the LR schedule, and runs one global
step per `train_batch`:

1. the batch [train_batch_size, ...] is split into GAS micro-batches;
2. per micro-batch, `loss_fn(params, micro_batch, rng)` runs on the
   compute-dtype parameters (leaves that require grad) and its gradients
   are accumulated in fp32;
3. the sum is divided by GAS; the global norm is taken and the gradients
   are clipped to `gradient_clipping`;
4. the optimizer updates the master IN PLACE with lr = schedule(step) and
   step + 1 for bias correction, and the compute-dtype parameters are
   refreshed from it IN PLACE.

Metrics are `loss` (the mean of the micro-batch losses), `grad_norm`
(before clipping), `lr` and `skipped`. `train_batch_async` returns them as
device tensors without waiting for the card; `train_batch` reads them in
one host transfer.

One GPU shards nothing: ZeRO stages 0 and 1 are the same math there, and
both run. What needs more than one device or is not ported yet raises
NotImplementedError naming its slice: ZeRO >= 2 and hpZ (ROADMAP A12), a
mesh over more than one device (A11), pipelining (A13), offload and the
ZeRO++ / 1-bit compressed collectives (A14), fp16 loss scaling and the
dot-saving activation-checkpointing policies (A4).
"""

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config.config import DeepSpeedTPUConfig
from ..ops.optimizers import Optimizer, build_optimizer
from ..platform.accelerator import resolve_device
from ..utils.logging import log_dist
from ..utils.tree import leaves, tree_map
from .lr_schedules import build_schedule
from .precision import cast_params, clip_grads_by_global_norm, global_grad_norm


@dataclasses.dataclass
class TrainState:
    step: int  # optimizer steps taken (a host int; the JAX package keeps a device int32)
    params: Any  # compute-dtype leaves the forward reads
    master: Any  # fp32 master; None when params are fp32 (then params ARE the master)
    opt: Any


def _later(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not in the single-GPU training slice; it comes "
                               f"with {where}")


class DeepSpeedTPUEngine:
    """Engine over a (loss_fn, params) pair on one device.

    loss_fn(params, batch, rng) -> scalar loss (the mean over the batch),
    or -> (loss, aux) with has_aux=True. `rng` is a torch.Generator on the
    engine's device, seeded from (config.seed, step, micro-batch index).
    """

    def __init__(self, config: DeepSpeedTPUConfig, loss_fn: Callable, params: Any = None,
                 param_logical_specs: Any = None, mesh: Any = None,
                 rules: Optional[Dict[str, Any]] = None, has_aux: bool = False,
                 param_init_fn: Optional[Callable] = None,
                 init_rng: Optional[torch.Generator] = None, pipelined: bool = False,
                 pipeline_virtual_stages: Optional[int] = None,
                 device: Union[str, torch.device, None] = None):
        """`params` is a tree of tensors (or numpy arrays), copied; or, with
        `param_init_fn`, params = param_init_fn(generator) with a
        torch.Generator on the engine's device seeded from config.seed
        (or `init_rng`). `param_logical_specs` and `rules` are the
        reference's sharding metadata: one GPU shards nothing, so they are
        accepted and not read."""
        self.config = config
        self.loss_fn = loss_fn
        self.has_aux = has_aux
        self.device = resolve_device(device)
        self._check_supported(config, mesh, pipelined, pipeline_virtual_stages)
        config.resolve_batch_sizes(dp_world_size=1)
        log_dist(f"engine: {self.device} | zero stage {config.zero_stage} | batch "
                 f"{config.train_batch_size} = micro {config.train_micro_batch_size_per_gpu}"
                 f" x gas {config.gradient_accumulation_steps}", ranks=[0])

        self.compute_dtype = config.compute_dtype
        self._use_master = self.compute_dtype != torch.float32
        self.optimizer: Optimizer = build_optimizer(config.optimizer.type,
                                                    config.optimizer.params)
        base_lr = float(config.optimizer.params.get("lr", 1e-3))
        self.lr_schedule = build_schedule(config.scheduler.type, config.scheduler.params,
                                          base_lr=base_lr)
        self._rng_seed = config.seed
        if params is None:
            if param_init_fn is None:
                raise ValueError("the engine needs `params` or `param_init_fn`")
            if init_rng is None:
                init_rng = torch.Generator(device=self.device).manual_seed(config.seed)
            params = param_init_fn(init_rng)
        self.state = self._init_state(params)
        self.global_steps = 0
        self._metrics_host: Dict[str, float] = {}

    @staticmethod
    def _check_supported(config, mesh, pipelined, pipeline_virtual_stages) -> None:
        z = config.zero_optimization
        if mesh is not None or any(s not in (1, -1) for s in config.mesh.axis_sizes().values()):
            raise _later("a mesh over more than one device", "slice 3 (ROADMAP A11)")
        if pipelined or (pipeline_virtual_stages or 1) > 1:
            raise _later("a pipelined loss", "slice 3 (ROADMAP A13)")
        if z.stage >= 2:
            raise _later(f"ZeRO stage {z.stage}", "slice 3 (ROADMAP A12)")
        if z.zero_hpz_partition_size > 1:
            raise _later("hpZ / MiCS sub-group sharding", "slice 3 (ROADMAP A12)")
        if z.offload_optimizer.device != "none" or z.offload_param.device != "none":
            raise _later("optimizer / parameter offload", "slice 3 (ROADMAP A14)")
        if z.zero_quantized_weights or z.zero_quantized_gradients:
            raise _later("ZeRO++ quantized collectives (qwZ / qgZ)", "slice 3 (ROADMAP A14)")
        if config.fp16.enabled:
            raise _later("fp16 with dynamic loss scaling", "a later slice (ROADMAP A4)")
        if config.bf16.enabled and not config.bf16.master_weights:
            raise _later("bf16 without an fp32 master (bf16.master_weights=false)",
                         "a later slice (ROADMAP A4)")
        if config.activation_checkpointing.policy in ("dots", "dots_no_batch"):
            raise _later(f"activation_checkpointing.policy="
                         f"'{config.activation_checkpointing.policy}'",
                         "a later slice (ROADMAP A4)")

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def _init_state(self, params) -> TrainState:
        """fp32 master (a copy: the caller's tensors are never updated),
        compute-dtype params cast from it, zeroed optimizer moments."""
        def to_f32(p):
            t = p if isinstance(p, torch.Tensor) else torch.from_numpy(np.asarray(p))
            return t.detach().to(device=self.device, dtype=torch.float32, copy=True)

        master = tree_map(to_f32, params)
        opt = self.optimizer.init(master)
        if not self._use_master:
            return TrainState(step=0, params=master, master=None, opt=opt)
        return TrainState(step=0, params=cast_params(master, self.compute_dtype),
                          master=master, opt=opt)

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------
    def _to_device(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda" and not t.is_cuda:
            # pinned + non_blocking: the copy queues behind the running
            # step instead of waiting for it
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _micro_batches(self, batch):
        """Host or device leaves [train_batch_size, ...] (or [gas, micro,
        ...]) -> GAS dicts of device leaves [micro, ...]."""
        gas = self.config.gradient_accumulation_steps
        tb = self.config.train_batch_size

        def split(x):
            t = self._to_device(x)
            if t.shape[0] == tb:
                return t.reshape((gas, tb // gas) + tuple(t.shape[1:]))
            if t.ndim >= 1 and t.shape[0] == gas:
                return t
            raise ValueError(f"batch leading dim {t.shape[0]} is neither train_batch_size "
                             f"{tb} nor gas {gas}")

        stacked = {k: split(v) for k, v in batch.items()}
        return [{k: v[i] for k, v in stacked.items()} for i in range(gas)]

    def _rng(self, step: int, micro: int) -> torch.Generator:
        seed = int(np.random.SeedSequence([self._rng_seed, step, micro]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def _loss(self, params, batch, rng):
        out = self.loss_fn(params, batch, rng)
        return out[0] if self.has_aux else out

    def _remat_loss(self, params, batch, rng):
        """The loss with activation_checkpointing.policy applied: 'full'
        recomputes the whole micro-step's forward in the backward."""
        if self.config.activation_checkpointing.policy == "full":
            return checkpoint(self._loss, params, batch, rng, use_reentrant=False,
                              preserve_rng_state=False)
        return self._loss(params, batch, rng)

    # ------------------------------------------------------------------
    # the train step
    # ------------------------------------------------------------------
    def _step(self, batch) -> Dict[str, torch.Tensor]:
        cfg, st = self.config, self.state
        master = st.master if self._use_master else st.params
        acc = tree_map(torch.zeros_like, master)
        acc_leaves = leaves(acc)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for idx, micro in enumerate(self._micro_batches(batch)):
            live = tree_map(lambda p: p.detach().requires_grad_(), st.params)
            loss = self._remat_loss(live, micro, self._rng(st.step, idx))
            grads = torch.autograd.grad(loss, leaves(live), allow_unused=True)
            for a, g in zip(acc_leaves, grads):
                if g is not None:
                    a.add_(g)
            loss_sum += loss.detach().float()
        gas = cfg.gradient_accumulation_steps
        torch._foreach_mul_(acc_leaves, float(np.float32(1.0) / np.float32(gas)))
        grad_norm = global_grad_norm(acc)
        clip_grads_by_global_norm(acc, cfg.gradient_clipping, grad_norm)
        lr = self.lr_schedule(st.step)
        self.optimizer.update(acc, st.opt, master, lr, st.step + 1)
        if self._use_master:
            with torch.no_grad():
                for p, m in zip(leaves(st.params), leaves(master)):
                    p.copy_(m)
        st.step += 1
        return {"loss": loss_sum / gas, "grad_norm": grad_norm,
                "lr": torch.full((), lr, dtype=torch.float32, device=self.device),
                "skipped": torch.zeros((), dtype=torch.int32, device=self.device)}

    def train_batch_async(self, batch) -> Dict[str, torch.Tensor]:
        """One global step, returning the metrics as device tensors without
        a host sync: the host can queue the next step while the card runs
        this one."""
        metrics = self._step(batch)
        self.global_steps += 1
        return metrics

    def train_batch(self, batch) -> Dict[str, float]:
        """One global step (GAS micro-steps + the optimizer update) on host
        leaves [train_batch_size, ...] or [gas, micro, ...]; returns the
        metrics as floats, read in one host transfer."""
        t0 = time.perf_counter()
        metrics = self._step(batch)
        names = list(metrics)
        host = torch.stack([metrics[k].float() for k in names]).cpu().tolist()
        metrics = dict(zip(names, host))
        step_s = time.perf_counter() - t0
        self.global_steps += 1
        self._metrics_host = metrics
        if self.global_steps % self.config.steps_per_print == 0:
            log_dist(f"step={self.global_steps} loss={metrics['loss']:.4f} "
                     f"lr={metrics['lr']:.3e} grad_norm={metrics['grad_norm']:.3f}",
                     ranks=[0])
        if self.config.wall_clock_breakdown:
            log_dist(f"time: step={step_s * 1e3:.1f}ms samples/s="
                     f"{self.config.train_batch_size / step_s:.1f}", ranks=[0])
        return metrics

    @torch.no_grad()
    def eval_batch(self, batch) -> float:
        """Loss-only forward on the compute-dtype parameters (rng=None)."""
        batch = {k: self._to_device(v) for k, v in batch.items()}
        return float(self._loss(self.state.params, batch, None))

    # ------------------------------------------------------------------
    @property
    def params(self):
        return self.state.params

    @property
    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    @property
    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def get_lr(self) -> float:
        return self.lr_schedule(self.state.step)

    def get_global_grad_norm(self) -> Optional[float]:
        return self._metrics_host.get("grad_norm")
