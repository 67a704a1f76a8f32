"""Inference engine: continuous batching over a paged KV cache.

Counterpart of deepspeed_tpu/inference/engine.py (FastGen's
InferenceEngineV2: put / query / flush). The host-side control plane is
the reference's: prompts and decode batches are padded to power-of-two
buckets, concurrent prefills run as waves of one bucket each, decode rows
of all in-flight sequences advance in one forward per put(), and all
raggedness lives in the StateManager (inference/ragged.py), so the device
only sees dense token buffers, block tables and context lengths.

A "compiled program" of the JAX engine is a call of the inference/model.py
functions here, and the KV cache is updated in place instead of being
donated and returned. Programs run eagerly until `warmup()` captures the
decode programs as CUDA graphs (inference/graphs.py); from then on
decode_multi_fn and put()'s decode rows replay the matching graph, and a
program without one runs eagerly, as a JAX program compiles on first use.

The engine serves on one GPU, from bf16/f32 or int8 KV pools
(kv_cache_dtype="int8"), dense, sliding-window, block-sparse and
Mixtral-class MoE models: logits, or tokens sampled on the device
(inference/sampling.py) with the JAX engine's per-row streams. Weights may
be quantized (`quantization`, the JAX engine's argument): per-channel int8
({"bits": 8, "per_channel": True}), whose products stream the codes
through the W8A16 GEMM and whose MoE expert stacks stay groupwise int8,
read as codes by the int8 grouped GEMM, or groupwise int8/int4 ({"bits", "group_size",
"min_ndim"}), dequantized to the serving dtype at the entry of each
program, as the JAX engine does in each compiled step.

MoE expert census (`moe_census=True`): a device buffer of X int64
counters to which every MoE application of every program (prefill, the
decode step, decode_multi, greedy or sampled, warmup's runs and every
replay of a captured graph) adds its per-expert routed-row counts, pad rows
included, as the JAX engine's census callback counts them;
`moe_expert_census()` reads it on demand.

generate() and generate_speculative() are thin wrappers over the serving
scheduler (inference/scheduler.py), as in the JAX engine. export_kv and
import_kv move one sequence's paged KV between engines of one geometry
(the scheduler's spill tier rides on them): a gather of its written pages
over every layer into pinned host memory, sealed with a blake2b digest
(resilience/integrity.py), and a digest-checked scatter into the
receiver's pool. Offload and tensor parallelism raise NotImplementedError
naming their ROADMAP items.
"""

import dataclasses
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config.config import PrefixCacheConfig, check_field_types
from ..models import transformer as T
from ..platform.accelerator import resolve_device
from ..resilience.faults import fault_point
from ..resilience.integrity import HandoffIntegrityError, corrupt_payload, payload_digest
from ..utils import prng
from ..utils.logging import log_dist
from ..utils.tree import leaves
from . import model as M
from .graphs import DecodeGraphs, GraphKey
from .quantization import (
    ChannelQuantWeight,
    QuantizedWeight,
    dequantize_tree,
    quantize_for_inference,
)
from .ragged import StateManager
from .sampling import SamplingConfig, sample_tokens

_LATER = {
    "offload": "the slice that ports the offload tiers (ROADMAP A14)",
    "offload_quant": ("the slice that ports the offload tiers (ROADMAP A14), which parks "
                      "quantized layers in host memory"),
    "tp": "the multi-GPU slice (ROADMAP A11), which also shards quantized weights",
}
_QUANT_KEYS = {"bits", "group_size", "min_ndim"}


def _later(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with {_LATER[key]}")


class KvCacheDtypeError(ValueError):
    """KV pages cannot move between engines whose cache dtypes differ: an
    int8 payload's codes and scales mean nothing to a bf16 pool and vice
    versa, and dequantizing on the way would break the token identity of
    the recompute fallback. Also raised for an int8 payload without its
    scales."""


@dataclasses.dataclass
class InferenceConfig:
    """Counterpart of the JAX package's InferenceConfig (a pydantic model
    there, a dataclass here): unknown keys raise TypeError, wrong types
    raise TypeError, and knobs this slice does not implement raise
    NotImplementedError."""

    max_tracked_sequences: int = 256
    max_batch_size: int = 64          # decode rows per step
    max_seq_len: int = 4096           # per-sequence context cap
    kv_block_size: int = 128
    num_kv_blocks: int = 512          # total paged-cache blocks
    min_prefill_bucket: int = 64
    tp_size: int = 1
    kv_cache_dtype: str = "auto"
    moe_census: bool = False
    prefix_cache: PrefixCacheConfig = dataclasses.field(default_factory=PrefixCacheConfig)

    def __post_init__(self):
        if isinstance(self.prefix_cache, dict):
            self.prefix_cache = PrefixCacheConfig(**self.prefix_cache)
        if not isinstance(self.prefix_cache, PrefixCacheConfig):
            raise TypeError("prefix_cache must be a PrefixCacheConfig or a dict")
        check_field_types(self)
        if self.tp_size != 1:
            raise _later("tp_size > 1", "tp")
        if self.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be 'auto' or 'int8' (got {self.kv_cache_dtype!r})")

    @property
    def blocks_per_seq(self) -> int:
        return -(-self.max_seq_len // self.kv_block_size)


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class InferenceEngine:
    """put / query / flush over (params, TransformerConfig)."""

    def __init__(self, model_config: T.TransformerConfig, params: Any,
                 config: Optional[InferenceConfig] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Union[str, torch.device, None] = None,
                 quantization: Optional[Dict[str, Any]] = None,
                 offload: Optional[Dict[str, Any]] = None):
        """params: the training-layout dict (models/transformer.init, or
        utils/convert.params_from_numpy), or a prepared (serving-layout)
        tree, whose leaves may be quantized already (inference/
        quantization.py); floating leaves are cast to `dtype` and moved to
        `device` (None = the GPU; raises when absent).

        quantization: weight-only quantization, the JAX engine's keys:
        {"bits": 8, "per_channel": True} for per-channel int8, or
        {"bits": 4|8, "group_size", "min_ndim"} for groupwise. Unknown keys
        raise TypeError; per_channel with bits other than 8 ValueError.
        """
        self._quantization = dict(quantization) if quantization else None
        self._per_channel = bool(self._quantization
                                 and self._quantization.pop("per_channel", False))
        if self._quantization is not None:
            unknown = set(self._quantization) - _QUANT_KEYS
            if unknown:
                raise TypeError(f"unknown quantization keys {sorted(unknown)}; expected "
                                "bits / group_size / min_ndim / per_channel")
        if self._per_channel and int(quantization.get("bits", 8)) != 8:
            raise ValueError("per_channel quantization is int8-only (int4 uses the "
                             "groupwise memory path)")
        if offload is not None:
            raise (_later("offload serving of quantized weights", "offload_quant")
                   if quantization else _later("offload serving", "offload"))
        M.check_served(model_config)
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"serving dtype must be bfloat16 or float32 (got {dtype})")
        self.cfg = model_config
        self.config = config or InferenceConfig()
        self.device = resolve_device(device)
        self._dtype = dtype
        if model_config.attention_impl == "sparse":
            # block-sparse models serve with the train-time layout
            # (inference/model.py _sparsity); decode takes the kernels'
            # layout bitmap when cache blocks nest inside layout blocks,
            # else the per-position mask on the plain decode attention
            kernel_ok = model_config.sparse_block % self.config.kv_block_size == 0
            log_dist(
                f"serving block-sparse attention (mode={model_config.sparse_mode}); decode "
                f"uses the {'CUDA layout-masked' if kernel_ok else 'masked torch'} paged path",
                ranks=[0])
        self.graphs = DecodeGraphs(self.device)
        self.warmup_footprints: Dict[int, Dict[str, float]] = {}
        # the MoE expert census: one device buffer for the engine's life
        # (captured graphs add to it in place); None when off or dense
        self._census_enabled = self.config.moe_census and model_config.n_experts > 0
        self._census = (torch.zeros((model_config.n_experts,), dtype=torch.int64,
                                    device=self.device) if self._census_enabled else None)
        self.refresh_params(params)
        self.state = StateManager(
            num_blocks=self.config.num_kv_blocks,
            block_size=self.config.kv_block_size,
            max_tracked=self.config.max_tracked_sequences,
            enable_prefix_cache=self.config.prefix_cache.enabled,
            cache_pool_blocks=self.config.prefix_cache.pool_blocks,
        )
        # one RESERVED scratch block past the allocator's range: the fused
        # write+attend kernel writes every decode row's slot, so padding
        # rows need a target that can never alias a live sequence
        self.pad_block = self.config.num_kv_blocks
        self.kv_quant = self.config.kv_cache_dtype == "int8"
        self.cache = M.init_cache(model_config, self.config.num_kv_blocks + 1,
                                  self.config.kv_block_size, dtype, self.device,
                                  kv_quant=self.kv_quant)
        # made once, here: a copy from the host inside a decode call would
        # wait for the card, and cannot run inside a captured graph
        self._alibi = M._alibi(model_config, self.device)
        scfg = M._sparsity(model_config)
        self._layout = (None if scfg is None else M._sparse_layout(
            scfg, self.config.blocks_per_seq * self.config.kv_block_size, self.device))
        cache_dtype = "int8" if self.kv_quant else str(dtype).split('.')[-1]
        log_dist(
            f"inference engine on {self.device}: {self.config.num_kv_blocks} KV "
            f"blocks x {self.config.kv_block_size} tokens ({self._pool_bytes() / 2**30:.2f} "
            f"GiB {cache_dtype} cache), max_batch {self.config.max_batch_size}",
            ranks=[0])

    def refresh_params(self, params: Any) -> None:
        """(Re)point the served weights: cast floating leaves to the serving
        dtype on the serving device, convert to the serving layout
        (model.prepare: unstacked layers, fused QKV and gate/up) and, on a
        quantized engine, quantize again (model.quantize_prepared, or
        quantize_for_inference for groupwise). Leaves quantized already
        keep their codes; their scales are rounded to the serving dtype
        (kept in f32), as the JAX engine's cast rounds a carried tree's."""
        def cast(x):
            if isinstance(x, (ChannelQuantWeight, QuantizedWeight)):
                return dataclasses.replace(
                    x, q=x.q.to(self.device),
                    scale=x.scale.to(self.device).to(self._dtype).float())
            x = torch.as_tensor(x)
            dt = self._dtype if x.is_floating_point() else x.dtype
            return x.to(device=self.device, dtype=dt)

        top = {k: cast(v) for k, v in params.items() if k != "layers"}
        layers = params["layers"]
        if isinstance(layers, dict):
            top["layers"] = {k: cast(v) for k, v in layers.items()}
        else:
            top["layers"] = [{k: cast(v) for k, v in lp.items()} for lp in layers]
        prepared = M.prepare(top, self.cfg)
        if self._per_channel:
            prepared = M.quantize_prepared(prepared, self.cfg)
        elif self._quantization:
            prepared = quantize_for_inference(prepared, **self._quantization)
        self.params = prepared
        # groupwise codes are dequantized at each program's entry, as the
        # JAX engine does in its groupwise lane; in the per-channel lane the
        # codes feed the products directly (model._wmm) and an MoE layer's
        # groupwise expert stacks feed the int8 grouped GEMM (model._mlp):
        # Mixtral-8x7B's whole tree in bf16 would not fit the card
        groupwise = not self._per_channel and any(
            isinstance(x, QuantizedWeight) for x in leaves(prepared))
        self._dequant = dequantize_tree if groupwise else (lambda p: p)
        dropped = self.graphs.clear()
        if dropped:  # they read the old weight tensors
            log_dist(f"refresh_params dropped {dropped} captured decode graphs; call warmup() "
                     "to capture them again", ranks=[0])

    def _dev(self, x) -> torch.Tensor:
        """Host array -> tensor on the serving device."""
        return torch.as_tensor(x, device=self.device)

    def _host(self, x, dtype: torch.dtype) -> torch.Tensor:
        """A numpy array or tensor -> a tensor of `dtype` where it lies (the
        host for numpy), for a replay's copy or an eager run's input."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32 else x)
        return torch.as_tensor(x).to(dtype)

    def _program(self, key: GraphKey, sampling: Optional[SamplingConfig]):
        """The decode program of `key` as a function of (params, cache,
        *inputs): n_steps > 0 is model.decode_multi -> (gen, logits,
        presence or None); n_steps 0 one model.decode_step -> (logits,).
        Inputs: tokens, tables, ctx, then for a sampled decode_multi keys,
        step0 and, with presence, presence."""
        cfg, n_steps, uniq = self.cfg, key.n_steps, key.unique_rows

        def extras(tables):  # the engine's ALiBi slopes and layout, made once
            own = tables.shape[1] == self.config.blocks_per_seq
            return dict(alibi=self._alibi, layout=self._layout if own else None)

        deq = self._dequant
        if n_steps == 0:
            def run(params, cache, toks, tables, ctx):
                return (M.decode_step(deq(params), cache, toks, tables, ctx, cfg,
                                      unique_rows=uniq, census=self._census,
                                      **extras(tables))[0],)
            return run

        def run(params, cache, toks, tables, ctx, keys=None, step0=None, presence=None):
            gen, logits, _, pres = M.decode_multi(
                deq(params), cache, toks, tables, ctx, cfg, n_steps=n_steps, unique_rows=uniq,
                sampling=sampling, keys=keys, step0=step0, presence=presence,
                census=self._census, **extras(tables))
            return gen, logits, pres
        return run

    def _inputs(self, key: GraphKey, args) -> List[torch.Tensor]:
        dtypes = [torch.int32, torch.int32, torch.int32]
        if key.sampling is not None:
            dtypes += [torch.int64, torch.int32] + ([torch.uint8] if key.with_presence else [])
        if len(args) != len(dtypes):
            raise TypeError(f"decode program {key} takes {len(dtypes)} inputs, got {len(args)}")
        return [self._host(a, dt) for a, dt in zip(args, dtypes)]

    def _run_program(self, key: GraphKey, sampling, params, cache, args):
        """Replay the captured graph of `key` when there is one and the call
        is on the engine's own weights and cache; else run eagerly."""
        ins = self._inputs(key, args)
        prog = self.graphs.get(key)
        if prog is not None and params is self.params and cache is self.cache:
            self.graphs.replays += 1
            return prog(*ins)
        self.graphs.eager_runs += 1
        return self._program(key, sampling)(params, cache, *(x.to(self.device) for x in ins))

    def _decode_fn(self, s: int, unique_rows: bool = False):
        """One decode step over `s` rows (put()'s decode rows, the
        scheduler's mixed and chained steps, speculative verification):
        step(params, cache, tokens, tables, ctx) -> (logits [s, V] f32,
        cache), the cache updated in place. unique_rows: every row is its
        own sequence (the fused write+attend kernel); else rows may share a
        block table (the separate write, then the plain decode kernel).
        Inputs may be numpy arrays or tensors, the tokens a device tensor
        of an earlier step; a graph warmup() captured for this program
        replays, its static token buffer loaded from them."""
        key = GraphKey(s, 0, bool(unique_rows), self.config.blocks_per_seq, None, False)

        def step(params, cache, tokens, tables, ctx):
            if int(np.shape(tokens)[0]) != s:
                raise ValueError(f"_decode_fn({s}) got {np.shape(tokens)[0]} rows")
            logits, = self._run_program(key, None, params, cache, (tokens, tables, ctx))
            return logits, cache

        return step

    def _prefill_batch_fn(self, bp: int, tp: int):
        """The batched prefill of a wave of bp prompts padded to tp tokens:
        step(params, cache, tokens [bp, tp], n_real [bp], tables [bp, NB])
        -> (last-token logits [bp, V] f32, cache). Runs eagerly (flash
        forward #1 and the KV write #6 each launch once a layer)."""
        def step(params, cache, tokens, n_real, tables):
            if tuple(np.shape(tokens)) != (bp, tp):
                raise ValueError(f"_prefill_batch_fn({bp}, {tp}) got {np.shape(tokens)}")
            return M.prefill_batch(self._dequant(params), cache, self._dev(tokens),
                                   self._dev(n_real), self._dev(tables), self.cfg,
                                   census=self._census)

        return step

    def decode_multi_fn(self, s: int, n_steps: int, sampling: Optional[SamplingConfig] = None,
                        with_presence: bool = False):
        """Fused decode (model.decode_multi) for batch width `s`, n_steps
        tokens a call. Greedy: step(params, cache, tokens, tables, ctx);
        sampled (a SamplingConfig): step(params, cache, tokens, tables, ctx,
        keys, step0), with_presence adding the [s, vocab] uint8 presence
        bitmap. Returns (generated [n_steps, s] int32, final logits [s, V],
        cache, final presence or None), the cache updated in place. Inputs
        may be numpy arrays or tensors (keys: `_row_keys`, or their uint32
        words). A graph captured by warmup() for this program replays."""
        if sampling is not None and not isinstance(sampling, SamplingConfig):
            raise TypeError(f"sampling must be a SamplingConfig (got {type(sampling).__name__})")
        with_presence = with_presence and sampling is not None  # greedy carries none

        def step(params, cache, tokens, tables, ctx, *sampled):
            key = GraphKey(s, n_steps, True, int(np.shape(tables)[1]),
                           None if sampling is None else sampling.key(), with_presence)
            if int(np.shape(tokens)[0]) != s:
                raise ValueError(f"decode_multi_fn({s}) got {np.shape(tokens)[0]} rows")
            gen, logits, pres = self._run_program(key, sampling, params, cache,
                                                  (tokens, tables, ctx) + sampled)
            return gen, logits, cache, pres

        return step

    def moe_expert_census(self) -> np.ndarray:
        """[X] int64 cumulative per-expert routed-row counts (over layers
        and steps; InferenceConfig.moe_census): a read of the device
        buffer, which waits for the work queued before it. Zeros of length
        max(n_experts, 1) when the census is off, as the JAX engine's."""
        if self._census is None:
            return np.zeros((max(self.cfg.n_experts, 1),), np.int64)
        return self._census.cpu().numpy().astype(np.int64)

    def _sample_fn(self, scfg: SamplingConfig, with_presence: bool):
        """The sampling epilogue over a [n, V] logits batch (put()'s token
        return): fn(logits, keys, steps[, presence]) -> [n] int32."""
        if with_presence:
            return lambda lg, keys, steps, pres: sample_tokens(lg, scfg, keys, steps,
                                                               presence=pres)
        return lambda lg, keys, steps: sample_tokens(lg, scfg, keys, steps)

    def _row_keys(self, seed: int, streams) -> torch.Tensor:
        """Per-row keys [S, 2] int64 on the serving device: fold_in of
        PRNGKey(seed) with each row's stream id (uint32), the JAX engine's
        `_row_keys`. A row's draw at position t then uses fold_in(key, t):
        batch composition never changes a sequence's stream."""
        return prng.fold_in(prng.prng_key(seed), prng.words(np.asarray(streams))).to(
            self.device)

    def _pools(self) -> List[torch.Tensor]:
        """Every per-layer pool of the cache: codes or K/V rows, and the
        scale pools of an int8 cache (part of each page)."""
        return [p for group in self._pool_groups() for p in group]

    def _pool_bytes(self) -> int:
        return sum(x.nbytes for x in self._pools())

    def _copy_block(self, src: int, dst: int) -> None:
        """Cache-page copy (the copy-on-write half of prefix caching): clone
        block src's K/V rows, and on an int8 cache its scale tiles, into
        block dst in every layer, in place."""
        for pool in self._pools():
            pool[dst].copy_(pool[src])

    def kv_bytes_per_token(self) -> int:
        """Resident KV bytes one token costs across all layers: its [KV, D]
        K and V rows (codes on an int8 cache) plus, on an int8 cache, its
        two [KV] f32 scale rows."""
        return sum(pool[0, 0].nbytes for pool in self._pools())

    def prefix_cache_stats(self) -> Dict[str, float]:
        """Prefix-cache counters (ragged.py StateManager.cache_stats) plus
        the KV-pool residency numbers: kv_bytes_per_token, kv_pool_bytes
        (the whole pool with the scratch block and any scale pools) and
        kv_quantized (1.0 on int8 pools)."""
        s = self.state.cache_stats()
        s["kv_bytes_per_token"] = float(self.kv_bytes_per_token())
        s["kv_pool_bytes"] = float(self._pool_bytes())
        s["kv_quantized"] = 1.0 if self.cache.quantized else 0.0
        return s

    # -- scheduling queries ---------------------------------------------
    def query(self, uid: int) -> Dict[str, Any]:
        seq = self.state.get(uid)
        seen = seq.seen_tokens if seq else 0
        cached_cap = (len(seq.blocks) * self.state.block_size - seen) if seq else 0
        return {
            "seen_tokens": seen,
            "free_blocks": self.state.free_blocks,
            "max_new_tokens": min(
                cached_cap + self.state.free_blocks * self.state.block_size,
                self.config.max_seq_len - seen),
            "prefix_cache": self.state.cache_stats(),
        }

    def can_schedule(self, uids: Iterable[int], lengths: Iterable[int]) -> bool:
        need = 0
        for uid, n in zip(uids, lengths):
            seq = self.state.get(uid)
            seen = seq.seen_tokens if seq else 0
            if seen + n > self.config.max_seq_len:
                return False
            have = len(seq.blocks) if seq else 0
            need += max(0, -(-(seen + n) // self.state.block_size) - have)
        return need <= self.state.free_blocks

    # -- the engine step --------------------------------------------------
    def put(self, uids: Sequence[int], tokens: Sequence[np.ndarray],
            return_tokens: bool = False, sampling: Optional[Dict[str, Any]] = None,
            seed: int = 0, presence: Optional[np.ndarray] = None, strict: bool = True,
            sampling_streams: Optional[Sequence[int]] = None) -> Any:
        """Run one engine step over a ragged batch.

        New uids carry their whole prompt; known uids carry one or more
        continuation tokens. Returns next-token logits [len(uids), vocab]
        f32 numpy, in input order, or with return_tokens=True the tokens
        [len(uids)] int32 sampled on the device (only they cross to the
        host).

        sampling: SamplingConfig kwargs (greedy when omitted). seed, the
        row's stream (its uid, or sampling_streams[i] for input row i) and
        the sampled token's position define each draw, as in the JAX
        engine: batch composition never changes a sequence's tokens.
        presence: [len(uids), vocab] uint8 seen-token bitmap, required when
        repetition_penalty != 1.

        strict=True raises BEFORE any state mutation when the batch's new
        prompts do not fit the KV pool. strict=False admits prompts per
        uid while capacity lasts and returns (results, rejected_uids);
        rejected rows are zeros."""
        uids = list(uids)
        tokens = [np.atleast_1d(np.asarray(t, np.int32)) for t in tokens]
        if len(uids) != len(set(uids)):
            raise ValueError("duplicate uids in one put()")
        if len(uids) != len(tokens):
            raise ValueError("uids and tokens length mismatch")
        prefills: List[Tuple[int, int, np.ndarray]] = []  # (pos, uid, toks)
        # chunked continuation: an in-flight sequence's multi-token chunk
        # becomes len(chunk) decode rows sharing one block table with
        # per-row increasing context (only the last row's logits surface)
        decodes: List[Tuple[int, int, np.ndarray]] = []  # (pos, uid, chunk)
        n_rows = 0
        for i, (uid, toks) in enumerate(zip(uids, tokens)):
            if len(toks) == 0:
                raise ValueError(f"uid {uid}: empty token array")
            seq = self.state.get(uid)
            if seq is not None and seq.seen_tokens > 0:
                if seq.seen_tokens + len(toks) > self.config.max_seq_len:
                    raise ValueError(
                        f"uid {uid}: {seq.seen_tokens}+{len(toks)} tokens > max_seq_len")
                decodes.append((i, uid, toks))
                n_rows += len(toks)
            else:
                if len(toks) > self.config.max_seq_len:
                    raise ValueError(f"prompt of {len(toks)} > max_seq_len")
                prefills.append((i, uid, toks))
        if n_rows > self.config.max_batch_size:
            raise RuntimeError(
                f"{n_rows} decode rows > max_batch_size "
                f"{self.config.max_batch_size}; split the put()")

        sample = None
        if return_tokens:
            scfg = SamplingConfig(**(sampling or {}))
            if scfg.needs_presence and presence is None:
                raise ValueError(
                    "repetition_penalty needs the seen-token bitmap: pass "
                    "presence=[len(uids), vocab] uint8")
            tok_out = np.zeros((len(uids),), np.int32)
            stream_of = {u: (sampling_streams[i] if sampling_streams is not None else u)
                         for i, u in enumerate(uids)}

            def sample(logits_all, rows, row_uids, row_steps, row_pos):
                """Sample the bucketed logits [bucket, V] on the device: the
                real rows are `rows`; pad rows draw garbage never read."""
                bucket = logits_all.shape[0]
                streams = np.zeros((bucket,), np.uint32)
                steps = np.zeros((bucket,), np.int32)
                streams[np.asarray(rows)] = [stream_of[u] for u in row_uids]
                steps[np.asarray(rows)] = row_steps
                keys = self._row_keys(seed, streams)
                if presence is not None and scfg.needs_presence:
                    pres = np.zeros((bucket, presence.shape[1]), presence.dtype)
                    pres[np.asarray(rows)] = presence[np.asarray(row_pos)]
                    toks = self._sample_fn(scfg, True)(logits_all, keys, self._dev(steps),
                                                       self._dev(pres))
                else:
                    toks = self._sample_fn(scfg, False)(logits_all, keys, self._dev(steps))
                tok_out[np.asarray(row_pos)] = toks.cpu().numpy()[np.asarray(rows)]

        out = np.zeros((len(uids), self.cfg.vocab_size), np.float32)
        rejected: List[int] = []
        if prefills:
            if not self.can_schedule([u for _, u, _ in prefills],
                                     [len(t) for _, _, t in prefills]):
                if strict:
                    raise RuntimeError(
                        "insufficient KV blocks for this prefill wave; free "
                        "sequences, split the put(), or use strict=False for "
                        "per-prompt admission")
                admitted = []
                for pos, uid, toks in prefills:
                    if self.can_schedule([u for _, u, _ in admitted] + [uid],
                                         [len(t) for _, _, t in admitted] + [len(toks)]):
                        admitted.append((pos, uid, toks))
                    else:
                        rejected.append(uid)
                prefills = admitted
        if prefills and self.state.enable_prefix_cache:
            # prefix-cache admission: a prompt whose leading full blocks
            # match the index SHARES them and runs only the suffix, through
            # the chunked-continuation decode rows (bounded by the row
            # budget). Capacity was checked above without cache credit.
            missed: List[Tuple[int, int, np.ndarray]] = []
            for pos, uid, toks in prefills:
                budget = self.config.max_batch_size - n_rows
                _, match = self.state.extend(uid, len(toks), token_ids=toks,
                                             max_suffix_rows=budget)
                if match.n_cached > 0:
                    if match.cow is not None:
                        # shared tail block: clone the page before the
                        # recomputed last token writes into it
                        self._copy_block(*match.cow)
                    suffix = toks[match.n_cached:]
                    decodes.append((pos, uid, suffix))
                    n_rows += len(suffix)
                else:
                    missed.append((pos, uid, toks))
            prefills = missed
        if prefills:
            self._prefill_waves(prefills, out, sample)
        if decodes:
            self._decode_rows(decodes, n_rows, out, sample)
        result = tok_out if return_tokens else out
        if not strict:
            return result, rejected
        return result

    def _prefill_waves(self, prefills, out: np.ndarray, sample=None) -> None:
        """Prompts run as waves grouped by power-of-two token bucket (a
        solo prompt is a wave of one), at most the largest power of two
        <= max_batch_size prompts each."""
        prefills = sorted(prefills, key=lambda pu: len(pu[2]))
        groups: Dict[int, List[Tuple[int, int, np.ndarray]]] = {}
        for pu in prefills:
            groups.setdefault(_bucket(len(pu[2]), self.config.min_prefill_bucket),
                              []).append(pu)
        cap = 1 << (self.config.max_batch_size.bit_length() - 1)
        waves = [g[w0:w0 + cap] for _, g in sorted(groups.items())
                 for w0 in range(0, len(g), cap)]
        for wave in waves:
            tp = _bucket(max(len(t) for _, _, t in wave), self.config.min_prefill_bucket)
            bp = _bucket(len(wave), 1)
            toks_b = np.zeros((bp, tp), np.int32)
            n_real = np.zeros((bp,), np.int32)
            tables = np.zeros((bp, self.config.blocks_per_seq), np.int32)
            for row, (pos, uid, toks) in enumerate(wave):
                n = len(toks)
                self.state.extend(uid, n)
                toks_b[row, :n] = toks
                n_real[row] = n
                tables[row] = self.state.block_table([uid], self.config.blocks_per_seq)[0]
            logits, self.cache = self._prefill_batch_fn(bp, tp)(
                self.params, self.cache, toks_b, n_real, tables)
            for pos, uid, toks in wave:
                self.state.commit(uid, len(toks), token_ids=toks)
            if sample is not None:  # each row's draw counter: its token's position
                sample(logits, list(range(len(wave))), [uid for _, uid, _ in wave],
                       [len(toks) for _, _, toks in wave], [pos for pos, _, _ in wave])
                continue
            logits = logits.cpu().numpy()
            for row, (pos, uid, toks) in enumerate(wave):
                out[pos] = logits[row]

    def _decode_rows(self, decodes, n_rows: int, out: np.ndarray, sample=None) -> None:
        sp = _bucket(n_rows, 8)
        toks = np.zeros((sp,), np.int32)
        ctx = np.zeros((sp,), np.int32)  # pad rows: ctx 0 = inert
        tables = np.full((sp, self.config.blocks_per_seq), self.pad_block, np.int32)
        last_row: List[int] = []  # each chunk's final row index
        row = 0
        for pos, uid, chunk in decodes:
            base = self.state.get(uid).seen_tokens
            self.state.extend(uid, len(chunk))
            table = self.state.block_table([uid], self.config.blocks_per_seq,
                                           self.pad_block)[0]
            for j, tok in enumerate(chunk):
                toks[row] = int(tok)
                ctx[row] = base + j + 1
                tables[row] = table
                row += 1
            last_row.append(row - 1)
        # single-token rows are all DISTINCT sequences -> the fused
        # write+attend kernel; multi-token chunks share a table across rows
        # and take the separate write + plain decode kernel
        unique = all(len(c) == 1 for _, _, c in decodes)
        logits, _ = self._decode_fn(sp, unique)(self.params, self.cache, toks, tables, ctx)
        for pos, uid, chunk in decodes:
            self.state.commit(uid, len(chunk), token_ids=chunk)
        if sample is not None:
            sample(logits, last_row, [uid for _, uid, _ in decodes],
                   [self.state.get(uid).seen_tokens for _, uid, _ in decodes],
                   [pos for pos, _, _ in decodes])
            return
        logits_np = logits[:n_rows].cpu().numpy()
        for (pos, uid, chunk), lr in zip(decodes, last_row):
            out[pos] = logits_np[lr]

    def flush(self, uid: int) -> None:
        """Free a sequence's KV blocks."""
        self.state.flush(uid)

    # -- warmup: capture the decode programs ---------------------------------
    def warmup(self, sampling: Optional[Dict[str, Any]] = None,
               widths: Optional[Sequence[int]] = None, chunked: bool = True,
               decode_chunks: Sequence[int] = (), presence: bool = False,
               footprint: bool = True) -> Dict[str, Any]:
        """Run every decode program the engine can dispatch at these widths
        once, over inert pad rows (ctx 0, tables on the reserved pad_block:
        the live cache is untouched), and on a CUDA engine capture each
        decode program as a CUDA graph (inference/graphs.py), so that
        serving replays instead of issuing every op from the host. The
        program grid and its count are the JAX engine's warmup's.

        widths: decode-row buckets (default: powers of two from 8 up to
        bucket(max_batch_size)). chunked=True adds the shared-table step of
        mixed prefill chunks. decode_chunks: decode_multi depths to warm
        per width. sampling/presence select the sampling variant (the put()
        epilogue runs once per width; it is not captured). footprint=True
        fills `warmup_footprints[width]` on a CUDA engine from the CUDA
        allocator around that width's programs: peak_hbm_bytes (the most
        allocated), arg_bytes (allocated when the width began: weights,
        KV pools, everything resident) and temp_bytes (their difference).

        Returns {programs, graphs (captured by this call: a program
        captured before replays instead; 0 on the CPU), seconds, widths,
        chunks, hbm_per_bucket}. A failed capture raises."""
        scfg = SamplingConfig(**(sampling or {}))
        if widths is None:
            widths, w = [], 8
            while w <= _bucket(self.config.max_batch_size, 8):
                widths.append(w)
                w *= 2
        widths = [int(w) for w in widths]
        chunks = [int(c) for c in decode_chunks]
        use_sampler = not (scfg.greedy and not scfg.needs_presence)
        with_pres = bool(presence and scfg.needs_presence)
        capture = self.graphs.enabled
        NB, V = self.config.blocks_per_seq, self.cfg.vocab_size
        t0 = time.perf_counter()
        n, graphs0 = 0, self.graphs.captures

        def run(key, sampled, inputs):
            ins = [x.to(self.device) for x in self._inputs(key, inputs)]
            if capture and self.graphs.get(key) is not None:  # captured already: replay
                return self.graphs.get(key)(*ins)
            if capture:
                return self.graphs.capture(
                    key, lambda *a: self._program(key, sampled)(self.params, self.cache, *a),
                    ins)
            return self._program(key, sampled)(self.params, self.cache, *ins)

        for w in widths:
            toks = np.zeros((w,), np.int32)
            ctx = np.zeros((w,), np.int32)
            tables = np.full((w, NB), self.pad_block, np.int32)
            steps = np.zeros((w,), np.int32)
            keys = self._row_keys(0, np.zeros((w,), np.uint32))
            if footprint and capture:
                torch.cuda.synchronize(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
                base = torch.cuda.memory_allocated(self.device)
            logits = None
            for uniq in ((True, False) if chunked else (True,)):
                logits, = run(GraphKey(w, 0, uniq, NB, None, False), None, (toks, tables, ctx))
                n += 1
            if with_pres:
                self._sample_fn(scfg, True)(logits, keys, self._dev(steps),
                                            self._dev(np.zeros((w, V), np.uint8)))
            else:
                self._sample_fn(scfg, False)(logits, keys, self._dev(steps))
            n += 1
            for C in chunks:
                if C < 1:
                    continue
                sampled = scfg if use_sampler else None
                key = GraphKey(w, C, True, NB, None if sampled is None else scfg.key(),
                               with_pres)
                ins = (toks, tables, ctx)
                if use_sampler:
                    ins += (keys, steps) + ((np.zeros((w, V), np.uint8),) if with_pres else ())
                run(key, sampled, ins)
                n += 1
            if footprint and capture:
                torch.cuda.synchronize(self.device)
                peak = torch.cuda.max_memory_allocated(self.device)
                self.warmup_footprints[w] = {"peak_hbm_bytes": float(peak),
                                             "arg_bytes": float(base),
                                             "temp_bytes": float(peak - base)}
        if capture:
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        n_graphs = self.graphs.captures - graphs0
        fp = self.warmup_footprints
        fp_note = (f", peak {max(f['peak_hbm_bytes'] for f in fp.values()) / 2**20:.0f} MiB"
                   if fp else "")
        log_dist(
            f"serving warmup: {n} programs, {n_graphs} captured as CUDA graphs (decode widths "
            f"{widths}{' +chunked' if chunked else ''}, fused depths {chunks}, "
            f"sampling={'on' if use_sampler else 'greedy'}) in {dt:.1f}s{fp_note}",
            ranks=[0])
        return {"programs": n, "graphs": n_graphs, "seconds": dt, "widths": widths,
                "chunks": chunks,
                "hbm_per_bucket": {w: f["peak_hbm_bytes"] for w, f in sorted(fp.items())}}

    # -- paged-KV block transfer -------------------------------------------
    def _kv_dtype_name(self) -> str:
        """The pool's dtype as the JAX engine names it (str of a numpy or
        jnp dtype): "bfloat16", "float32" or "int8"."""
        return str(self.cache.k[0].dtype).split(".")[-1]

    def _pad_block_idx(self, blocks: List[int]) -> np.ndarray:
        idx = np.full((self.config.blocks_per_seq,), self.pad_block, np.int32)
        idx[:len(blocks)] = blocks
        return idx

    def _pool_groups(self) -> List[List[torch.Tensor]]:
        """The cache's per-layer pools by payload field: k, v and, on an
        int8 cache, k_scale and v_scale."""
        c = self.cache
        return [c.k, c.v] + ([c.k_scale, c.v_scale] if c.quantized else [])

    def kv_payload_nbytes(self, n_blocks: int) -> int:
        """Bytes of an export_kv payload's page stacks (codes plus, on an
        int8 cache, the scale tiles) for a sequence of `n_blocks` blocks,
        computed without the gather: the spill tier's budget pre-check."""
        per_page = int(self.cache.k[0][0].nbytes)
        if self.cache.quantized:
            per_page += int(self.cache.k_scale[0][0].nbytes)
        return 2 * self.cfg.n_layers * n_blocks * per_page

    def _kv_gather(self, blocks: Sequence[int]) -> List[np.ndarray]:
        """The pages `blocks` of every layer, one gather a payload field
        into a [L, n, ...] device stack, copied to the host (pinned memory
        on a CUDA engine) and waited for: the digest that follows reads
        these bytes, so they must be whole."""
        idx = torch.as_tensor(np.asarray(blocks, np.int64), device=self.device)
        stacks = []
        for pools in self._pool_groups():
            dst = torch.empty((len(pools), len(blocks)) + tuple(pools[0].shape[1:]),
                              dtype=pools[0].dtype, device=self.device)
            for li, pool in enumerate(pools):
                torch.index_select(pool, 0, idx, out=dst[li])
            stacks.append(dst)
        if self.device.type == "cuda":
            host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in stacks]
            for h, x in zip(host, stacks):
                h.copy_(x, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            stacks = host
        return [_to_numpy(x) for x in stacks]

    def _kv_scatter(self, blocks: List[int], arrays: Sequence[np.ndarray]) -> None:
        """Write transferred pages into this cache, one scatter a payload
        field over every layer: a [L, blocks_per_seq, ...] stack whose rows
        past len(blocks) (zero pages, unit scales) land on the reserved
        scratch block, never on a live page."""
        nb = len(blocks)
        idx = torch.as_tensor(self._pad_block_idx(blocks).astype(np.int64), device=self.device)
        B = self.config.blocks_per_seq
        for pools, arr, fill in zip(self._pool_groups(), arrays, (0.0, 0.0, 1.0, 1.0)):
            src = _from_numpy(arr, pools[0].dtype)
            dev = torch.full((len(pools), B) + tuple(pools[0].shape[1:]), fill,
                             dtype=pools[0].dtype, device=self.device)
            dev[:, :nb].copy_(src)
            for li, pool in enumerate(pools):
                pool.index_copy_(0, idx, dev[li])

    def _payload(self, seen: int, blocks: List[int], token_ids) -> Dict[str, Any]:
        stacks = self._kv_gather(blocks)
        payload = {"seen_tokens": int(seen), "n_blocks": len(blocks),
                   "kv_dtype": self._kv_dtype_name(), "token_ids": token_ids,
                   "k": stacks[0], "v": stacks[1]}
        if self.cache.quantized:
            # scale tiles ship with their code pages, under the digest
            payload["k_scale"], payload["v_scale"] = stacks[2], stacks[3]
        payload["digest"] = payload_digest(payload)
        return payload

    def export_kv(self, uid: int) -> Dict[str, Any]:
        """Serialize one sequence's paged KV for a move to another engine
        of the same geometry (or the scheduler's spill tier): its written
        pages of every layer gathered and read back to host numpy. The
        payload is self-describing: seen_tokens, n_blocks, kv_dtype, the
        token record (for the receiver's prefix index, None when the host
        never saw some tokens), the [L, n_blocks, bs, KV, D] K and V page
        stacks and, from an int8 pool, the [L, n_blocks, bs, KV] f32
        k_scale and v_scale tiles, sealed by "digest" (blake2b over every
        field, resilience/integrity.py payload_digest).

        Only the blocks holding written KV ship: min(len(blocks),
        ceil(seen_tokens / block_size)); a preempted sequence's reservation
        tail carries no data. bf16 pages are numpy uint16 arrays of the
        bf16 bit patterns (numpy has no bfloat16), tagged kv_dtype
        "bfloat16"; the digest names their dtype "bfloat16", so it equals
        the JAX engine's digest of the same bytes."""
        act = fault_point("engine.export_kv", uid=uid)
        if act is not None and act.kind == "delay":
            time.sleep(act.value)  # a hung transfer
        seq = self.state.get(uid)
        if seq is None:
            raise KeyError(f"unknown sequence uid {uid}")
        nb = min(len(seq.blocks), -(-seq.seen_tokens // self.state.block_size))
        token_ids = list(seq.tokens[:seq.seen_tokens]) if seq.tokens_valid else None
        return self._payload(seq.seen_tokens, seq.blocks[:nb], token_ids)

    def import_kv(self, uid: int, payload: Dict[str, Any]) -> None:
        """Adopt a sequence whose KV pages arrive from export_kv() of a peer
        engine (the port's or the JAX package's): allocate its blocks,
        scatter the pages, and commit the token record (which registers the
        prefix in this engine's index). Checks, in this order and all
        before any block is allocated: the digest (HandoffIntegrityError),
        the pool dtype (KvCacheDtypeError), the page geometry (ValueError)
        and an int8 payload's scales (KvCacheDtypeError). Raises
        KVCacheExhaustedError when the pool cannot take the sequence."""
        fault_point("engine.import_kv", uid=uid)
        # 'corrupt' flips one bit of a COPY of the payload's page stacks
        act = fault_point("handoff.payload", uid=uid)
        if act is not None and act.kind == "corrupt":
            payload, flips = corrupt_payload(payload, act.seed, act.invocation)
            log_dist(f"chaos: corrupted KV handoff payload of uid {uid} ({flips})", ranks=[0])
        if "digest" in payload and payload_digest(payload) != payload["digest"]:
            raise HandoffIntegrityError(
                f"KV handoff payload of uid {uid} failed digest verification; discarding "
                "it (recompute fallback)")
        own_dtype = self._kv_dtype_name()
        sent_dtype = payload.get("kv_dtype", own_dtype)
        if sent_dtype != own_dtype:
            raise KvCacheDtypeError(
                f"KV payload of uid {uid} carries {sent_dtype} pages but this engine's pool "
                f"is {own_dtype}; recompute the sequence instead")
        n_tok = int(payload["seen_tokens"])
        nb = int(payload["n_blocks"])
        k, v = payload["k"], payload["v"]
        want = tuple(self.cache.k[0].shape[1:])  # (bs, KV, D) a page
        if (tuple(k.shape[2:]) != want or k.shape[0] != self.cfg.n_layers
                or k.shape[1] != nb or tuple(v.shape) != tuple(k.shape)):
            raise ValueError(
                f"KV payload geometry {tuple(k.shape)} does not match this engine's cache "
                f"pages {(self.cfg.n_layers, nb) + want}: the engines must be "
                "model- and geometry-identical")
        if self.kv_quant and ("k_scale" not in payload or "v_scale" not in payload):
            raise KvCacheDtypeError(
                f"int8 KV payload of uid {uid} is missing its per-block scale tensors; "
                "refusing to scatter scaleless codes")
        seq = self.state.extend(uid, n_tok)  # may raise: pool exhausted
        if len(seq.blocks) != nb:
            raise AssertionError(f"import of {n_tok} tokens took {len(seq.blocks)} blocks, "
                                 f"the payload carries {nb}")
        arrays = [k, v] + ([payload["k_scale"], payload["v_scale"]] if self.kv_quant else [])
        self._kv_scatter(list(seq.blocks), arrays)
        self.state.commit(uid, n_tok, token_ids=payload["token_ids"])

    def warmup_kv_transfer(self) -> None:
        """Run the handoff gather and scatter once over the scratch block
        alone, so that the first real transfer meets warm kernels and a
        warm pinned-memory pool."""
        self._kv_scatter([], self._kv_gather([self.pad_block]))

    def export_parked_kv(self, limit: int) -> List[Dict[str, Any]]:
        """export_kv-format payloads of up to `limit` of this engine's
        hottest PARKED prefix chains (StateManager.parked_chains,
        MRU-first), one a chain: seen_tokens covers exactly the chain's
        full blocks, chains longer than blocks_per_seq are cut to it. A
        joining replica import_kv()s each onto a scratch uid and flushes
        it, which parks the pages and registers the prefix in its own
        index. Read-only here."""
        payloads: List[Dict[str, Any]] = []
        bs = self.state.block_size
        for tokens, blocks in self.state.parked_chains(limit):
            nb = min(len(blocks), self.config.blocks_per_seq)
            payloads.append(self._payload(nb * bs, list(blocks[:nb]), list(tokens[:nb * bs])))
        return payloads

    # -- speculative (multi-token-per-stream) decoding -----------------------
    def _verify_chunks(self, uids: Sequence[int],
                       chunks: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Run each uid's candidate chunk through ONE decode step of
        shared-table rows and return every row's logits ([len(chunk), V]
        a uid): the verification half of speculative decoding. KV of all
        candidate rows is written but seen_tokens is NOT committed: the
        caller commits the accepted prefix, and later tokens overwrite the
        rejected rows' slots."""
        rows = sum(len(c) for c in chunks)
        if rows > self.config.max_batch_size:
            raise RuntimeError(f"{rows} verify rows > max_batch_size "
                               f"{self.config.max_batch_size}")
        sp = _bucket(rows, 8)
        toks = np.zeros((sp,), np.int32)
        ctx = np.zeros((sp,), np.int32)
        tables = np.full((sp, self.config.blocks_per_seq), self.pad_block, np.int32)
        spans: List[Tuple[int, int]] = []
        row = 0
        for uid, chunk in zip(uids, chunks):
            base = self.state.get(uid).seen_tokens
            self.state.extend(uid, len(chunk))
            table = self.state.block_table([uid], self.config.blocks_per_seq,
                                           self.pad_block)[0]
            spans.append((row, row + len(chunk)))
            for j, tok in enumerate(chunk):
                toks[row] = int(tok)
                ctx[row] = base + j + 1
                tables[row] = table
                row += 1
        logits, _ = self._decode_fn(sp, False)(self.params, self.cache, toks, tables, ctx)
        logits_np = logits[:rows].float().cpu().numpy()
        return [logits_np[a:b] for a, b in spans]

    @staticmethod
    def _ngram_draft(hist: List[int], ngram: int, k: int) -> List[int]:
        """Prompt-lookup drafting: the most recent earlier occurrence of the
        last `ngram` tokens proposes the k tokens that followed it."""
        if k <= 0 or len(hist) <= ngram:
            return []
        pat = hist[-ngram:]
        for i in range(len(hist) - ngram - 1, -1, -1):
            if hist[i:i + ngram] == pat:
                return hist[i + ngram: i + ngram + k]
        return []

    def generate_speculative(self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32,
                             eos_token_id: Optional[int] = None, ngram: int = 3,
                             draft_len: int = 4, return_stats: bool = False) -> Any:
        """Greedy generation with prompt-lookup self-speculation: each step
        feeds [pending, draft_1..draft_k] through ONE decode step and
        accepts the longest greedy-consistent prefix. Exact: the output
        equals plain greedy decoding token for token. The request
        lifecycle runs through ServingScheduler in speculative mode.
        return_stats=True also returns the scheduler's spec_summary()."""
        from .scheduler import ServingScheduler, ServingSchedulerConfig

        if len(prompts) > self.config.max_batch_size:
            raise ValueError(
                f"{len(prompts)} prompts > max_batch_size {self.config.max_batch_size} "
                "(every live sequence needs at least one verify row per step)")
        sched = ServingScheduler(
            self, ServingSchedulerConfig(prefill_mode="wave", warmup=False), seed=0,
            speculative={"ngram": int(ngram), "draft_len": int(draft_len)})
        rids = [sched.submit(list(p), max_new_tokens, eos_token_id, stream=i)
                for i, p in enumerate(prompts)]
        sched.run()
        outs = [sched.finished[r].output for r in rids]
        if return_stats:
            return outs, sched.spec_summary()
        return outs

    @staticmethod
    def sample_token(logits: np.ndarray, *, temperature: float = 1.0, top_k: int = 0,
                     top_p: float = 1.0, repetition_penalty: float = 1.0,
                     seen_tokens: Sequence[int] = (),
                     rng: Optional[np.random.Generator] = None) -> int:
        """One next-token draw from a [V] float logits row, on the host in
        numpy. temperature <= 0 is greedy argmax. top_k/top_p filter before
        the softmax draw (both may combine). repetition_penalty follows the
        CTRL rule: a seen token's logit is divided by the penalty when
        positive, multiplied when negative. Pass `rng` for replayable
        draws."""
        row = np.asarray(logits, np.float64).copy()
        if repetition_penalty != 1.0 and len(seen_tokens):
            idx = np.unique(np.asarray(list(seen_tokens), np.int64))
            pos = row[idx] > 0
            row[idx] = np.where(pos, row[idx] / repetition_penalty,
                                row[idx] * repetition_penalty)
        if temperature <= 0.0:
            return int(np.argmax(row))
        row = row / temperature
        if top_k and 0 < top_k < row.size:
            kth = np.partition(row, -top_k)[-top_k]
            row[row < kth] = -np.inf
        if 0.0 < top_p < 1.0:
            order = np.argsort(row)[::-1]
            probs = np.exp(row[order] - row[order[0]])
            probs /= probs.sum()
            keep = np.cumsum(probs) - probs < top_p  # always keeps the top-1
            row[order[~keep]] = -np.inf
        probs = np.exp(row - row.max())
        probs /= probs.sum()
        gen = rng if rng is not None else np.random.default_rng()
        return int(gen.choice(row.size, p=probs))

    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 repetition_penalty: float = 1.0, seed: Optional[int] = None,
                 chunk: int = 8) -> List[List[int]]:
        """Continuous-batch generation; returns the new tokens of each
        prompt. A thin wrapper over ServingScheduler (prefill_mode='wave',
        decode_chunk=chunk, warmup off), as in the JAX engine: prompts
        prefill in waves, then decode in fused decode_multi chunks of
        `chunk` steps with sampling on the device. Draws are keyed by
        (seed, stream = the prompt's index, position), so a fixed seed
        reproduces the tokens whatever the batching; seed=None draws a
        fresh seed. A sequence that finishes is flushed at once, more
        prompts than max_batch_size queue, and KV pressure preempts the
        youngest sequence for recompute."""
        from .scheduler import ServingScheduler, ServingSchedulerConfig

        seed_val = int(np.random.default_rng().integers(2**31)) if seed is None else int(seed)
        sched = ServingScheduler(
            self,
            ServingSchedulerConfig(
                decode_chunk=max(1, int(chunk)), prefill_mode="wave",
                max_num_batched_tokens=max(self.config.max_batch_size,
                                           ServingSchedulerConfig().max_num_batched_tokens),
                warmup=False),
            sampling=dict(do_sample=do_sample, temperature=temperature, top_k=top_k,
                          top_p=top_p, repetition_penalty=repetition_penalty),
            seed=seed_val)
        rids = [sched.submit(list(p), max_new_tokens, eos_token_id, stream=i)
                for i, p in enumerate(prompts)]
        sched.run()
        return [sched.finished[r].output for r in rids]


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, sharing its memory; bf16 as its uint16 bits
    (numpy has no bfloat16)."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _from_numpy(arr, dtype: torch.dtype) -> torch.Tensor:
    """A payload array as a host tensor of the pool's dtype: bf16 pages come
    as uint16 bits (the port's payloads) or as an ml_dtypes bfloat16 array
    (the JAX package's); anything else must already have the pool's
    dtype."""
    arr = np.ascontiguousarray(arr)
    if dtype == torch.bfloat16:
        if arr.dtype != np.uint16 and arr.dtype.name != "bfloat16":
            raise KvCacheDtypeError(f"bf16 pages must come as 16-bit words, got {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(arr)
    if t.dtype != dtype:
        raise KvCacheDtypeError(f"pages of {arr.dtype} for a {dtype} pool")
    return t


def init_inference(params: Any, model_config: T.TransformerConfig,
                   config: Optional[Dict[str, Any]] = None,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Union[str, torch.device, None] = None,
                   quantization: Optional[Dict[str, Any]] = None,
                   offload: Optional[Dict[str, Any]] = None) -> InferenceEngine:
    """Build the inference engine; config keys follow InferenceConfig
    (an unknown key raises TypeError).

    DeepSpeed's v1 inference config keys are translated first, as the
    JAX package's init_inference does (`_v1_config`): `dtype` sets the
    serving dtype ("fp32"/"float"/"double" serve f32, "fp16"/"half"/"bf16"
    bf16, "int8" bf16 with groupwise int8 weights), `max_out_tokens` is
    `max_seq_len`, the kernel-injection and CUDA-graph keys are logged
    no-ops, `tensor_parallel` is `tp_size` and `offload` is the kwarg
    (both still raise in the engine: ROADMAP A11, A14).

    device=None serves on the GPU and raises when there is none; pass
    device='cpu' to run the plain PyTorch versions of every kernel."""
    cfg, dtype, quantization, offload = _v1_config(config, dtype, quantization, offload)
    return InferenceEngine(model_config, params, InferenceConfig(**cfg), dtype,
                           device=device, quantization=quantization, offload=offload)


# DeepSpeed v1 keys that choose CUDA kernels or graphs there: the port's
# kernels and warmup()'s graphs are always its serving path
_V1_NOOPS = ("replace_with_kernel_inject", "replace_method", "enable_cuda_graph",
             "triangular_masking", "use_triton", "triton_autotune")


def _v1_dtype(dt) -> Tuple[torch.dtype, bool]:
    """A v1 `dtype` (a string, a torch or numpy dtype) -> (serving dtype,
    whether it asks for int8 weights). f16 serves bf16 and f64 serves f32,
    as in the JAX package; anything else raises ValueError."""
    try:
        name = np.dtype(dt).name
    except TypeError:  # strings ("fp16") and torch dtypes ("torch.float16")
        name = str(dt).split(".")[-1].lower()
    if name == "int8":
        return torch.bfloat16, True
    if name in ("float16", "fp16", "half", "bfloat16", "bf16"):
        return torch.bfloat16, False
    if name in ("float32", "fp32", "float", "float64", "double"):
        return torch.float32, False
    raise ValueError(f"unsupported inference dtype {dt!r}")


def _v1_config(config, dtype, quantization, offload):
    """Translate DeepSpeed's v1 inference keys (the JAX package's
    init_inference, deepspeed_tpu/inference/engine.py:1826-1925) into
    (InferenceConfig keys, dtype, quantization, offload)."""
    cfg = dict(config or {})
    if "checkpoint" in cfg:
        raise NotImplementedError(
            "config['checkpoint']: the port loads no checkpoint in init_inference; read the "
            "weights with the JAX package's init_inference_from_hf route (HF safetensors/bin) "
            "or the training engine's checkpoint, convert them (utils/convert.py "
            "params_from_numpy) and pass them as params")
    if "injection_policy" in cfg or "injection_policy_tuple" in cfg:
        raise NotImplementedError(
            "injection_policy: sharding is a rules table, not module surgery; the port "
            "serves one GPU until the multi-GPU slice (ROADMAP A11)")
    dt = cfg.pop("dtype", None)
    if dt is not None:
        dtype, int8 = _v1_dtype(dt)
        if int8:  # weight-only int8 PTQ is the int8 serving path
            quantization = quantization or {"bits": 8, "group_size": 128}
    if "max_out_tokens" in cfg:
        mot = int(cfg.pop("max_out_tokens"))
        if "max_seq_len" in cfg and int(cfg["max_seq_len"]) != mot:
            raise ValueError(f"conflicting max_out_tokens ({mot}) and max_seq_len "
                             f"({cfg['max_seq_len']}) in the inference config; drop one")
        cfg["max_seq_len"] = mot
    for noop in _V1_NOOPS:
        if cfg.pop(noop, None):
            log_dist(f"inference config '{noop}' is a no-op here (the port's hand-written "
                     "kernels and warmup()'s CUDA graphs are always the serving path)",
                     ranks=[0])
    tp = cfg.pop("tensor_parallel", None)
    if tp is not None:
        if isinstance(tp, dict):
            size = int(tp.get("tp_size", 1)) if tp.get("enabled", True) else 1
        else:
            size = int(tp)
        if "tp_size" in cfg and int(cfg["tp_size"]) != size:
            raise ValueError(f"conflicting tensor_parallel ({size}) and tp_size "
                             f"({cfg['tp_size']}) in the inference config; drop one")
        cfg["tp_size"] = size
    if "offload" in cfg:
        off = cfg.pop("offload")
        if offload is not None and offload != off:
            raise ValueError("conflicting offload in config and kwarg")
        offload = off
    return cfg, dtype, quantization, offload
