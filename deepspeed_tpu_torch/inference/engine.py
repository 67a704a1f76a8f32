"""Inference engine: continuous batching over a paged KV cache.

Counterpart of deepspeed_tpu/inference/engine.py (FastGen's
InferenceEngineV2: put / query / flush). The host-side control plane is
the reference's: prompts and decode batches are padded to power-of-two
buckets, concurrent prefills run as waves of one bucket each, decode rows
of all in-flight sequences advance in one forward per put(), and all
raggedness lives in the StateManager (inference/ragged.py), so the device
only sees dense token buffers, block tables and context lengths.

PyTorch runs eagerly: a "compiled program" of the JAX engine is a plain
call of the inference/model.py functions here, and the KV cache is
updated in place instead of being donated and returned.

This slice serves greedy logits on one GPU, from bf16/f32 or int8 KV
pools (kv_cache_dtype="int8"), for dense, sliding-window and block-sparse
models. Sampling, generate(), quantized weights,
offload, tensor parallelism, KV export and import and warmup raise
NotImplementedError naming the slice that brings them.
"""

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config.config import PrefixCacheConfig, check_field_types
from ..models import transformer as T
from ..platform.accelerator import resolve_device
from ..utils.logging import log_dist
from . import model as M
from .ragged import StateManager

_LATER = {
    "sampling": "the slice that ports inference/sampling.py",
    "quantization": "the slice that ports inference/quantization.py",
    "offload": "the slice that ports the offload tiers",
    "tp": "the multi-GPU slice",
    "kv_transfer": "the slice that ports disaggregated serving",
    "warmup": "the slice that adds CUDA graphs",
}


def _later(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with {_LATER[key]}")


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
        if self.moe_census:
            raise NotImplementedError(
                "moe_census: MoE models are not served by this slice")

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
        utils/convert.params_from_numpy); floating leaves are cast to
        `dtype` and moved to `device` (None = the GPU; raises when absent).
        """
        if quantization:
            raise _later("weight quantization", "quantization")
        if offload is not None:
            raise _later("offload serving", "offload")
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
        cache_dtype = "int8" if self.kv_quant else str(dtype).split('.')[-1]
        log_dist(
            f"inference engine on {self.device}: {self.config.num_kv_blocks} KV "
            f"blocks x {self.config.kv_block_size} tokens ({self._pool_bytes() / 2**30:.2f} "
            f"GiB {cache_dtype} cache), max_batch {self.config.max_batch_size}",
            ranks=[0])

    def refresh_params(self, params: Any) -> None:
        """(Re)point the served weights: cast floating leaves to the serving
        dtype on the serving device and convert to the serving layout
        (model.prepare: unstacked layers, fused QKV and gate/up)."""
        def cast(x):
            x = torch.as_tensor(x)
            dt = self._dtype if x.is_floating_point() else x.dtype
            return x.to(device=self.device, dtype=dt)

        top = {k: cast(v) for k, v in params.items() if k != "layers"}
        layers = params["layers"]
        if isinstance(layers, dict):
            top["layers"] = {k: cast(v) for k, v in layers.items()}
        else:
            top["layers"] = [{k: cast(v) for k, v in lp.items()} for lp in layers]
        self.params = M.prepare(top, self.cfg)

    def _dev(self, x) -> torch.Tensor:
        """Host array -> tensor on the serving device."""
        return torch.as_tensor(x, device=self.device)

    def decode_multi_fn(self, s: int, n_steps: int, sampling=None):
        """Greedy fused decode (model.decode_multi) for batch width `s`:
        returns step(params, cache, tokens, tables, ctx) ->
        (generated [n_steps, s] int32, final logits [s, V], cache, None),
        the cache updated in place. Inputs may be numpy arrays or tensors."""
        if sampling is not None:
            raise _later("sampled decode", "sampling")
        cfg = self.cfg

        def step(params, cache, tokens, tables, ctx):
            toks, tbl, cx = (self._dev(a).to(torch.int32) for a in (tokens, tables, ctx))
            if toks.shape[0] != s:
                raise ValueError(f"decode_multi_fn({s}) got {toks.shape[0]} rows")
            return M.decode_multi(params, cache, toks, tbl, cx, cfg, n_steps=n_steps)

        return step

    def _pools(self) -> List[torch.Tensor]:
        """Every per-layer pool of the cache: codes or K/V rows, and the
        scale pools of an int8 cache (part of each page)."""
        c = self.cache
        return c.k + c.v + (c.k_scale + c.v_scale if c.quantized else [])

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
            strict: bool = True) -> Any:
        """Run one engine step over a ragged batch.

        New uids carry their whole prompt; known uids carry one or more
        continuation tokens. Returns next-token logits [len(uids), vocab]
        f32 numpy, in input order.

        strict=True raises BEFORE any state mutation when the batch's new
        prompts do not fit the KV pool. strict=False admits prompts per
        uid while capacity lasts and returns (logits, rejected_uids);
        rejected rows are zeros."""
        if return_tokens or sampling is not None:
            raise _later("on-device token sampling in put()", "sampling")
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
            self._prefill_waves(prefills, out)
        if decodes:
            self._decode_rows(decodes, n_rows, out)
        if not strict:
            return out, rejected
        return out

    def _prefill_waves(self, prefills, out: np.ndarray) -> None:
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
            logits, self.cache = M.prefill_batch(
                self.params, self.cache, self._dev(toks_b), self._dev(n_real),
                self._dev(tables), self.cfg)
            for pos, uid, toks in wave:
                self.state.commit(uid, len(toks), token_ids=toks)
            logits = logits.cpu().numpy()
            for row, (pos, uid, toks) in enumerate(wave):
                out[pos] = logits[row]

    def _decode_rows(self, decodes, n_rows: int, out: np.ndarray) -> None:
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
        logits, self.cache = M.decode_step(
            self.params, self.cache, self._dev(toks), self._dev(tables),
            self._dev(ctx), self.cfg, unique_rows=unique)
        for pos, uid, chunk in decodes:
            self.state.commit(uid, len(chunk), token_ids=chunk)
        logits_np = logits[:n_rows].cpu().numpy()
        for (pos, uid, chunk), lr in zip(decodes, last_row):
            out[pos] = logits_np[lr]

    def flush(self, uid: int) -> None:
        """Free a sequence's KV blocks."""
        self.state.flush(uid)

    # -- later slices -----------------------------------------------------
    def generate(self, *args, **kwargs):
        raise _later("generate()", "sampling")

    def export_kv(self, uid: int):
        raise _later("export_kv()", "kv_transfer")

    def import_kv(self, uid: int, payload):
        raise _later("import_kv()", "kv_transfer")

    def warmup(self, *args, **kwargs):
        raise _later("warmup()", "warmup")


def init_inference(params: Any, model_config: T.TransformerConfig,
                   config: Optional[Dict[str, Any]] = None,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Union[str, torch.device, None] = None,
                   quantization: Optional[Dict[str, Any]] = None,
                   offload: Optional[Dict[str, Any]] = None) -> InferenceEngine:
    """Build the inference engine; config keys follow InferenceConfig
    (an unknown key raises TypeError).

    device=None serves on the GPU and raises when there is none; pass
    device='cpu' to run the plain PyTorch versions of every kernel."""
    return InferenceEngine(model_config, params, InferenceConfig(**(config or {})), dtype,
                           device=device, quantization=quantization, offload=offload)
