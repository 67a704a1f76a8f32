"""Inference-side transformer forward over a paged KV cache.

Counterpart of deepspeed_tpu/inference/model.py. Weights are the SAME
dict as models/transformer.init gives, passed through `prepare()` into the
serving layout:

- layers are unstacked into a Python list of per-layer dicts;
- the Q/K/V projections fuse into one [E, H+2KV, D] weight (`w_qkv`), their
  biases into one [H+2KV, D] (`b_qkv`), and the llama gate/up pair into one
  [E, 2F] weight (`w_gi`): fewer, larger matrix products per layer.

Cache: per layer, K and V arenas [num_blocks, block_size, KV_heads,
head_dim] (one page is a contiguous (block_size, KV, D) tile). Every cache
mutation goes through ops/cuda/paged_attention.py and happens IN PLACE:
where the JAX functions donate the cache and return a new one, these
update the given tensors and return the same PagedCache.

`use_kernel=True` (the serving path) calls the kernel wrappers, which
launch the CUDA kernels for CUDA tensors and run the plain versions for
CPU tensors. `use_kernel=False` calls the plain versions directly on any
device: the reference the kernel path is compared with on the card.

What is served:

- Llama-class models (rotary, RMSNorm, gated MLP, no biases), with sliding
  windows (Mistral-class: every layer's prefill and decode attention
  banded to `cfg.window_for_layer(li)`);
- Bloom-class models (BLOOM, falcon-rw): ALiBi instead of rotary (the
  slopes of `T.model_alibi_slopes`, made once per forward call, bias the flash
  prefill and every decode mode), LayerNorm with its bias, q/k/v, output
  and MLP biases, a non-gated MLP, an embedding LayerNorm after the token
  embedding;
- block-sparse models (attention_impl="sparse": the train-time layout of
  `cfg.sparsity_config()`, reproduced exactly), routed as in the JAX
  package. Prefill runs the block-gather `sparse_causal_attention` when
  the bucket is a multiple of the layout block, else (a bucket shorter
  than a block) dense attention under the layout's token mask; flash is
  not called. Decode gives each row the layout row of its position: as a
  per-cache-block bitmap to the decode kernels when the layout block is a
  multiple of the cache block (`use_kernel`), else as a per-position mask
  to the plain decode attention, the port of the JAX package's XLA route,
  without the fused write. The [nb, nb] layout goes to the device once
  per call (decode_multi once for all its steps), as the ALiBi slopes do;
- Falcon/Phi-class models: the parallel residual x + attn(ln1 x) +
  mlp(ln2 x), with ln2 x replaced by ln1 x under `shared_ln` (Falcon-7B,
  Phi; such layers have no ln2 leaves), in every layer loop; partial
  rotary (`T.rope_dim`); an lm_head bias added to the f32 logits;
  multi-query attention with any query group (Falcon-7B: 71 over one KV
  head) and head_dim 80 (Phi-2) in every kernel;
- GPT-NeoX- and GPT-J-class models: the same parallel residual (two
  LayerNorms: GPT-NeoX; one shared: GPT-J), partial rotary with
  split-halves pairs (GPT-NeoX) or interleaved ones (GPT-J,
  `rope_interleaved`), head_dim 96 (GPT-NeoX-20B) and 256 (GPT-J-6B) in
  every kernel: #1 at prefill, #4/#5 in every decode mode, #6 bf16 and
  int8;
- in bf16 or f32 caches, or in int8 caches (`init_cache(kv_quant=True)`:
  int8 code pools beside per-layer [NBLK, bs, KV] f32 scale pools, written
  and read only through the int8 kernels);
- with per-channel int8 weights (`quantize_prepared`: inference/
  quantization.py ChannelQuantWeight leaves, the embedding scaled per row):
  every weight product goes through `_wmm`, which on the card is the W8A16
  GEMM (ops/cuda/int8_matmul.py) streaming the codes, with the scale
  applied to its output; the embedding lookup gathers code rows and scales
  them. Groupwise weights (QuantizedWeight) are dequantized by the engine
  before a program runs and reach this module as full-precision tensors,
  except the MoE expert stacks of a per-channel int8 tree (below);
- Mixtral-class MoE models (cfg.n_experts > 0; `_mlp`): an f32 router
  (h.float() @ w_router.float()), the dropless gating authority of
  moe/dropless.py (exact, capacity-free top-k; ties to the lowest expert),
  and either the scan over the experts (the default: every expert's MLP
  over every token, combined by its column of the [T, X] weights) or,
  under cfg.moe_dropless, the ragged wire: sort by expert, three grouped
  GEMMs (w_gate, w_in, w_out; the hand-written kernel of ops/cuda/
  grouped_gemm.py under use_kernel), a weighted combine in ascending
  expert order; PR-MoE's residual expert and mix (`_moe_residual`). In
  the per-channel int8 lane the expert stacks are groupwise int8
  (QuantizedWeight, group 128, as the JAX package's quantize_layer), and
  no bf16 copy of them is made: under use_kernel both paths run them
  through the int8 form of the grouped GEMM (ops/cuda/grouped_gemm.py
  grouped_gemm_int8), which reads the codes and makes each weight, the
  value dequantize_groupwise gives, on its way into the products; the
  scan as three such GEMMs over X segments of all T rows (h repeated X
  times), each expert's weights read once. The plain path (use_kernel
  False) dequantizes where it uses them, one expert at a time in the
  scan, the whole stack before the dropless wire's masked scan, as the
  JAX package does "transiently at use". `census` (an [X] int64
  device tensor) adds each application's per-expert routed-row counts, pad
  rows included, as the JAX package's census_cb reports them.

`check_served` raises for the rest (learned positions, activation
quantization: `T.unported_features`).
"""

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..models import transformer as T
from ..moe.dropless import dropless_apply, dropless_topk_gating, expert_counts
from ..ops.attention import _repeat_kv, causal_attention
from ..ops.cuda.grouped_gemm import grouped_gemm_int8
from ..ops.cuda.int8_matmul import int8_matmul, int8_matmul_plain
from ..ops.cuda.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_int8,
    paged_decode_attention_plain,
    paged_decode_fused,
    paged_decode_fused_int8,
    paged_kv_write,
    paged_kv_write_int8,
    paged_kv_write_plain,
    paged_kv_write_quant_plain,
)
from ..ops.sparse_attention import gather_plan, sparse_causal_attention
from ..ops.quantization import quantize_groupwise
from .quantization import ChannelQuantWeight, QuantizedWeight, _dtype_name, channel_quantize


def check_served(cfg: T.TransformerConfig) -> None:
    """Raise NotImplementedError for a model this slice does not serve."""
    bad = T.unported_features(cfg)
    if bad:
        raise NotImplementedError(
            "the serving slices serve Llama-, Bloom-, Falcon-, Phi-, GPT-NeoX-, GPT-J- and "
            "Mixtral-class models only; "
            f"this config uses {', '.join(bad)} (later slices port them)")


# ---------------------------------------------------------------------------
# serving weight layout
# ---------------------------------------------------------------------------

def is_prepared(params) -> bool:
    return isinstance(params.get("layers"), (list, tuple))


def prepare(params: Dict[str, Any], cfg: T.TransformerConfig) -> Dict[str, Any]:
    """Training layout (layers stacked [L, ...]) -> serving layout (see the
    module docstring). The concatenations copy the weights: call once,
    not per step."""
    if is_prepared(params):
        return params
    out = {k: v for k, v in params.items() if k != "layers"}
    st = params["layers"]
    L = cfg.n_layers
    lead = next(iter(st.values())).shape[0]
    if lead != L:
        raise ValueError(
            f"serving expects flat [n_layers, ...] stacked layers (got leading "
            f"dim {lead} != {L}; merge pipeline partitions before serving)")
    out["layers"] = [prepare_layer({name: w[l] for name, w in st.items()}, cfg)
                     for l in range(L)]
    return out


def prepare_layer(lp: Dict[str, Any], cfg: T.TransformerConfig) -> Dict[str, Any]:
    """One layer's training-layout dict -> serving layout."""
    lp = dict(lp)
    if "wq" in lp:
        lp["w_qkv"] = torch.cat([lp.pop("wq"), lp.pop("wk"), lp.pop("wv")], dim=1)
        if "bq" in lp:
            lp["b_qkv"] = torch.cat([lp.pop("bq"), lp.pop("bk"), lp.pop("bv")], dim=0)
        if cfg.n_experts == 0 and cfg.is_gated and "w_gate" in lp:
            lp["w_gi"] = torch.cat([lp.pop("w_gate"), lp.pop("w_in")], dim=1)
    return lp


# per-layer serving weight name -> how many leading dims its product
# contracts (per-channel quantization; the JAX package's _SERVING_SPECS:
# norm scales, biases, the router and PR-MoE's mixing coefficients stay
# full precision)
_SERVING_SPECS = {"w_qkv": 1, "wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gi": 1, "w_gate": 1,
                  "w_in": 1, "w_out": 1, "wr_in": 1, "wr_gate": 1, "wr_out": 1}
# MoE expert stacks [X, ...]: groupwise int8 (group, bits) in the
# per-channel lane, as the JAX package's quantize_layer parks them
_EXPERT_STACKS = ("w_gate", "w_in", "w_out")
EXPERT_GROUP = 128


def quantize_prepared(prepared: Dict[str, Any], cfg: T.TransformerConfig) -> Dict[str, Any]:
    """Per-channel int8 over the prepared tree (the decode speed path; see
    inference/quantization.py). The embedding quantizes per ROW, so one
    scale serves both the lookup and the tied logits; norm scales, biases
    and the lm_head bias stay full precision. A leaf already quantized
    (a prepared int8 tree carried in whole) is kept."""
    out = dict(prepared)
    if not isinstance(out["embed"], ChannelQuantWeight):
        out["embed"] = channel_quantize(prepared["embed"], 1, scale_first=True)
    if "lm_head" in prepared and not isinstance(out["lm_head"], ChannelQuantWeight):
        out["lm_head"] = channel_quantize(prepared["lm_head"], 1)
    out["layers"] = [quantize_layer(lp, cfg) for lp in prepared["layers"]]
    return out


def quantize_layer(lp: Dict[str, Any], cfg: T.TransformerConfig) -> Dict[str, Any]:
    """Per-channel int8 for one prepared layer (see quantize_prepared): the
    weights of _SERVING_SPECS, each with its contraction's dims. An MoE
    layer's expert stacks take groupwise int8 instead (QuantizedWeight,
    groups of EXPERT_GROUP along the last dim: a per-output-channel scale
    does not survive the stacked expert dim), dequantized where `_mlp`
    uses them: the JAX package's quantize_layer, code for code."""
    check_served(cfg)
    out = {}
    for name, w in lp.items():
        if not isinstance(w, torch.Tensor):
            out[name] = w  # quantized already
        elif cfg.n_experts > 0 and name in _EXPERT_STACKS:
            q, scale = quantize_groupwise(w, EXPERT_GROUP, 8)
            out[name] = QuantizedWeight(q=q, scale=scale, bits=8,
                                        dtype_name=_dtype_name(w))
        elif name in _SERVING_SPECS:
            out[name] = channel_quantize(w, _SERVING_SPECS[name])
        else:
            out[name] = w
    return out


def _wmm(x: torch.Tensor, w, use_kernel: bool, n_contract: int = 1) -> torch.Tensor:
    """x [..., K-dims] times a weight whose leading n_contract dims it
    contracts -> [..., output dims]. A per-channel int8 weight (the JAX
    package's _wmm): codes x in x's dtype, times the scale in x's dtype,
    through the W8A16 GEMM (use_kernel: the kernel for CUDA tensors) or
    its plain version; a full-precision weight: the plain product."""
    if isinstance(w, ChannelQuantWeight):
        K = w.q.shape[1]
        mm = int8_matmul if use_kernel else int8_matmul_plain
        y = mm(x.reshape(-1, K).contiguous(), w.q, w.scale)
        return y.reshape(*x.shape[:x.dim() - n_contract], *w.out_shape)
    if n_contract == 2:
        return torch.einsum("...hd,hde->...e", x, w)
    if w.dim() == 3:
        return torch.einsum("...e,ehd->...hd", x, w)
    return x @ w


def _embed_rows(embed, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of `tokens`; from a per-channel int8 embedding, the
    code rows times their row scales in the serving dtype."""
    idx = tokens.long()
    if isinstance(embed, ChannelQuantWeight):
        dt = embed.dtype
        return embed.q[idx].to(dt) * embed.scale[idx][..., None].to(dt)
    return embed[idx]


def _embed(params, tokens: torch.Tensor, cfg: T.TransformerConfig) -> torch.Tensor:
    """Token embedding rows, through the embedding LayerNorm where the
    model has one (Bloom)."""
    x = _embed_rows(params["embed"], tokens)
    if cfg.embedding_layernorm:
        x = T._norm(x, params["embed_ln_scale"], params.get("embed_ln_bias"), cfg)
    return x


def _alibi(cfg: T.TransformerConfig, device: torch.device) -> Optional[torch.Tensor]:
    """The model's [H] f32 ALiBi slopes on `device`, None without ALiBi.
    The copy to the card waits for the work queued before it, so a forward
    makes them once per call (decode_multi once for all its steps; the
    engine once, at construction, since no such copy may run in a captured
    CUDA graph)."""
    return T.model_alibi_slopes(cfg).to(device) if cfg.alibi else None


# ---------------------------------------------------------------------------
# block-sparse layouts (the JAX package's inference/model.py helpers)
# ---------------------------------------------------------------------------

def _sparsity(cfg: T.TransformerConfig):
    """SparsityConfig of a block-sparse model, else None. Layouts are
    seeded, so serving reproduces the train-time block mask exactly,
    bigbird and variable random blocks included."""
    if cfg.attention_impl != "sparse":
        return None
    return cfg.sparsity_config()


def _sparse_layout(scfg, n_slots: int, device) -> torch.Tensor:
    """The [nb, nb] bool layout covering n_slots positions, on `device`.
    Rows are prefix-stable, so it holds the train-time layout of any
    shorter sequence. The copy to the card waits for the work queued
    before it: a caller makes it once per call (the engine once, at
    construction, as the ALiBi slopes)."""
    nb = -(-n_slots // scfg.block)
    return torch.from_numpy(scfg.layout(nb * scfg.block)).to(device)


def _sparse_prefill_mask(scfg, Tp: int, device) -> torch.Tensor:
    """[Tp, Tp] bool token mask from the block layout, causality
    included."""
    nb = -(-Tp // scfg.block)
    lay = scfg.layout(nb * scfg.block)
    blk = np.arange(Tp) // scfg.block
    mask = lay[np.ix_(blk, blk)] & (np.arange(Tp)[None, :] <= np.arange(Tp)[:, None])
    return torch.from_numpy(mask).to(device)


def _masked_causal_attention(q, k, v, mask):
    """[B, S, H, D] attention under an explicit [S, S] token mask, GQA KV
    heads repeated: the prefill of a sparse model whose bucket is shorter
    than a layout block (the masked-softmax math of
    sparse_causal_attention, without the gather)."""
    D = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, rep), _repeat_kv(v, rep)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) / D ** 0.5).float()
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _sparse_decode_allowed(scfg, positions, n_slots: int, layout=None) -> torch.Tensor:
    """[S, n_slots] bool: the context positions each decode row may attend
    to, from the layout row of the row's own position. `layout`:
    _sparse_layout(scfg, n_slots, positions.device), made here if absent."""
    if layout is None:
        layout = _sparse_layout(scfg, n_slots, positions.device)
    rows = layout[(positions // scfg.block).long()]  # [S, nb]
    kv_blk = torch.arange(n_slots, device=positions.device) // scfg.block
    return rows[:, kv_blk]


def _sparse_decode_allowed_slots(scfg, positions, n_blocks: int, bs: int,
                                 layout=None) -> torch.Tensor:
    """[S, NB] int32 at cache-block granularity: the decode kernels'
    layout bitmap. Exact only when scfg.block % bs == 0, so that every
    cache block lies inside one layout block. `layout`:
    _sparse_layout(scfg, n_blocks * bs, positions.device), made here if
    absent."""
    if layout is None:
        layout = _sparse_layout(scfg, n_blocks * bs, positions.device)
    rows = layout[(positions // scfg.block).long()]  # [S, nb]
    slot_blk = torch.arange(n_blocks, device=positions.device) * bs // scfg.block
    return rows[:, slot_blk].to(torch.int32)


def _lm_logits(x: torch.Tensor, params, cfg: T.TransformerConfig,
               use_kernel: bool = True) -> torch.Tensor:
    """Final-normed activations [.., E] -> f32 logits [.., V]. Tied
    embeddings contract against embed without materialising its
    transpose; an lm_head bias (Phi-2) is added in f32 after the product,
    as the JAX package adds it. A per-channel int8 head (or tied
    embedding): the product in x's dtype, cast to f32, times the f32
    scale (the W8A16 GEMM's f32 form under use_kernel)."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if isinstance(w, ChannelQuantWeight):
        mm = int8_matmul if use_kernel else int8_matmul_plain
        y = mm(x.reshape(-1, x.shape[-1]).contiguous(), w.q, w.scale, out_f32=True)
        y = y.reshape(*x.shape[:-1], y.shape[-1])
    elif cfg.tie_embeddings:
        y = torch.einsum("...e,ve->...v", x, w.to(x.dtype)).float()
    else:
        y = torch.einsum("...e,ev->...v", x, w.to(x.dtype)).float()
    if not cfg.tie_embeddings and "lm_head_b" in params:
        y = y + params["lm_head_b"].float()
    return y


class PagedCache(NamedTuple):
    """Per-layer lists (length n_layers) of [NBLK, bs, KV, D] tensors.

    int8 caches (kv_quant) also carry per-layer [NBLK, bs, KV] f32 scale
    pools: block i's codes dequantize by k_scale[i], so every path that
    moves a page (the COW copy) moves its scales with it."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    k_scale: Optional[List[torch.Tensor]] = None
    v_scale: Optional[List[torch.Tensor]] = None

    @property
    def block_size(self) -> int:
        return self.k[0].shape[1]

    @property
    def num_blocks(self) -> int:
        return self.k[0].shape[0]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(cfg: T.TransformerConfig, num_blocks: int, block_size: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None,
               kv_quant: bool = False) -> PagedCache:
    """Zeroed K and V arenas for every layer. kv_quant=True: int8 zero code
    pools and f32 scale pools filled with ones (as the JAX package
    allocates them), instead of `dtype` arenas."""
    shape = (num_blocks, block_size, cfg.kv_heads, cfg.head_dim)
    L = cfg.n_layers
    pool = torch.int8 if kv_quant else dtype
    k = [torch.zeros(shape, dtype=pool, device=device) for _ in range(L)]
    v = [torch.zeros(shape, dtype=pool, device=device) for _ in range(L)]
    if not kv_quant:
        return PagedCache(k=k, v=v)
    ones = lambda: torch.ones(shape[:3], dtype=torch.float32, device=device)
    return PagedCache(k=k, v=v, k_scale=[ones() for _ in range(L)],
                      v_scale=[ones() for _ in range(L)])


def _write_kv(cache: PagedCache, li: int, k_new, v_new, flat_idx, use_kernel: bool):
    """Write layer li's new [T, KV, D] rows at flat slots [T], in place. On
    an int8 cache they are quantized (quantize_kv_rows, the one rounding
    rule) and codes and scales are written, one kernel launch on the card:
    the JAX package's _write_kv_quant."""
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    if cache.quantized:
        write = paged_kv_write_int8 if use_kernel else paged_kv_write_quant_plain
        write(cache.k[li], cache.v[li], cache.k_scale[li], cache.v_scale[li], k_new, v_new,
              flat_idx)
    else:
        write = paged_kv_write if use_kernel else paged_kv_write_plain
        write(cache.k[li], cache.v[li], k_new, v_new, flat_idx)


def _expert(w, e: int, dtype: torch.dtype) -> torch.Tensor:
    """Expert e's weight of a stack [X, ...] in `dtype`; a groupwise int8
    stack dequantizes that expert's slice alone (the same values as the
    whole stack's dequant, a 1/X of its transient memory)."""
    if isinstance(w, QuantizedWeight):
        w = QuantizedWeight(q=w.q[e], scale=w.scale[e], bits=w.bits,
                            dtype_name=w.dtype_name).dequantize()
    else:
        w = w[e]
    return w.to(dtype)


def _moe_mlp(h: torch.Tensor, lp, cfg: T.TransformerConfig, use_kernel: bool,
             census: Optional[torch.Tensor]) -> torch.Tensor:
    """The MoE FFN over [T, E] tokens (the JAX package's _mlp MoE branch):
    the f32 router, the dropless gating authority, then the dropless wire
    (cfg.moe_dropless) or the scan over the experts; PR-MoE's residual.
    Nothing reads the device from the host, so a CUDA graph captures it."""
    act = T._act_fn(cfg)
    X = cfg.n_experts
    T_ = h.shape[0]
    logits = h.float() @ lp["w_router"].float()
    idx, wts, _, _ = dropless_topk_gating(logits, cfg.moe_top_k)  # eval gate: no noise
    counts = expert_counts(idx, X)
    if census is not None:
        census.add_(counts)
    if cfg.moe_dropless:
        # one grouped GEMM a projection over the expert-sorted rows (an int8
        # stack goes to the kernel's int8 form as it is)
        out = dropless_apply(
            h, idx, wts, counts, lp["w_in"], lp["w_out"],
            w_gate=lp["w_gate"] if cfg.is_gated else None,
            b_in=lp.get("b_in"), b_out=lp.get("b_out"), act=act,
            impl="ragged" if use_kernel else "dense")
        return _moe_residual(out, h, lp, cfg, act, use_kernel)
    # the combine weights [T, X] of the top-k decisions, one column an expert
    weights = torch.zeros((T_, X), dtype=torch.float32, device=h.device).scatter_(1, idx, wts)
    wcols = weights.t().to(h.dtype)
    has_bias = "b_in" in lp
    if use_kernel and isinstance(lp["w_in"], QuantizedWeight) and lp["w_in"].bits == 8:
        ys = _scan_int8(h, lp, cfg, act)  # the int8 stacks as the int8 grouped GEMM reads them
        out = torch.zeros_like(h)
        for e in range(X):
            out = out + wcols[e][:, None] * ys[e * T_:(e + 1) * T_]
        return _moe_residual(out, h, lp, cfg, act, use_kernel)
    out = torch.zeros_like(h)
    for e in range(X):
        w_in, w_out = _expert(lp["w_in"], e, h.dtype), _expert(lp["w_out"], e, h.dtype)
        if cfg.is_gated:
            inner = act(h @ _expert(lp["w_gate"], e, h.dtype)) * (h @ w_in)
            y = inner @ w_out
        else:
            inner = h @ w_in
            if has_bias:
                inner = inner + lp["b_in"][e].to(h.dtype)
            y = act(inner) @ w_out
            if has_bias:
                y = y + lp["b_out"][e].to(h.dtype)
        out = out + wcols[e][:, None] * y
    return _moe_residual(out, h, lp, cfg, act, use_kernel)


def _scan_int8(h: torch.Tensor, lp, cfg: T.TransformerConfig, act) -> torch.Tensor:
    """Every expert's MLP over every token on groupwise int8 stacks: the
    scan's products as three int8 grouped GEMMs over X segments of all T
    rows (h repeated X times, segment e expert e's), so each expert's codes
    are read once and no bf16 weight is written. Returns the experts'
    outputs [X * T, E], expert e's in rows e T .. (e + 1) T - 1, each with
    the arithmetic of the scan's step e (biases in h's dtype)."""
    X, T_ = cfg.n_experts, h.shape[0]
    xs = h.repeat(X, 1)
    counts = torch.full((X,), T_, dtype=torch.int32, device=h.device)
    bias = lambda name: lp[name].to(h.dtype).repeat_interleave(T_, dim=0)

    def mm(a, name):
        w = lp[name]
        return grouped_gemm_int8(a, w.q, w.scale, counts, w.dtype)

    if cfg.is_gated:
        return mm(act(mm(xs, "w_gate")) * mm(xs, "w_in"), "w_out")
    inner = mm(xs, "w_in")
    if "b_in" in lp:
        inner = inner + bias("b_in")
    ys = mm(act(inner), "w_out")
    return ys + bias("b_out") if "b_out" in lp else ys


def _moe_residual(out: torch.Tensor, h: torch.Tensor, lp, cfg: T.TransformerConfig, act,
                  use_kernel: bool) -> torch.Tensor:
    """PR-MoE's serving tail: the dense residual expert and the learned
    mix, out * c0 + dense * c1 with c = softmax(h @ w_coef + b_coef) in f32
    (the JAX package's _moe_residual). No-op unless cfg.moe_use_residual."""
    if not cfg.moe_use_residual:
        return out
    mm = lambda a, name: _wmm(a, lp[name], use_kernel)
    if cfg.is_gated:
        inner = act(mm(h, "wr_gate")) * mm(h, "wr_in")
    else:
        inner = mm(h, "wr_in")
        if "br_in" in lp:
            inner = inner + lp["br_in"].to(h.dtype)
        inner = act(inner)
    dense = mm(inner, "wr_out")
    if "br_out" in lp:
        dense = dense + lp["br_out"].to(h.dtype)
    coef = torch.softmax(h.float() @ lp["w_coef"].float() + lp["b_coef"].float(), dim=-1)
    return out * coef[:, 0:1].to(h.dtype) + dense * coef[:, 1:2].to(h.dtype)


def _mlp(h: torch.Tensor, lp, cfg: T.TransformerConfig, use_kernel: bool = True,
         census: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FFN over [T, E] tokens. Dense: gated (with the fused [E, 2F]
    gate|up weight when the prepared layout carries it) or not, with the
    biases the layer has; as in the JAX package, a gated MLP takes only
    b_out. MoE: `_moe_mlp`, whose routed-row counts `census` adds up."""
    if cfg.n_experts > 0:
        return _moe_mlp(h, lp, cfg, use_kernel, census)
    act = T._act_fn(cfg)
    mm = lambda a, name: _wmm(a, lp[name], use_kernel)
    if not cfg.is_gated:
        inner = mm(h, "w_in")
        if "b_in" in lp:
            inner = inner + lp["b_in"]
        inner = act(inner)
    elif "w_gi" in lp:
        gi = mm(h, "w_gi")
        F_ = gi.shape[-1] // 2
        inner = act(gi[:, :F_]) * gi[:, F_:]
    else:
        inner = act(mm(h, "w_gate")) * mm(h, "w_in")
    out = mm(inner, "w_out")
    return out + lp["b_out"] if "b_out" in lp else out


def _attn_out(att: torch.Tensor, lp, use_kernel: bool = True) -> torch.Tensor:
    """Attention output [..., H, D] -> its residual delta [..., E], with
    the output bias where the layer has one."""
    out = _wmm(att, lp["wo"], use_kernel, n_contract=2)
    return out + lp["bo"] if "bo" in lp else out


def _residual(x: torch.Tensor, h1: torch.Tensor, att_out: torch.Tensor, lp,
              cfg: T.TransformerConfig, use_kernel: bool = True,
              census: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer's output from its input x [T, E] (any leading dims), its
    normed input h1 = ln1(x) and its attention delta: sequential, x + a +
    mlp(ln2(x + a)); parallel (Falcon, Phi), x + a + mlp(ln2(x)), with
    ln2(x) replaced by h1 under shared_ln (the JAX package's
    inference/model.py layer body, summed in its order)."""
    if cfg.parallel_residual:
        h2 = h1 if cfg.shared_ln else T._norm(x, lp["ln2_scale"], lp.get("ln2_bias"), cfg)
        return x + att_out + _mlp(h2.reshape(-1, h2.shape[-1]), lp, cfg,
                                  use_kernel, census).reshape(x.shape)
    x = x + att_out
    h2 = T._norm(x, lp["ln2_scale"], lp.get("ln2_bias"), cfg)
    return x + _mlp(h2.reshape(-1, h2.shape[-1]), lp, cfg, use_kernel,
                    census).reshape(x.shape)


def _decode_attention(cache: PagedCache, li: int, q, tables, ctx, use_kernel: bool,
                      window: int = 0, k_new=None, v_new=None, slots=None, alibi=None,
                      allowed_slots=None, allowed=None):
    """Layer li's decode attention over the last `window` positions of each
    row's context (0 = all of it), ALiBi-biased by the [H] slopes `alibi`
    when given (slope_h * key position), restricted to the table slots of
    the [S, NB] int32 layout bitmap `allowed_slots` (the kernels) or to
    the positions of the [S, NB * bs] mask `allowed` (the plain version,
    on any device: the JAX package's XLA route, which the configuration
    chooses when the layout is finer than the cache block). k_new/v_new/
    slots given selects the fused write+attend kernel (single-token rows
    of distinct sequences; the layer's pools hold the pre-write arenas and
    are written in place). Otherwise the new rows were written before the
    call and the plain-mode kernel attends over ctx. int8 pools take the
    int8 kernels; as in the JAX package they never reach
    paged_decode_fused, which is bf16 only."""
    ck, cv = cache.k[li], cache.v[li]
    q = q.contiguous()  # without rope, a view into the fused q/k/v product
    scales = (cache.k_scale[li], cache.v_scale[li]) if cache.quantized else ()
    if k_new is not None:
        fused = paged_decode_fused_int8 if scales else paged_decode_fused
        return fused(q, ck, cv, tables, ctx, k_new.contiguous(), v_new.contiguous(), slots,
                     *scales, window=window, alibi_slopes=alibi,
                     allowed_slots=allowed_slots)[0]
    if not use_kernel or allowed is not None:
        return paged_decode_attention_plain(q, ck, cv, tables, ctx, *scales, window=window,
                                            alibi_slopes=alibi, allowed=allowed)
    kernel = paged_decode_attention_int8 if scales else paged_decode_attention
    return kernel(q, ck, cv, tables, ctx, *scales, window=window, alibi_slopes=alibi,
                  allowed_slots=allowed_slots)


def _qkv(h1: torch.Tensor, lp, cfg: T.TransformerConfig, use_kernel: bool = True):
    """[..., E] -> q [..., H, D], k and v [..., KV, D] (v contiguous; q and
    k are views of the product until rope copies them), with the q/k/v
    biases where the layer has them. A layer in the split form (wq, wk,
    wv: a prepared tree from elsewhere) takes three products."""
    if "w_qkv" not in lp:
        out = []
        for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
            y = _wmm(h1, lp[w], use_kernel)
            out.append(y + lp[b] if b in lp else y)
        return out[0], out[1], out[2].contiguous()
    H, KV = cfg.n_heads, cfg.kv_heads
    qkv = _wmm(h1, lp["w_qkv"], use_kernel)
    if "b_qkv" in lp:
        qkv = qkv + lp["b_qkv"]
    q, k, v = torch.split(qkv, [H, KV, KV], dim=-2)
    return q, k, v.contiguous()


# ---------------------------------------------------------------------------
# decode: a batch of sequences, one new token each
# ---------------------------------------------------------------------------

def decode_step(params, cache: PagedCache, tokens, tables, ctx_lens,
                cfg: T.TransformerConfig, use_kernel: bool = True,
                unique_rows: bool = False, alibi: Optional[torch.Tensor] = None,
                layout: Optional[torch.Tensor] = None, census: Optional[torch.Tensor] = None):
    """tokens [S] int32, tables [S, NB] int32, ctx_lens [S] int32 (context
    length INCLUDING the new token) -> (logits [S, V] f32, cache).

    The cache is updated in place and returned as given. Rows with
    ctx_lens == 0 are batch padding: their KV write is dropped and their
    logits are garbage the caller slices off.

    unique_rows=True asserts every row is a distinct sequence (no
    chunked-continuation rows sharing a block table): with use_kernel it
    selects the fused write+attend kernel, one launch per layer instead
    of two. The caller must point padding rows' tables at a reserved
    scratch block (the engine's pad_block).

    alibi: the model's ALiBi slopes on the device, when the caller made
    them already (decode_multi); None makes them here. layout: likewise a
    block-sparse model's [nb, nb] layout over the table's positions
    (_sparse_layout). A sparse model's decode attention takes the kernels'
    layout bitmap when use_kernel and the layout block is a multiple of
    the cache block, else the per-position mask and no fused write (the
    JAX package's routing). census: an MoE model's [X] int64 expert census,
    added to in every layer (every row, pad rows included)."""
    if not is_prepared(params):
        params = prepare(params, cfg)
    bs = cache.block_size
    NB = tables.shape[1]
    valid = ctx_lens > 0
    positions = (ctx_lens - 1).clamp(min=0)  # [S] this token's position
    x = _embed(params, tokens, cfg)  # [S, E]
    scfg = _sparsity(cfg)
    allowed = allowed_slots = None
    if scfg is not None:
        if layout is None:
            layout = _sparse_layout(scfg, NB * bs, x.device)
        if use_kernel and scfg.block % bs == 0:
            # cache blocks nest inside layout blocks: the kernels skip
            # whole blocks, exactly; one bitmap serves every layer
            allowed_slots = _sparse_decode_allowed_slots(scfg, positions, NB, bs, layout)
        else:
            allowed = _sparse_decode_allowed(scfg, positions, NB * bs, layout)
    fuse_write = unique_rows and use_kernel and allowed is None
    rope = T._rope_tables(positions, cfg) if cfg.use_rope else None
    if alibi is None:
        alibi = _alibi(cfg, x.device)
    # per-row flat slot; padding rows get -1 (dropped)
    blk = tables.gather(1, (positions // bs).clamp(max=NB - 1).long()[:, None])[:, 0]
    flat_idx = torch.where(valid, blk * bs + positions % bs,
                           torch.full_like(positions, -1)).to(torch.int32)

    for li, lp in enumerate(params["layers"]):
        h1 = T._norm(x, lp["ln1_scale"], lp.get("ln1_bias"), cfg)
        q, k, v = _qkv(h1, lp, cfg, use_kernel)
        if rope is not None:
            q = T._rope_at(q, rope, cfg)
            k = T._rope_at(k, rope, cfg)
        window = cfg.window_for_layer(li)
        if fuse_write:
            att = _decode_attention(cache, li, q, tables, ctx_lens, use_kernel, window,
                                    k_new=k, v_new=v, slots=flat_idx, alibi=alibi,
                                    allowed_slots=allowed_slots)
        else:
            _write_kv(cache, li, k, v, flat_idx, use_kernel)
            att = _decode_attention(cache, li, q, tables, ctx_lens, use_kernel, window,
                                    alibi=alibi, allowed_slots=allowed_slots, allowed=allowed)
        x = _residual(x, h1, _attn_out(att, lp, use_kernel), lp, cfg, use_kernel, census)

    x = T._norm(x, params["ln_f_scale"], params.get("ln_f_bias"), cfg)
    return _lm_logits(x, params, cfg, use_kernel), cache


def decode_multi(params, cache: PagedCache, tokens, tables, ctx_lens,
                 cfg: T.TransformerConfig, n_steps: int, use_kernel: bool = True,
                 unique_rows: bool = True, sampling=None, keys=None, step0=None,
                 presence=None, alibi: Optional[torch.Tensor] = None,
                 layout: Optional[torch.Tensor] = None, census: Optional[torch.Tensor] = None):
    """Multi-token decode: n_steps decode_steps in a Python loop (the JAX
    package's lax.scan), each step's token fed back as the next input and
    ctx advanced by one. Block tables must already cover ctx_lens +
    n_steps positions. Rows are distinct sequences, so the fused
    write+attend kernel applies. Nothing in the loop waits for the host:
    the engine captures the whole call as one CUDA graph.

    sampling: an inference/sampling.py SamplingConfig (None = greedy
    argmax), drawing step i of row s with keys[s] ([S, 2] int64) at
    counter step0[s] + i ([S] int32); presence [S, V] uint8 (the
    repetition penalty's seen tokens) is updated with each step's tokens
    as max(presence, one_hot(token)). alibi and layout: as decode_step,
    made here once for all steps when not given; census as decode_step.

    Returns (generated [n_steps, S] int32, final logits [S, V] f32, cache,
    final presence or None)."""
    from .sampling import sample_tokens, update_presence

    if not is_prepared(params):
        params = prepare(params, cfg)
    S = tokens.shape[0]
    toks, ctx = tokens, ctx_lens
    logits = torch.zeros((S, cfg.vocab_size), dtype=torch.float32, device=tokens.device)
    if alibi is None:
        alibi = _alibi(cfg, tokens.device)
    scfg = _sparsity(cfg)
    if scfg is not None and layout is None:
        layout = _sparse_layout(scfg, tables.shape[1] * cache.block_size, tokens.device)
    gen = []
    for i in range(n_steps):
        logits, cache = decode_step(params, cache, toks, tables, ctx, cfg, use_kernel,
                                    unique_rows=unique_rows, alibi=alibi, layout=layout,
                                    census=census)
        if sampling is None:
            toks = logits.argmax(dim=-1).to(torch.int32)
        else:
            toks = sample_tokens(logits, sampling, keys, None if step0 is None else step0 + i,
                                 presence=presence)
        if presence is not None:
            presence = update_presence(presence, toks)
        gen.append(toks)
        ctx = ctx + 1
    gen = (torch.stack(gen) if gen else
           torch.empty((0, S), dtype=torch.int32, device=tokens.device))
    return gen, logits, cache, presence


# ---------------------------------------------------------------------------
# prefill: a batch of whole prompts
# ---------------------------------------------------------------------------

def prefill_batch(params, cache: PagedCache, tokens, n_real, tables,
                  cfg: T.TransformerConfig, use_kernel: bool = True,
                  census: Optional[torch.Tensor] = None):
    """Cross-prompt batched prefill: tokens [B, Tp] int32 (padded), n_real
    [B] int32, tables [B, NB] int32 -> (last-real-token logits [B, V] f32,
    cache). Attention over each prompt is causal flash (a block-sparse
    model: the block gather when Tp is a multiple of the layout block, else
    dense attention under the layout's token mask); the new KV rows of
    every prompt scatter into the paged cache in one write per layer, in
    place. Rows with n_real == 0 are batch padding (garbage logits, their
    KV writes dropped). census: as decode_step (all B * Tp rows count)."""
    B, Tp = tokens.shape
    if not is_prepared(params):
        params = prepare(params, cfg)
    KV, D = cfg.kv_heads, cfg.head_dim
    bs = cache.block_size
    NB = tables.shape[1]
    positions = torch.arange(Tp, dtype=torch.int32, device=tokens.device)
    x = _embed(params, tokens, cfg)  # [B, Tp, E]

    # per-row flat cache slots for the real tokens; -1 rows drop
    blk_idx = (positions // bs).clamp(max=NB - 1).long()[None, :].expand(B, Tp)
    slots = tables.gather(1, blk_idx) * bs + positions[None, :] % bs
    flat_idx = torch.where(positions[None, :] < n_real[:, None], slots,
                           torch.full_like(slots, -1)).reshape(B * Tp).to(torch.int32)

    rope = T._rope_tables(positions, cfg) if cfg.use_rope else None
    alibi = _alibi(cfg, x.device)
    scfg = _sparsity(cfg)
    plan = mask = None  # made once for all layers
    if scfg is not None and Tp % scfg.block == 0:
        plan = gather_plan(scfg, Tp, x.device)
    elif scfg is not None:
        mask = _sparse_prefill_mask(scfg, Tp, x.device)
    for li, lp in enumerate(params["layers"]):
        h1 = T._norm(x, lp["ln1_scale"], lp.get("ln1_bias"), cfg)
        q, k, v = _qkv(h1, lp, cfg, use_kernel)
        if rope is not None:
            q = T._rope_at(q, rope, cfg)
            k = T._rope_at(k, rope, cfg)
        # the prompt attends over its own full-precision k/v; only the
        # resident copy is quantized on int8 pools
        _write_kv(cache, li, k.reshape(B * Tp, KV, D), v.reshape(B * Tp, KV, D), flat_idx,
                  use_kernel)
        if plan is not None:  # FLOPs and bytes scale with the layout's density
            rep = q.shape[2] // k.shape[2]
            att = sparse_causal_attention(q, _repeat_kv(k, rep), _repeat_kv(v, rep), scfg,
                                          plan)
        elif mask is not None:  # a bucket shorter than a layout block
            att = _masked_causal_attention(q, k, v, mask)
        else:
            att = causal_attention(q, k, v, use_flash=use_kernel,
                                   window=cfg.window_for_layer(li), alibi=alibi)
        x = _residual(x, h1, _attn_out(att, lp, use_kernel), lp, cfg, use_kernel, census)

    # logits for each prompt's last REAL token only: gather before the
    # vocab product so the head runs on B tokens, not B * Tp
    last = (n_real - 1).clamp(min=0).long()
    x_last = x[torch.arange(B, device=x.device), last]
    x_last = T._norm(x_last, params["ln_f_scale"], params.get("ln_f_bias"), cfg)
    return _lm_logits(x_last, params, cfg, use_kernel), cache
