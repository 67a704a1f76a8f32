"""Inference-side transformer forward over a paged KV cache.

Counterpart of deepspeed_tpu/inference/model.py. Weights are the SAME
dict as models/transformer.init gives, passed through `prepare()` into the
serving layout:

- layers are unstacked into a Python list of per-layer dicts;
- the Q/K/V projections fuse into one [E, H+2KV, D] weight (`w_qkv`) and
  the llama gate/up pair into one [E, 2F] weight (`w_gi`): fewer, larger
  matrix products per layer.

Cache: per layer, K and V arenas [num_blocks, block_size, KV_heads,
head_dim] (one page is a contiguous (block_size, KV, D) tile). Every cache
mutation goes through ops/cuda/paged_attention.py and happens IN PLACE:
where the JAX functions donate the cache and return a new one, these
update the given tensors and return the same PagedCache.

`use_kernel=True` (the serving path) calls the kernel wrappers, which
launch the CUDA kernels for CUDA tensors and run the plain versions for
CPU tensors. `use_kernel=False` calls the plain versions directly on any
device: the reference the kernel path is compared with on the card.

This slice serves Llama-class models (rotary, RMSNorm, gated MLP, no
biases) in bf16 or f32 caches; `check_served` raises for the rest.
"""

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from ..models import transformer as T
from ..ops.attention import causal_attention
from ..ops.cuda.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_fused,
    paged_kv_write,
    paged_kv_write_plain,
)


def check_served(cfg: T.TransformerConfig) -> None:
    """Raise NotImplementedError for a model this slice does not serve."""
    bad = T.unported_features(cfg)
    if bad:
        raise NotImplementedError(
            "the first serving slice serves dense Llama-class models only; "
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
        if cfg.n_experts == 0 and cfg.is_gated and "w_gate" in lp:
            lp["w_gi"] = torch.cat([lp.pop("w_gate"), lp.pop("w_in")], dim=1)
    return lp


def _embed_rows(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embed[tokens.long()]


def _lm_logits(x: torch.Tensor, params, cfg: T.TransformerConfig) -> torch.Tensor:
    """Final-normed activations [.., E] -> f32 logits [.., V]. Tied
    embeddings contract against embed without materialising its
    transpose."""
    if cfg.tie_embeddings:
        w = params["embed"].to(x.dtype)
        return torch.einsum("...e,ve->...v", x, w).float()
    return torch.einsum("...e,ev->...v", x, params["lm_head"].to(x.dtype)).float()


class PagedCache(NamedTuple):
    """Per-layer lists (length n_layers) of [NBLK, bs, KV, D] tensors."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]

    @property
    def block_size(self) -> int:
        return self.k[0].shape[1]


def init_cache(cfg: T.TransformerConfig, num_blocks: int, block_size: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None,
               kv_quant: bool = False) -> PagedCache:
    """Zeroed K and V arenas for every layer."""
    if kv_quant:
        raise NotImplementedError(
            "int8 KV pools come with the slice that ports the int8 modes of "
            "paged_decode_attention and paged_scale_write")
    shape = (num_blocks, block_size, cfg.kv_heads, cfg.head_dim)
    L = cfg.n_layers
    return PagedCache(
        k=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(L)],
        v=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(L)])


def _write_kv(cache_k, cache_v, k_new, v_new, flat_idx, use_kernel: bool):
    """Write [T, KV, D] rows into the arenas at flat slots [T], in place."""
    write = paged_kv_write if use_kernel else paged_kv_write_plain
    return write(cache_k, cache_v, k_new.contiguous(), v_new.contiguous(), flat_idx)


def _mlp(h: torch.Tensor, lp, cfg: T.TransformerConfig) -> torch.Tensor:
    """Dense gated FFN over [T, E] tokens with the fused [E, 2F] gate|up
    weight when the prepared layout carries it."""
    act = T._act_fn(cfg)
    if "w_gi" in lp:
        gi = h @ lp["w_gi"]
        F_ = gi.shape[-1] // 2
        inner = act(gi[:, :F_]) * gi[:, F_:]
    else:
        inner = act(h @ lp["w_gate"]) * (h @ lp["w_in"])
    return inner @ lp["w_out"]


def _decode_attention(q, ck, cv, tables, ctx, use_kernel: bool,
                      k_new=None, v_new=None, slots=None):
    """k_new/v_new/slots given selects the fused write+attend kernel
    (single-token rows of distinct sequences; ck/cv hold the pre-write
    arenas and are written in place). Otherwise the new rows were written
    before the call and the plain-mode kernel attends over ctx."""
    if k_new is not None:
        att, _, _ = paged_decode_fused(q, ck, cv, tables, ctx, k_new.contiguous(),
                                       v_new.contiguous(), slots)
        return att
    if use_kernel:
        return paged_decode_attention(q, ck, cv, tables, ctx)
    return paged_decode_attention_plain(q, ck, cv, tables, ctx)


def _qkv(h1: torch.Tensor, lp, cfg: T.TransformerConfig):
    """[..., E] -> q [..., H, D], k and v [..., KV, D] (k, v contiguous)."""
    H, KV = cfg.n_heads, cfg.kv_heads
    qkv = torch.einsum("...e,ehd->...hd", h1, lp["w_qkv"])
    q, k, v = torch.split(qkv, [H, KV, KV], dim=-2)
    return q, k, v.contiguous()


# ---------------------------------------------------------------------------
# decode: a batch of sequences, one new token each
# ---------------------------------------------------------------------------

def decode_step(params, cache: PagedCache, tokens, tables, ctx_lens,
                cfg: T.TransformerConfig, use_kernel: bool = True,
                unique_rows: bool = False):
    """tokens [S] int32, tables [S, NB] int32, ctx_lens [S] int32 (context
    length INCLUDING the new token) -> (logits [S, V] f32, cache).

    The cache is updated in place and returned as given. Rows with
    ctx_lens == 0 are batch padding: their KV write is dropped and their
    logits are garbage the caller slices off.

    unique_rows=True asserts every row is a distinct sequence (no
    chunked-continuation rows sharing a block table): with use_kernel it
    selects the fused write+attend kernel, one launch per layer instead
    of two. The caller must point padding rows' tables at a reserved
    scratch block (the engine's pad_block)."""
    if not is_prepared(params):
        params = prepare(params, cfg)
    bs = cache.block_size
    NB = tables.shape[1]
    valid = ctx_lens > 0
    positions = (ctx_lens - 1).clamp(min=0)  # [S] this token's position
    x = _embed_rows(params["embed"], tokens)  # [S, E]
    fuse_write = unique_rows and use_kernel
    rope = T._rope_tables(positions, cfg)
    # per-row flat slot; padding rows get -1 (dropped)
    blk = tables.gather(1, (positions // bs).clamp(max=NB - 1).long()[:, None])[:, 0]
    flat_idx = torch.where(valid, blk * bs + positions % bs,
                           torch.full_like(positions, -1)).to(torch.int32)

    for li, lp in enumerate(params["layers"]):
        h1 = T._norm(x, lp["ln1_scale"], None, cfg)
        q, k, v = _qkv(h1, lp, cfg)
        q = T._rope_at(q, rope, cfg)
        k = T._rope_at(k, rope, cfg)
        ck, cv = cache.k[li], cache.v[li]
        if fuse_write:
            att = _decode_attention(q, ck, cv, tables, ctx_lens, use_kernel,
                                    k_new=k, v_new=v, slots=flat_idx)
        else:
            _write_kv(ck, cv, k, v, flat_idx, use_kernel)
            att = _decode_attention(q, ck, cv, tables, ctx_lens, use_kernel)
        x = x + torch.einsum("shd,hde->se", att, lp["wo"])
        h2 = T._norm(x, lp["ln2_scale"], None, cfg)
        x = x + _mlp(h2, lp, cfg)

    x = T._norm(x, params["ln_f_scale"], None, cfg)
    return _lm_logits(x, params, cfg), cache


def decode_multi(params, cache: PagedCache, tokens, tables, ctx_lens,
                 cfg: T.TransformerConfig, n_steps: int, use_kernel: bool = True,
                 unique_rows: bool = True, sampling=None):
    """Greedy multi-token decode: n_steps decode_steps in a Python loop
    (the JAX package's lax.scan), each step's argmax fed back as the next
    token and ctx advanced by one. Block tables must already cover
    ctx_lens + n_steps positions. Rows are distinct sequences, so the
    fused write+attend kernel applies.

    Returns (generated [n_steps, S] int32, final logits [S, V], cache,
    None); the last slot mirrors the JAX signature (no presence state)."""
    if sampling is not None:
        raise NotImplementedError(
            "sampled decode comes with the slice that ports inference/sampling.py")
    if not is_prepared(params):
        params = prepare(params, cfg)
    S = tokens.shape[0]
    gen = torch.empty((n_steps, S), dtype=torch.int32, device=tokens.device)
    toks, ctx = tokens, ctx_lens
    logits = torch.zeros((S, cfg.vocab_size), dtype=torch.float32, device=tokens.device)
    for i in range(n_steps):
        logits, cache = decode_step(params, cache, toks, tables, ctx, cfg, use_kernel,
                                    unique_rows=unique_rows)
        toks = logits.argmax(dim=-1).to(torch.int32)
        gen[i] = toks
        ctx = ctx + 1
    return gen, logits, cache, None


# ---------------------------------------------------------------------------
# prefill: a batch of whole prompts
# ---------------------------------------------------------------------------

def prefill_batch(params, cache: PagedCache, tokens, n_real, tables,
                  cfg: T.TransformerConfig, use_kernel: bool = True):
    """Cross-prompt batched prefill: tokens [B, Tp] int32 (padded), n_real
    [B] int32, tables [B, NB] int32 -> (last-real-token logits [B, V] f32,
    cache). Attention over each prompt is causal flash; the new KV rows of
    every prompt scatter into the paged cache in one write per layer, in
    place. Rows with n_real == 0 are batch padding (garbage logits, their
    KV writes dropped)."""
    B, Tp = tokens.shape
    if not is_prepared(params):
        params = prepare(params, cfg)
    KV, D = cfg.kv_heads, cfg.head_dim
    bs = cache.block_size
    NB = tables.shape[1]
    positions = torch.arange(Tp, dtype=torch.int32, device=tokens.device)
    x = _embed_rows(params["embed"], tokens)  # [B, Tp, E]

    # per-row flat cache slots for the real tokens; -1 rows drop
    blk_idx = (positions // bs).clamp(max=NB - 1).long()[None, :].expand(B, Tp)
    slots = tables.gather(1, blk_idx) * bs + positions[None, :] % bs
    flat_idx = torch.where(positions[None, :] < n_real[:, None], slots,
                           torch.full_like(slots, -1)).reshape(B * Tp).to(torch.int32)

    rope = T._rope_tables(positions, cfg)
    for li, lp in enumerate(params["layers"]):
        h1 = T._norm(x, lp["ln1_scale"], None, cfg)
        q, k, v = _qkv(h1, lp, cfg)
        q = T._rope_at(q, rope, cfg)
        k = T._rope_at(k, rope, cfg)
        _write_kv(cache.k[li], cache.v[li], k.reshape(B * Tp, KV, D),
                  v.reshape(B * Tp, KV, D), flat_idx, use_kernel)
        att = causal_attention(q, k, v, use_flash=use_kernel)
        x = x + torch.einsum("bshd,hde->bse", att, lp["wo"])
        h2 = T._norm(x, lp["ln2_scale"], None, cfg)
        x = x + _mlp(h2.reshape(B * Tp, -1), lp, cfg).reshape(x.shape)

    # logits for each prompt's last REAL token only: gather before the
    # vocab product so the head runs on B tokens, not B * Tp
    last = (n_real - 1).clamp(min=0).long()
    x_last = x[torch.arange(B, device=x.device), last]
    x_last = T._norm(x_last, params["ln_f_scale"], None, cfg)
    return _lm_logits(x_last, params, cfg), cache
