"""Dropless (capacity-factor-free) MoE routing: the serving subset.

Counterpart of deepspeed_tpu/moe/dropless.py (MegaBlocks-style routing,
Gale et al., arXiv 2211.15841). Tokens are sorted by expert id and the
expert FFN runs as a grouped GEMM over the sorted assignment buffer: no
token is dropped and no expert slot is padded, whatever the routing skew.

Ported here: the gating authority (`dropless_topk_gating`, with the router
z-loss and the load-balance loss), `expert_counts`, `sort_by_expert`,
`grouped_mm` and the ragged wire (`dropless_apply`), which the serving
engine runs inside its forward (inference/model.py `_mlp`). The a2a wire
and `dropless_moe_ffn` (expert-parallel training) come with MoE training
(ROADMAP A2/A13).

`grouped_mm`'s "ragged" route is the hand-written grouped GEMM
(ops/cuda/grouped_gemm.py, csrc/grouped_gemm.cu) where the JAX package
calls jax.lax.ragged_dot; on CPU tensors its wrapper runs the plain
version, which is the "dense" route: the masked scan over the experts, the
JAX package's oracle. A groupwise int8 stack (QuantizedWeight, bits 8: the
per-channel int8 lane's expert stacks) goes to the kernel's int8 form,
which dequantizes in its loads; the JAX package dequantizes such a stack
before ragged_dot, and the "dense" route does so here.

Bit-level choices that follow the JAX package:
- top-k takes the lowest expert index on ties (lax.top_k): a stable
  descending sort, not torch.topk;
- the sort by expert is stable (jnp.argsort(..., stable=True));
- the combine adds each token's K weighted rows in ascending expert order,
  the order in which jax.ops.segment_sum meets them in the sorted buffer,
  through the inverse permutation: no atomics, so two launches and a
  replayed CUDA graph give the same bits as an eager run.
Nothing here reads a tensor on the host, so the whole path runs inside a
captured CUDA graph.
"""

from typing import Callable, Optional, Tuple

import torch

from ..inference.quantization import QuantizedWeight
from ..ops.cuda.grouped_gemm import grouped_gemm, grouped_gemm_int8, grouped_gemm_plain
from .sharded_moe import _apply_noise, _load_balance_loss, _one_hot


def router_z_loss(logits: torch.Tensor) -> torch.Tensor:
    """ST-MoE router z-loss: mean over tokens of logsumexp(logits)^2
    (arXiv 2202.08906 eq. 5)."""
    return torch.logsumexp(logits.float(), dim=-1).square().mean()


def dropless_topk_gating(logits: torch.Tensor, top_k: int,
                         rng: Optional[torch.Generator] = None,
                         noisy_gate_policy: Optional[str] = None,
                         renormalize: Optional[bool] = None):
    """Capacity-free top-k gate (any k; math in f32).

    logits [T, X]. Selection runs on the noised logits, combine weights
    come from the clean softmax. renormalize: None = (top_k > 1): raw
    softmax mass at k = 1 (Switch), the k weights renormalized to sum 1
    for k > 1 (GShard).

    Returns (expert_idx [T, K] int64, weights [T, K] f32, l_aux, z_loss);
    ties select the lowest expert index, as lax.top_k."""
    T_, X = logits.shape
    if not 1 <= top_k <= X:
        raise ValueError(f"moe top_k must be in [1, {X}] for {X} experts, got {top_k}")
    if renormalize is None:
        renormalize = top_k > 1
    logits = logits.float()
    gates = torch.softmax(logits, dim=-1)
    z_loss = router_z_loss(logits)
    noisy = _apply_noise(logits, rng, noisy_gate_policy)
    idx = torch.sort(noisy, dim=-1, descending=True, stable=True).indices[:, :top_k]
    weights = gates.gather(-1, idx)
    if renormalize:
        weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(
            torch.finfo(torch.float32).eps)
    # load-balance loss over the FIRST choice, as both capacity paths
    l_aux = _load_balance_loss(gates, _one_hot(idx[:, 0], X))
    return idx, weights, l_aux, z_loss


def expert_counts(expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[X] int32 assignment census from [T, K] (or flat) expert ids. A
    compare-and-sum, not bincount: its output size needs no host read."""
    flat = expert_idx.reshape(-1)
    ids = torch.arange(n_experts, device=flat.device, dtype=flat.dtype)
    return (flat[:, None] == ids).sum(dim=0, dtype=torch.int32)


def sort_by_expert(expert_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort of the flat assignment list by expert id.

    expert_idx [T, K] -> (order [A], src [A], sorted_experts [A]), A = T*K:
    `order` permutes the flat (token, choice) slots into expert-contiguous
    runs, `src` is the source token of each sorted slot."""
    K = expert_idx.shape[1]
    flat = expert_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    return order, order // K, flat[order]


def grouped_mm(xs: torch.Tensor, w: torch.Tensor, counts: torch.Tensor,
               impl: str = "auto") -> torch.Tensor:
    """Grouped (ragged) GEMM: rows of xs [A, E] are expert-contiguous
    segments sized by counts [X]; each contracts with its expert's weight
    of w [X, E, F] -> [A, F] in xs's dtype. w is a tensor or a groupwise
    quantized stack (QuantizedWeight), whose weights are its dequantized
    values in its dtype (a 4-bit stack is dequantized first: the kernel's
    int8 form reads 8-bit codes).

    impl: "ragged" (= "auto") is the grouped GEMM kernel for CUDA tensors
    (its int8 form for an int8 stack; the plain versions for CPU tensors);
    "dense" the masked scan over the experts, the plain version on any
    device (the JAX package's oracle)."""
    if impl == "auto":
        impl = "ragged"
    if impl not in ("ragged", "dense"):
        raise ValueError(f"unknown grouped_mm impl {impl!r}")
    if isinstance(w, QuantizedWeight):
        if w.bits == 8 and impl == "ragged":
            return grouped_gemm_int8(xs.contiguous(), w.q.contiguous(), w.scale.contiguous(),
                                     counts.to(torch.int32), w.dtype)
        w = w.dequantize()
    w = w.to(xs.dtype)
    if impl == "ragged":
        return grouped_gemm(xs.contiguous(), w.contiguous(), counts.to(torch.int32))
    return grouped_gemm_plain(xs, w, counts)


def _expert_mlp_sorted(xs, sorted_experts, counts, w_in, w_out, w_gate, b_in, b_out,
                       act: Callable, impl: str):
    """The expert MLP over the expert-sorted assignment buffer."""
    if w_gate is not None:
        inner = act(grouped_mm(xs, w_gate, counts, impl)) * grouped_mm(xs, w_in, counts, impl)
    else:
        inner = grouped_mm(xs, w_in, counts, impl)
        if b_in is not None:
            inner = inner + b_in[sorted_experts].to(xs.dtype)
        inner = act(inner)
    ys = grouped_mm(inner, w_out, counts, impl)
    if b_out is not None:
        ys = ys + b_out[sorted_experts].to(xs.dtype)
    return ys


def _combine(ys: torch.Tensor, order: torch.Tensor, T_: int, K: int) -> torch.Tensor:
    """segment_sum of the weighted sorted rows ys [A, E] back to tokens
    [T, E]: each token's K rows, found through the inverse permutation,
    added in ascending sorted position (= ascending expert id) from 0."""
    A = order.shape[0]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(A, device=order.device, dtype=order.dtype))
    rows = ys[inv.view(T_, K).sort(dim=1).values]  # [T, K, E]
    out = ys.new_zeros((T_, ys.shape[1]))
    for k in range(K):
        out = out + rows[:, k]
    return out


def _ragged_wire(tokens, idx, weights, counts, w_in, w_out, w_gate, b_in, b_out,
                 act: Callable, impl: str):
    """Sort -> grouped GEMM -> weighted combine (the EP=1 / serving wire)."""
    T_, K = idx.shape
    order, src, sorted_experts = sort_by_expert(idx)
    xs = tokens[src]  # [A, E] expert-contiguous
    ys = _expert_mlp_sorted(xs, sorted_experts, counts, w_in, w_out, w_gate, b_in, b_out,
                            act, impl)
    wf = weights.reshape(-1)[order].to(tokens.dtype)
    return _combine(ys * wf[:, None], order, T_, K)


def dropless_apply(tokens, expert_idx, weights, counts, w_in, w_out, w_gate=None,
                   b_in=None, b_out=None, *, act: Callable, impl: str = "auto"):
    """The ragged wire on precomputed routing decisions, the serving entry
    point (inference/model.py _mlp): tokens [T, E], expert_idx [T, K],
    weights [T, K], counts [X] -> [T, E] in tokens' dtype."""
    return _ragged_wire(tokens, expert_idx, weights, counts, w_in, w_out, w_gate, b_in, b_out,
                        act, impl)
