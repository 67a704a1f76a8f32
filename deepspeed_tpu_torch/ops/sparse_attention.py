"""Block-sparse attention with static sparsity patterns.

Counterpart of deepspeed_tpu/ops/sparse_attention.py (the reference's
ops/sparse_attention/: sparsity_config.py FixedSparsityConfig,
BigBirdSparsityConfig, BSLongformerSparsityConfig, VariableSparsityConfig
build static [nb, nb] block layouts). The layouts are the JAX package's,
bit for bit: the same numpy code, the bigbird and variable random blocks
drawn from `np.random.default_rng(seed)` in the same order, so a model
trained by the JAX package serves here under the layout it was trained
with.

`sparse_causal_attention` is the block-gather attention of the JAX
package: each query block gathers its active K/V blocks (each row's list
padded to the longest and masked), then one dense f32 softmax runs over
the gathered span with the exact in-block causal mask. It is plain
PyTorch (gather and einsum) on any device, as the JAX function is plain
jnp outside any Pallas kernel; the query blocks are batched instead of
the JAX package's lax.map, in chunks that bound the gathered logits.
"""

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Static block layout spec (the reference's SparsityConfig knobs)."""

    block: int = 64
    # fixed: local window + global prefix; longformer: the same layout
    # family; bigbird: + random earlier blocks; dense: full causal;
    # variable: per-window local sizes + explicit global block indices
    # (unidirectional, as the causal-LM framework needs)
    mode: str = "fixed"
    num_local_blocks: int = 4       # sliding window (fixed/longformer)
    num_global_blocks: int = 1      # leading blocks every row attends to
    num_random_blocks: int = 2      # bigbird/variable random blocks
    local_window_blocks: Tuple[int, ...] = (4,)
    global_block_indices: Tuple[int, ...] = (0,)
    global_block_end_indices: Optional[Tuple[int, ...]] = None
    seed: int = 0

    _MODES = ("fixed", "longformer", "bigbird", "dense", "variable")

    def __post_init__(self):
        if self.mode not in self._MODES:
            raise ValueError(
                f"unknown sparsity mode '{self.mode}' (expected {self._MODES})")
        if self.global_block_end_indices is not None:
            if len(self.global_block_end_indices) != len(self.global_block_indices):
                raise ValueError(
                    "global_block_end_indices must pair 1:1 with "
                    "global_block_indices (ref: VariableSparsityConfig)")
            for s, e in zip(self.global_block_indices, self.global_block_end_indices):
                if s >= e:
                    raise ValueError(f"global block start {s} must be < end {e}")

    def layout(self, seq_len: int) -> np.ndarray:
        """[nb, nb] bool, row q-block -> kv-blocks it may attend to
        (causal: j <= i only). Rows are prefix-stable in nb (serving's
        decode mask relies on it)."""
        assert seq_len % self.block == 0, (seq_len, self.block)
        nb = seq_len // self.block
        lay = np.zeros((nb, nb), bool)
        rng = np.random.default_rng(self.seed)
        if self.mode == "variable":
            return self._variable_layout(nb, lay, rng)
        for i in range(nb):
            if self.mode == "dense":
                lay[i, : i + 1] = True
                continue
            lo = max(0, i - self.num_local_blocks + 1)  # local sliding window
            lay[i, lo: i + 1] = True
            g = min(self.num_global_blocks, i + 1)  # global prefix blocks
            lay[i, :g] = True
            if self.mode == "bigbird" and i > 0:  # random earlier blocks
                k = min(self.num_random_blocks, i)
                picks = rng.choice(i, size=k, replace=False)
                lay[i, picks] = True
        return lay

    def _variable_layout(self, nb: int, lay: np.ndarray,
                         rng: np.random.Generator) -> np.ndarray:
        """VariableSparsityConfig's rule, unidirectional: the window-size
        list applies to consecutive windows (the last size repeats); rows
        from a global block down attend to it."""
        sizes = list(self.local_window_blocks) or [1]
        start = 0
        wi = 0
        while start < nb:  # rows in window [start, end) attend to start..row
            size = sizes[min(wi, len(sizes) - 1)]
            end = min(start + size, nb)
            for i in range(start, end):
                lay[i, start: i + 1] = True
            start = end
            wi += 1
        ends = (self.global_block_end_indices
                if self.global_block_end_indices is not None
                else tuple(g + 1 for g in self.global_block_indices))
        for s, e in zip(self.global_block_indices, ends):
            for c in range(min(s, nb), min(e, nb)):
                lay[c:, c] = True
        # random earlier blocks, drawn row-ascending so the layout stays
        # prefix-stable
        if self.num_random_blocks > 0:
            for i in range(1, nb):
                k = min(self.num_random_blocks, i)
                picks = rng.choice(i, size=k, replace=False)
                lay[i, picks] = True
        return lay


def layout_density(lay: np.ndarray) -> float:
    """Allowed blocks over the causal triangle's."""
    causal_total = lay.shape[0] * (lay.shape[0] + 1) / 2
    return float(lay.sum()) / causal_total


class GatherPlan(NamedTuple):
    """Each query block's K/V blocks: idx [nb, kmax] (padded with 0) and
    ok [nb, bs, kmax, bs], the token mask of every gathered column (the
    in-block causal mask and the padding), on the attention's device."""

    idx: torch.Tensor
    ok: torch.Tensor


def gather_plan(config: SparsityConfig, seq_len: int, device) -> GatherPlan:
    """The gather tables of `sparse_causal_attention` for seq_len tokens.
    Copying them to the card waits for the work queued before the copy, so
    a caller that runs many layers makes them once."""
    bs = config.block
    lay = config.layout(seq_len)
    nb = lay.shape[0]
    kmax = int(lay.sum(axis=1).max())
    idx = np.zeros((nb, kmax), np.int64)
    valid = np.zeros((nb, kmax), bool)
    for i in range(nb):
        js = np.nonzero(lay[i])[0]
        idx[i, : len(js)] = js
        valid[i, : len(js)] = True
    q_pos = np.arange(nb)[:, None] * bs + np.arange(bs)[None, :]  # [nb, bs]
    kv_pos = idx[:, :, None] * bs + np.arange(bs)[None, None, :]  # [nb, kmax, bs]
    ok = (kv_pos[:, None] <= q_pos[:, :, None, None]) & valid[:, None, :, None]
    return GatherPlan(torch.from_numpy(idx).to(device), torch.from_numpy(ok).to(device))


# gathered f32 logits per chunk of query blocks: 2^28 elements (1 GiB)
_CHUNK_LOGITS = 1 << 28


def sparse_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            config: SparsityConfig,
                            plan: Optional[GatherPlan] = None) -> torch.Tensor:
    """[B, S, H, D] x3 -> [B, S, H, D] under the block-sparse layout of
    `config` (S a multiple of its block; k and v with q's heads: callers
    repeat GQA KV heads first). Logits are taken in q's dtype and scaled,
    masked and softmaxed in f32; the probabilities meet V in q's dtype, as
    in the JAX function. `plan`: gather_plan(config, S, q.device), made
    once by a caller that runs many layers."""
    B, S, H, D = q.shape
    bs = config.block
    if plan is None:
        plan = gather_plan(config, S, q.device)
    nb, kmax = plan.idx.shape
    scale = 1.0 / float(np.sqrt(D))
    qb = q.reshape(B, nb, bs, H, D)
    kb = k.reshape(B, nb, bs, H, D)
    vb = v.reshape(B, nb, bs, H, D)
    step = max(1, _CHUNK_LOGITS // (B * H * bs * kmax * bs))
    out = []
    for lo in range(0, nb, step):
        idx, ok = plan.idx[lo: lo + step], plan.ok[lo: lo + step]
        kk = kb[:, idx]  # [B, n, kmax, bs, H, D]
        vv = vb[:, idx]
        logits = torch.einsum("bnqhd,bnkshd->bnhqks", qb[:, lo: lo + step], kk)
        logits = (logits.float() * scale).masked_fill(~ok[None, :, None], float("-inf"))
        n = logits.shape[1]
        p = torch.softmax(logits.reshape(B, n, H, bs, kmax * bs), dim=-1)
        p = p.reshape(logits.shape).to(q.dtype)
        out.append(torch.einsum("bnhqks,bnkshd->bnqhd", p, vv))
    return torch.cat(out, dim=1).reshape(B, S, H, D)
