"""On-device token sampling for the serving engine.

Counterpart of deepspeed_tpu/inference/sampling.py, function for function:
the filter chain (repetition penalty, temperature, top-k, top-p) and the
categorical draw run on the device, so a sampled decode step returns token
ids [S] int32 and never waits for the host; decode_multi runs it inside
its captured CUDA graph.

The draw is the reference's: gumbel-max over the candidate pool,
argmax(pool - log(-log(u))) with u = uniform(fold_in(key_s, t_s), [W],
1e-20, 1) for row s at draw counter t_s, mapped back through the pool's
vocabulary indices. `utils/prng.py` gives JAX's threefry streams bit for
bit, so the same key, counter and logits pick the same token as the JAX
package. Three details make the rest of the arithmetic the reference's:

- the pool is `lax.top_k`'s: value descending, equal values by lower
  index first, and among the values tied at the k-th place the lowest
  indices kept. torch.topk promises no order among ties, so `_top_k` runs
  it on an int64 key that orders every entry totally: the f32 bits mapped
  to an order-preserving integer (-0.0 below +0.0, NaN above inf, as
  XLA's total order has them) in the high word, V - 1 - index in the low;
- argmax returns the first maximum, as `jnp.argmax` does;
- XLA compiles a division by a constant as a multiplication by its f32
  reciprocal (the temperature and the repetition penalty are constants of
  the compiled program), so the chain multiplies by that reciprocal too.

What stays apart is what each library computes in its own rounding: exp,
log, sums and cumulative sums differ in the last bits between XLA, torch on
the CPU and torch on the card. A token can differ only where two
candidates' scores, or a cumulative mass and top_p, lie within those bits.

Keys are the int64 [S, 2] keys of `utils/prng.py`; draw counters are [S]
int32; presence is a [S, V] uint8 bitmap of the tokens each row has seen.
"""

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..utils import prng


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Sampling knobs, fixed for a program (the engine keeps one decode
    program, and on the card one captured graph, per distinct config)."""

    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    cand_width: int = 256  # top-p candidate pool (exactness bound)

    @property
    def greedy(self) -> bool:
        return (not self.do_sample) or self.temperature <= 0.0

    @property
    def needs_presence(self) -> bool:
        return self.repetition_penalty != 1.0

    def key(self):
        return dataclasses.astuple(self)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _recip(x: float) -> float:
    """The f32 reciprocal of x, as XLA folds a division by the constant x."""
    return float(np.float32(1.0) / np.float32(x))


def _penalized(logits: torch.Tensor, cfg: SamplingConfig,
               presence: Optional[torch.Tensor]) -> torch.Tensor:
    """Repetition penalty (CTRL rule: divide positive seen logits,
    multiply negative ones) and temperature, in f32."""
    logits = logits.float()
    if cfg.needs_presence and presence is not None:
        seen = presence.bool()
        pen = cfg.repetition_penalty
        logits = torch.where(seen, torch.where(logits > 0, logits * _recip(pen),
                                               logits * _f32(pen)), logits)
    if not cfg.greedy:
        logits = logits * _recip(max(cfg.temperature, 1e-6))
    return logits


def _pool_width(cfg: SamplingConfig, V: int) -> int:
    """Candidate-pool width: k when top-k is set (top-p sees the top-k
    filtered distribution), else cand_width under top-p, else 0 (pure
    temperature sampling draws over the full vocabulary)."""
    k_eff = cfg.top_k if cfg.top_k and 0 < cfg.top_k < V else 0
    if k_eff:
        return min(V, k_eff)
    if 0.0 < cfg.top_p < 1.0:
        return min(V, cfg.cand_width)
    return 0


def _top_k(x: torch.Tensor, k: int):
    """`jax.lax.top_k(x, k)` over the last dim: (values, int64 indices),
    in its order (see the module docstring)."""
    V = x.shape[-1]
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    rank = (V - 1) - torch.arange(V, dtype=torch.int64, device=x.device)
    top = torch.topk((order << 32) | rank, k, dim=-1).values  # distinct keys: a total order
    idx = (V - 1) - (top & prng.MASK32)
    return x.gather(-1, idx), idx


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """jax.scipy.special.logsumexp over the last dim, keepdims."""
    amax = x.amax(dim=-1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    return torch.log((x - amax).exp().sum(dim=-1, keepdim=True).abs()) + amax


def _pool_filter(logits: torch.Tensor, vals: torch.Tensor, cfg: SamplingConfig):
    """-inf out the pool entries (descending [S, W]) that top-p cuts: the
    masses come from the top-k renormalized distribution when top-k is set,
    else from the full softmax; the smallest prefix reaching top_p is kept
    (always the top-1)."""
    if 0.0 < cfg.top_p < 1.0:
        V = logits.shape[-1]
        k_eff = cfg.top_k if cfg.top_k and 0 < cfg.top_k < V else 0
        lse = _logsumexp(vals if k_eff else logits)
        probs = (vals - lse).exp()
        csum = probs.cumsum(dim=-1)
        keep = (csum - probs) < _f32(cfg.top_p)
        vals = torch.where(keep, vals, torch.full_like(vals, float("-inf")))
    return vals


def apply_penalty_and_filters(logits: torch.Tensor, cfg: SamplingConfig,
                              presence: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[S, V] logits -> filtered f32 logits [S, V], filtered-out entries at
    -inf: the full-vocabulary form of the chain (sample_tokens draws from
    the pool instead)."""
    logits = _penalized(logits, cfg, presence)
    if cfg.greedy:
        return logits
    W = _pool_width(cfg, logits.shape[-1])
    if not W:
        return logits
    vals = _top_k(logits, W)[0]
    filt = _pool_filter(logits, vals, cfg)
    thr = torch.where(torch.isfinite(filt), filt,
                      torch.full_like(filt, float("inf"))).amin(dim=-1, keepdim=True)
    return torch.where(logits < thr, torch.full_like(logits, float("-inf")), logits)


def sample_tokens(logits: torch.Tensor, cfg: SamplingConfig, keys=None, step=None,
                  presence: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[S, V] logits -> [S] int32 tokens.

    keys: [S, 2] int64 per-row keys (prng.fold_in of the engine's base
    key); step: [S] int32 per-row draw counters, folded into the keys, so
    that a fused multi-step decode advances each stream as stepwise
    decode does. The draw is gumbel-max over the candidate pool."""
    logits = _penalized(logits, cfg, presence)
    if cfg.greedy:
        return logits.argmax(dim=-1).to(torch.int32)
    W = _pool_width(cfg, logits.shape[-1])
    if W:
        vals, idx = _top_k(logits, W)
        pool = _pool_filter(logits, vals, cfg)
    else:
        pool, idx = logits, None
    u = prng.uniform(prng.fold_in(keys, step), pool.shape[-1:], 1e-20, 1.0)
    choice = (pool - (-u.log()).log()).argmax(dim=-1)
    if idx is None:
        return choice.to(torch.int32)
    return idx.gather(-1, choice[:, None])[:, 0].to(torch.int32)


def update_presence(presence: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """presence [S, V] | tokens [S] -> the updated bitmap: the maximum with
    the tokens' one-hot rows (no scatter; a token outside [0, V) adds
    nothing, as jax.nn.one_hot gives it no column)."""
    cols = torch.arange(presence.shape[-1], device=presence.device)
    return torch.maximum(presence, (cols == tokens[:, None]).to(presence.dtype))


def presence_from_prompts(prompts, vocab: int, width: int) -> np.ndarray:
    """Host-side initial presence [width, vocab] uint8 from token lists
    (rows past len(prompts) stay empty)."""
    out = np.zeros((width, vocab), np.uint8)
    for i, p in enumerate(prompts):
        toks = np.asarray(p, np.int64).ravel()
        toks = toks[(toks >= 0) & (toks < vocab)]
        out[i, toks] = 1
    return out


def host_oracle_token(logits, cfg: SamplingConfig, key, t, presence_row=None) -> int:
    """Replay one draw on the host (the CPU): the logits row [V], the row's
    key [2] and draw counter t, through the same pooled draw as
    sample_tokens (the stream depends on the pool width)."""
    row = torch.as_tensor(np.asarray(logits, np.float32))[None]
    pres = (None if presence_row is None
            else torch.as_tensor(np.asarray(presence_row, np.uint8))[None])
    if cfg.greedy:
        return int(_penalized(row, cfg, pres)[0].argmax())
    keys = prng.words(np.asarray(key, np.int64).reshape(1, 2))
    steps = torch.tensor([int(t)], dtype=torch.int32)
    return int(sample_tokens(row, cfg, keys, steps, pres)[0])


def oracle_margin(logits, cfg: SamplingConfig, key, t, presence_row=None) -> Any:
    """The host's view of one draw, to show how close a disagreement was:
    the two best candidates (vocabulary index, score = pool value +
    gumbel noise) and the gap between their scores."""
    row = torch.as_tensor(np.asarray(logits, np.float32))[None]
    pres = (None if presence_row is None
            else torch.as_tensor(np.asarray(presence_row, np.uint8))[None])
    lg = _penalized(row, cfg, pres)
    W = _pool_width(cfg, lg.shape[-1])
    if W:
        vals, idx = _top_k(lg, W)
        pool = _pool_filter(lg, vals, cfg)
    else:
        pool, idx = lg, torch.arange(lg.shape[-1])[None]
    keys = prng.words(np.asarray(key, np.int64).reshape(1, 2))
    u = prng.uniform(prng.fold_in(keys, torch.tensor([int(t)])), pool.shape[-1:], 1e-20, 1.0)
    score = (pool - (-u.log()).log())[0]
    top = torch.topk(score, 2)
    return {"candidates": [int(idx[0, i]) for i in top.indices],
            "scores": [float(s) for s in top.values],
            "gap": float(top.values[0] - top.values[1])}
