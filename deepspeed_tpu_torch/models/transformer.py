"""Decoder-only transformer family (Llama-class and GPT-2-class): config,
parameter init and the shared pieces of the forward.

Counterpart of deepspeed_tpu/models/transformer.py. `TransformerConfig`
keeps every field and every check of the reference, so one config object
describes a model to both packages, and `init` gives the same leaf names
and shapes: parameters are a plain dict of tensors with the layers
stacked on a leading [n_layers] dim (the training layout), so the JAX
package's parameters convert leaf for leaf (utils/convert.py).

Besides what serving shares (`_norm`, `_act_fn`, rotary tables, `init`,
`param_count`), this module holds the training forward and loss:
`forward_hidden`, `forward` and `make_loss_fn`, with the reference's remat
policies mapped onto `torch.utils.checkpoint`. Training covers the models
serving covers (dense Llama-class), without dropout (`check_trained`).
"""

import dataclasses
import math
from functools import partial
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import causal_attention
from ..platform.accelerator import resolve_device

# valid TransformerConfig.remat values; __post_init__ validates so a
# typo cannot silently train with no rematerialization
REMAT_MODES = ("none", "full", "dots", "save_attn", "save_attn_qkv",
               "save_attn_mlp", "save_attn_dots")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # GQA; None = MHA
    d_model: int = 512
    d_ff: Optional[int] = None  # default: 4x (gpt2) or llama 8/3 rounding
    max_seq: int = 2048
    variant: str = "llama"  # "llama" | "gpt2"
    # "ulysses": seq↔head all-to-all resharding around local attention
    # (deepspeed/sequence/layer.py); "ring": KV rotation over the 'seq'
    # ring with online softmax (parallel/ring_attention.py) — better for
    # very long sequences or heads < seq-parallel degree; "sparse":
    # block-sparse layouts (ops/sparse_attention.py, ref
    # ops/sparse_attention/sparsity_config.py) via the sparse_* knobs.
    attention_impl: str = "ulysses"
    # Token-exact sliding-window attention (Mistral-class; Mixtral = this
    # + n_experts). 0 disables. Applies to the ulysses impl; serving
    # masks the paged decode path to the same window.
    sliding_window: int = 0
    # Per-layer window pattern cycling over layers (GPT-Neo class:
    # attention_types [["global","local"], L/2] → (0, 256)). 0 entries
    # are global. Overrides sliding_window; the pattern length must
    # divide n_layers (the scan groups layers by one pattern period).
    attention_window_pattern: Optional[Tuple[int, ...]] = None
    sparse_block: int = 64
    sparse_mode: str = "fixed"  # fixed | longformer | bigbird | dense | variable
    sparse_num_local_blocks: int = 4
    sparse_num_global_blocks: int = 1
    sparse_num_random_blocks: int = 2
    # variable-mode layout (ref: VariableSparsityConfig): per-window
    # local sizes (last repeats) + explicit global block indices/ranges
    sparse_local_window_blocks: Tuple[int, ...] = (4,)
    sparse_global_block_indices: Tuple[int, ...] = (0,)
    sparse_global_block_end_indices: Optional[Tuple[int, ...]] = None
    dropout: float = 0.0
    # QAT activation quantization (ref: compression/basic_layer.py
    # LinearLayer_Compress activation_quantization — there a forward hook
    # on every compressed linear; here symmetric per-tensor fake-quant
    # with straight-through gradients on the normed activations feeding
    # the attention and FFN projections). 0 disables.
    activation_quant_bits: int = 0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    # jax.checkpoint policy: none | full | dots | save_attn |
    # save_attn_qkv | save_attn_mlp | save_attn_dots (save_attn* keep the
    # flash residuals so the backward skips the attention re-forward)
    remat: str = "none"
    # serving requires True: every prefill runs the flash kernel on the GPU
    # (its plain version on the CPU); False raises in inference.model
    use_flash: bool = True
    # flash tiling (1024x1024 fastest at S=2048/D=128; 512x1024 at S=16k)
    flash_block_q: int = 512
    flash_block_k: int = 1024
    # MoE (ref: deepspeed/moe/layer.py MoE:17 knobs). n_experts > 0 turns
    # every MLP into an expert-parallel MoE FFN.
    n_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_min_capacity: int = 4
    moe_aux_loss_coef: float = 0.01
    moe_noisy_gate_policy: Optional[str] = None  # None | RSample | Jitter
    # Dropless (capacity-factor-free) routing (moe/dropless.py,
    # MegaBlocks-style): sort-by-expert grouped batching at EP=1, the
    # explicit dispatch/combine all-to-all frame under an 'expert' mesh
    # axis. No token is ever dropped; moe_capacity_factor/min_capacity
    # are ignored. Serving follows the same flag (per-expert token
    # batching across the ragged batch instead of the X-pass scan).
    moe_dropless: bool = False
    # Router z-loss coefficient (ST-MoE): penalizes large router logits
    # so the fp32 gate softmax stays numerically sharp. 0 disables.
    moe_z_loss_coef: float = 0.0
    # PR-MoE residual form (ref: moe/layer.py:29 use_residual, arXiv
    # 2201.05596): each MoE FFN gains a DENSE residual expert and a
    # learned 2-way mixing coefficient —
    # out = moe(h) * c0 + dense(h) * c1, c = softmax(h @ w_coef + b).
    moe_use_residual: bool = False
    # Pipeline parallelism (ref: runtime/pipe/module.py PipelineModule).
    # >1 stores layers stage-partitioned [P, L/P, ...] and routes the
    # forward through runtime/pipe.pipeline_apply.
    pipeline_stages: int = 1
    # Interleaved (virtual-stage) pipelining: v > 1 stores layers
    # chunk-partitioned [v, P, L/(vP), ...] and runs the circular
    # schedule (runtime/pipe.pipeline_apply_circular) — warmup/drain
    # bubble shrinks ~v (the Megatron interleaved-1F1B analog).
    pipeline_virtual_stages: int = 1
    # Random-LTD (ref: data_pipeline/data_routing/basic_layer.py
    # RandomLayerTokenDrop:107): layers in [start, end) process only the
    # batch-supplied 'random_ltd' token subset; dropped tokens skip them
    # and are re-inserted in order. None disables.
    random_ltd_layer_range: Optional[Tuple[int, int]] = None
    # RoPE frequency scaling for long-context checkpoints (HF
    # rope_scaling): "none" | "linear" (positions / factor) | "llama3"
    # (NTK-style per-band wavelength remap, the Llama-3.x rule).
    rope_scaling_type: str = "none"
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_seq: int = 8192
    # Explicit head dim for families where head_dim != d_model / n_heads
    # (Mistral-Nemo / Gemma-class); None derives it.
    head_dim_override: Optional[int] = None
    # ---- model-family knobs (serving-zoo breadth: Falcon / OPT / Phi /
    # Qwen — ref: inference/v2/model_implementations/{falcon,opt,phi,
    # qwen,qwen_v2}/model.py; each family is a small delta on the ONE
    # functional family here, not a separate module zoo). The `variant`
    # stays the base preset: "llama" = rotary family, "gpt2" =
    # learned-positions family; None knobs inherit the preset.
    qkv_bias: Optional[bool] = None       # Qwen/Qwen2/Phi: q/k/v biases
    attn_out_bias: Optional[bool] = None  # bo (OPT/Phi yes, Qwen no)
    mlp_bias: Optional[bool] = None       # b_in/b_out
    activation: Optional[str] = None      # silu | gelu | relu (OPT)
    norm_type: Optional[str] = None       # rms | layer (Falcon/Phi: layer)
    gated_mlp: Optional[bool] = None      # SwiGLU pair vs single w_in
    # Falcon/Phi parallel form: x + attn(ln1 x) + mlp(ln2 x); shared_ln
    # feeds BOTH branches from ln1 (Falcon-7B / Phi) and drops ln2.
    parallel_residual: bool = False
    shared_ln: bool = False
    rotary_pct: float = 1.0               # Phi partial rotary
    lm_head_bias: bool = False            # Phi-2
    # ALiBi positional bias (Bloom / falcon-rw; ref:
    # module_inject/containers/bloom.py + the CUDA softmax alibi path).
    # Replaces rope AND learned positions: per-head slopes bias every
    # attention score by slope_h * (key_pos - query_pos).
    alibi: bool = False
    # Falcon's HF modeling applies the bias BEFORE the 1/sqrt(D) score
    # scaling (bloom adds it after) — falcon-rw checkpoints therefore
    # need slopes scaled by 1/sqrt(head_dim) to reproduce HF numerics.
    alibi_slope_scale: float = 1.0
    # GPT-J rope pairing: rotate_every_two (dims 2i/2i+1 form a rotation
    # pair) instead of the Llama/NeoX split-halves convention.
    rope_interleaved: bool = False
    # Bloom: LayerNorm over the embedding output before the first block
    embedding_layernorm: bool = False

    def __post_init__(self):
        if self.rope_scaling_type not in ("none", "linear", "llama3"):
            raise ValueError(
                f"unsupported rope_scaling_type '{self.rope_scaling_type}' "
                "(supported: none|linear|llama3)"
            )
        if self.pipeline_virtual_stages > 1 and self.pipeline_stages <= 1:
            raise ValueError(
                "pipeline_virtual_stages > 1 requires pipeline_stages > 1"
            )
        if self.remat not in REMAT_MODES:
            raise ValueError(
                f"unknown remat '{self.remat}' (expected one of {REMAT_MODES})"
            )
        if self.attention_impl not in ("ulysses", "ring", "sparse"):
            raise ValueError(
                f"unknown attention_impl '{self.attention_impl}' "
                "(expected ulysses|ring|sparse)"
            )
        if self.sliding_window > 0 and self.attention_impl != "ulysses":
            raise ValueError(
                "sliding_window requires attention_impl='ulysses' (ring "
                "rotates full KV; sparse expresses locality via its own "
                "block layout)"
            )
        if self.variant not in ("llama", "gpt2"):
            raise ValueError(f"unknown variant '{self.variant}'")
        if self.activation not in (None, "silu", "gelu", "gelu_exact",
                                   "relu"):
            # "gelu" is the tanh approximation (HF gelu_new — GPT-2/Phi);
            # "gelu_exact" is erf GELU (Falcon's nn.GELU())
            raise ValueError(f"unknown activation '{self.activation}'")
        if self.norm_type not in (None, "rms", "layer"):
            raise ValueError(f"unknown norm_type '{self.norm_type}'")
        if self.shared_ln and not self.parallel_residual:
            raise ValueError("shared_ln requires parallel_residual")
        if not (0.0 < self.rotary_pct <= 1.0):
            raise ValueError("rotary_pct must be in (0, 1]")
        if self.rotary_pct < 1.0 and self.variant == "gpt2":
            raise ValueError("rotary_pct applies to the rotary family")
        if self.lm_head_bias and self.tie_embeddings:
            raise ValueError("lm_head_bias requires an untied lm_head")
        if self.attention_window_pattern is not None:
            p = tuple(self.attention_window_pattern)
            if self.attention_impl != "ulysses":
                raise ValueError(
                    "attention_window_pattern requires "
                    "attention_impl='ulysses'")
            if not p or any(w < 0 for w in p):
                raise ValueError(
                    f"bad attention_window_pattern {p} (non-empty, "
                    "entries >= 0; 0 = global)")
            if self.n_layers % len(p):
                raise ValueError(
                    f"attention_window_pattern length {len(p)} must "
                    f"divide n_layers {self.n_layers}")
            if self.pipeline_stages > 1 or self.random_ltd_layer_range:
                raise NotImplementedError(
                    "attention_window_pattern with pipeline/random-LTD "
                    "layer partitioning")
            # collapse to the MINIMAL period: HF imports arrive expanded
            # to n_layers entries (attention_types repeats sum to
            # num_layers), and the scan body unrolls len(pattern)
            # sublayers — a full-length pattern would unroll EVERY layer
            # (gpt-neo-2.7B: 32 bodies in one scan step). Cyclic
            # equality is preserved: q divides len(p) and p[i]==p[i%q].
            for q_len in range(1, len(p)):
                if len(p) % q_len == 0 and all(
                        p[i] == p[i % q_len] for i in range(len(p))):
                    object.__setattr__(self, "attention_window_pattern",
                                       p[:q_len])
                    break
        if self.alibi and self.attention_impl != "ulysses":
            raise ValueError(
                "alibi requires attention_impl='ulysses' (ring rotates KV "
                "without absolute-position bookkeeping for the bias; "
                "sparse layouts express position via blocks)"
            )
        if self.alibi and self.rotary_pct < 1.0:
            raise ValueError("alibi replaces rotary embeddings entirely")
        if self.rope_interleaved and not self.use_rope:
            raise ValueError("rope_interleaved applies to the rotary family")

    # -- family-knob resolution (None -> variant preset) ---------------
    @property
    def use_rope(self) -> bool:
        return self.variant != "gpt2" and not self.alibi

    @property
    def use_learned_pos(self) -> bool:
        return self.variant == "gpt2" and not self.alibi

    @property
    def norm_kind(self) -> str:
        return self.norm_type or ("rms" if self.variant == "llama"
                                  else "layer")

    @property
    def norm_has_bias(self) -> bool:
        return self.norm_kind == "layer"

    @property
    def act_name(self) -> str:
        return self.activation or ("silu" if self.variant == "llama"
                                   else "gelu")

    @property
    def is_gated(self) -> bool:
        if self.gated_mlp is not None:
            return self.gated_mlp
        return self.variant == "llama"

    @property
    def has_qkv_bias(self) -> bool:
        if self.qkv_bias is not None:
            return self.qkv_bias
        return self.variant == "gpt2"

    @property
    def has_attn_out_bias(self) -> bool:
        if self.attn_out_bias is not None:
            return self.attn_out_bias
        return self.variant == "gpt2"

    @property
    def has_mlp_bias(self) -> bool:
        if self.mlp_bias is not None:
            return self.mlp_bias
        return self.variant == "gpt2"

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        if self.is_gated:
            d = int(self.d_model * 8 / 3)
            return ((d + 127) // 128) * 128
        return 4 * self.d_model

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Train-step matmul FLOPs per token for MFU accounting: 6*N (fwd
        + bwd over all params) + the causal attention term 6*L*S*E (QK^T
        and AV each ~S*E fwd flops per token under the causal mask;
        backward doubles it)."""
        S = seq_len or self.max_seq
        return 6.0 * param_count(self) + 6.0 * self.n_layers * S * self.d_model


def param_count(cfg: TransformerConfig) -> int:
    return sum(math.prod(s) for s in _param_shapes(cfg).values())


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[Tuple[int, ...], Tuple]]:
    """name -> (shape-without-layer-dim, logical axes-without-layer-dim)"""
    E, H, KV, D, F = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.ff_dim
    shapes = {
        "ln1_scale": ((E,), ("embed",)),
        "wq": ((E, H, D), ("embed", "heads", "head_dim")),
        "wk": ((E, KV, D), ("embed", "heads", "head_dim")),
        "wv": ((E, KV, D), ("embed", "heads", "head_dim")),
        "wo": ((H, D, E), ("heads", "head_dim", "embed")),
    }
    if not cfg.shared_ln:
        shapes["ln2_scale"] = ((E,), ("embed",))
    X = cfg.n_experts
    if X > 0:
        shapes.update({
            "w_router": ((E, X), ("embed", None)),
            "w_in": ((X, E, F), ("expert", "embed", "expert_mlp")),
            "w_out": ((X, F, E), ("expert", "expert_mlp", "embed")),
        })
        if cfg.is_gated:
            shapes["w_gate"] = ((X, E, F), ("expert", "embed", "expert_mlp"))
        if cfg.moe_use_residual:
            shapes.update({
                "wr_in": ((E, F), ("embed", "mlp")),
                "wr_out": ((F, E), ("mlp", "embed")),
                "w_coef": ((E, 2), ("embed", None)),
                "b_coef": ((2,), (None,)),
            })
            if cfg.is_gated:
                shapes["wr_gate"] = ((E, F), ("embed", "mlp"))
            if cfg.has_mlp_bias:
                shapes["br_in"] = ((F,), ("mlp",))
                shapes["br_out"] = ((E,), ("embed",))
    else:
        shapes.update({
            "w_in": ((E, F), ("embed", "mlp")),
            "w_out": ((F, E), ("mlp", "embed")),
        })
        if cfg.is_gated:
            shapes["w_gate"] = ((E, F), ("embed", "mlp"))
    if cfg.norm_has_bias:
        shapes["ln1_bias"] = ((E,), ("embed",))
        if not cfg.shared_ln:
            shapes["ln2_bias"] = ((E,), ("embed",))
    if cfg.has_mlp_bias:
        shapes["b_in"] = (((X, F) if X > 0 else (F,)),
                          (("expert", "expert_mlp") if X > 0 else ("mlp",)))
        shapes["b_out"] = (((X, E) if X > 0 else (E,)),
                           (("expert", "embed") if X > 0 else ("embed",)))
    if cfg.has_qkv_bias:
        shapes["bq"] = ((H, D), ("heads", "head_dim"))
        shapes["bk"] = ((KV, D), ("heads", "head_dim"))
        shapes["bv"] = ((KV, D), ("heads", "head_dim"))
    if cfg.has_attn_out_bias:
        shapes["bo"] = ((E,), ("embed",))
    return shapes


def _param_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat leaf path ("embed", "layers/wq", ...) -> full shape of every
    parameter `init` creates, in the training layout."""
    E, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    out: Dict[str, Tuple[int, ...]] = {"embed": (V, E), "ln_f_scale": (E,)}
    if cfg.use_learned_pos:
        out["pos_embed"] = (cfg.max_seq, E)
    if cfg.embedding_layernorm:
        out["embed_ln_scale"] = (E,)
        if cfg.norm_has_bias:
            out["embed_ln_bias"] = (E,)
    if cfg.norm_has_bias:
        out["ln_f_bias"] = (E,)
    if not cfg.tie_embeddings:
        out["lm_head"] = (E, V)
        if cfg.lm_head_bias:
            out["lm_head_b"] = (V,)
    for name, (shape, _) in _layer_shapes(cfg).items():
        out[f"layers/{name}"] = (L,) + shape
    return out


def init(cfg: TransformerConfig, generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device, None] = None,
         dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random parameters in the training layout (layers stacked on a
    leading [n_layers] dim), with the reference's leaf names, shapes and
    init scheme: normal(0, 0.02) weights, 0.02 / sqrt(2 L) for the
    residual-output projections, ones for norm scales, zeros for biases.

    Draws come from `generator` on the generator's own device and are
    then moved to `device` (a CUDA generator draws on the card). The
    values differ from the JAX package's for the same seed: tests that
    compare the two make their weights with numpy (utils/convert.py)."""
    if cfg.pipeline_stages > 1:
        raise NotImplementedError(
            "pipeline-partitioned layers come with the pipeline slice "
            "(runtime/pipe.py)")
    device = resolve_device(device)
    gen_device = generator.device if generator is not None else torch.device("cpu")
    E, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    std = 0.02

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=gen_device,
                        dtype=torch.float32) * scale
        return x.to(device=device, dtype=dtype)

    def const(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    params: Dict[str, Any] = {
        "embed": normal((V, E), std),
        "ln_f_scale": const((E,), 1.0),
    }
    if cfg.use_learned_pos:
        params["pos_embed"] = normal((cfg.max_seq, E), std)
    if cfg.embedding_layernorm:
        params["embed_ln_scale"] = const((E,), 1.0)
        if cfg.norm_has_bias:
            params["embed_ln_bias"] = const((E,), 0.0)
    if cfg.norm_has_bias:
        params["ln_f_bias"] = const((E,), 0.0)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((E, V), std)
        if cfg.lm_head_bias:
            params["lm_head_b"] = const((V,), 0.0)

    layers = {}
    for name, (shape, _) in sorted(_layer_shapes(cfg).items()):
        full = (L,) + shape
        if "ln" in name:
            layers[name] = const(full, 1.0 if "scale" in name else 0.0)
        elif name.startswith("b"):
            layers[name] = const(full, 0.0)
        else:
            scale = std / (2 * L) ** 0.5 if name in ("wo", "w_out", "wr_out") else std
            layers[name] = normal(full, scale)
    params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# forward pieces shared with serving
# ---------------------------------------------------------------------------

def _norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
          cfg: TransformerConfig) -> torch.Tensor:
    """RMSNorm or LayerNorm computed in f32, returned in x's dtype."""
    x32 = x.float()
    if cfg.norm_kind == "rms":
        out = F.rms_norm(x32, x32.shape[-1:], scale.float(), cfg.norm_eps)
    else:
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        out = (x32 - mean) * torch.rsqrt(var + cfg.norm_eps) * scale + bias
    return out.to(x.dtype)


def _act_fn(cfg: TransformerConfig):
    return {"silu": F.silu, "gelu": partial(F.gelu, approximate="tanh"),
            "gelu_exact": F.gelu, "relu": F.relu}[cfg.act_name]


def rope_dim(cfg: TransformerConfig) -> int:
    """Rotated dims per head: head_dim, or the partial-rotary slice
    (rotary_pct * head_dim, rounded down to even)."""
    R = int(cfg.rotary_pct * cfg.head_dim)
    return R - (R % 2)


def rope_inv_freq(cfg: TransformerConfig,
                  device: Union[str, torch.device, None] = "cpu") -> torch.Tensor:
    """Per-band rotary frequencies [rope_dim/2] in f32, with long-context
    scaling: "linear" divides every frequency by the factor; "llama3" is
    the Llama-3.x NTK-by-parts rule (long wavelengths compress by the
    factor, short ones keep full resolution, the middle band
    interpolates)."""
    D = rope_dim(cfg)
    inv = cfg.rope_theta ** (
        -torch.arange(0, D // 2, dtype=torch.float32, device=device) / (D // 2))
    if cfg.rope_scaling_type == "linear":
        return inv / cfg.rope_scaling_factor
    if cfg.rope_scaling_type == "llama3":
        factor = cfg.rope_scaling_factor
        lo, hi = cfg.rope_low_freq_factor, cfg.rope_high_freq_factor
        old = cfg.rope_original_max_seq
        wavelen = 2.0 * math.pi / inv
        scaled = torch.where(wavelen > old / lo, inv / factor, inv)
        smooth = (old / wavelen - lo) / (hi - lo)
        smoothed = (1.0 - smooth) / factor * inv + smooth * inv
        mid = (wavelen >= old / hi) & (wavelen <= old / lo)
        return torch.where(mid, smoothed, scaled)
    return inv


def logical_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """Logical axis names of every parameter leaf (the reference's sharding
    metadata). One GPU shards nothing, so the port only carries them: the
    engine accepts them for the reference's `initialize` signature."""
    specs: Dict[str, Any] = {
        "embed": ("vocab", "embed"),
        "ln_f_scale": ("embed",),
    }
    if cfg.use_learned_pos:
        specs["pos_embed"] = (None, "embed")
    if cfg.embedding_layernorm:
        specs["embed_ln_scale"] = ("embed",)
        if cfg.norm_has_bias:
            specs["embed_ln_bias"] = ("embed",)
    if cfg.norm_has_bias:
        specs["ln_f_bias"] = ("embed",)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
        if cfg.lm_head_bias:
            specs["lm_head_b"] = ("vocab",)
    if cfg.pipeline_stages > 1:
        lead = (("pipe_virtual", "pipe_stage", "layers")
                if cfg.pipeline_virtual_stages > 1
                else ("pipe_stage", "layers"))
    else:
        lead = ("layers",)
    specs["layers"] = {
        name: lead + logical for name, (_, logical) in _layer_shapes(cfg).items()
    }
    return specs


def unported_features(cfg: TransformerConfig) -> List[str]:
    """What the config uses beyond the dense Llama-class model the port
    runs so far (serving and training alike); empty when it is covered."""
    unsupported = {
        "variant != 'llama'": cfg.variant != "llama",
        "MoE (n_experts > 0)": cfg.n_experts > 0,
        "sparse attention": cfg.attention_impl == "sparse",
        "sliding windows": bool(cfg.sliding_window or cfg.attention_window_pattern),
        "ALiBi": cfg.alibi,
        "q/k/v, output or MLP biases": (cfg.has_qkv_bias or cfg.has_attn_out_bias
                                        or cfg.has_mlp_bias),
        "a non-gated MLP": not cfg.is_gated,
        "LayerNorm": cfg.norm_kind != "rms",
        "parallel residuals": cfg.parallel_residual,
        "activation quantization": cfg.activation_quant_bits > 0,
        "an embedding LayerNorm": cfg.embedding_layernorm,
        "an lm_head bias": cfg.lm_head_bias,
        "pipeline-partitioned layers": cfg.pipeline_stages > 1,
        "use_flash=False (dense attention)": not cfg.use_flash,
    }
    return [name for name, hit in unsupported.items() if hit]


def check_trained(cfg: TransformerConfig) -> None:
    """Raise NotImplementedError for a model the training slice does not
    train: what serving does not cover, plus dropout, random-LTD layers
    and the remat modes with no torch.utils.checkpoint mapping yet."""
    bad = unported_features(cfg) + [name for name, hit in {
        "dropout > 0": cfg.dropout > 0.0,
        "random-LTD layers": cfg.random_ltd_layer_range is not None,
        f"remat='{cfg.remat}'": cfg.remat not in ("none", "full", "save_attn_qkv"),
    }.items() if hit]
    if bad:
        raise NotImplementedError(
            "the training slice trains dense Llama-class models only (remat "
            f"none|full|save_attn_qkv); this config uses {', '.join(bad)} "
            "(later slices port them)")


# ---------------------------------------------------------------------------
# rotary embeddings (the reference's _rope)
# ---------------------------------------------------------------------------

def _rope_tables(positions: torch.Tensor, cfg: TransformerConfig):
    """cos and sin [T, 1, R/2] (f32) of the rotary angles at per-token
    positions [T] (frequencies from rope_inv_freq, so scaling and partial
    rotary match). Computed once per forward and shared by every layer:
    eagerly, each small op costs a kernel launch."""
    freqs = rope_inv_freq(cfg, device=positions.device)
    angles = positions.float()[:, None] * freqs[None, :]  # [T, R/2]
    return angles.cos()[:, None, :], angles.sin()[:, None, :]


def _rope_at(x: torch.Tensor, rope, cfg: TransformerConfig) -> torch.Tensor:
    """Rotary embedding of x [..., T, H, D] with the (cos, sin) tables of
    `_rope_tables`, computed in f32 and returned in x's dtype."""
    c, s = rope
    R = rope_dim(cfg)
    xr, xp = x[..., :R], x[..., R:]
    if cfg.rope_interleaved:
        xf = xr.float().reshape(*xr.shape[:-1], R // 2, 2)
        x1, x2 = xf[..., 0], xf[..., 1]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(xr.shape)
    else:
        x1, x2 = xr.float().chunk(2, dim=-1)
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def _attention_qkv(h: torch.Tensor, lp, cfg: TransformerConfig, rope):
    """Normed input h [B, S, E] -> rope-rotated q [B, S, H, D] and k, v
    [B, S, KV, D]: the residuals remat='save_attn_qkv' keeps."""
    B, S, E = h.shape
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = (h @ lp["wq"].to(h.dtype).reshape(E, H * D)).view(B, S, H, D)
    k = (h @ lp["wk"].to(h.dtype).reshape(E, KV * D)).view(B, S, KV, D)
    v = (h @ lp["wv"].to(h.dtype).reshape(E, KV * D)).view(B, S, KV, D)
    return _rope_at(q, rope, cfg), _rope_at(k, rope, cfg), v


def _attention_out(att: torch.Tensor, lp) -> torch.Tensor:
    """Attention output [B, S, H, D] -> its residual delta [B, S, E]."""
    B, S, H, D = att.shape
    wo = lp["wo"].to(att.dtype)
    return att.reshape(B, S, H * D) @ wo.reshape(H * D, wo.shape[-1])


def _mlp_delta(h: torch.Tensor, lp, cfg: TransformerConfig) -> torch.Tensor:
    """Gated FFN branch over the NORMED input h; returns the residual
    delta (the reference also returns MoE aux losses, always zero for the
    dense models this slice trains)."""
    act = _act_fn(cfg)
    inner = act(h @ lp["w_gate"].to(h.dtype)) * (h @ lp["w_in"].to(h.dtype))
    return inner @ lp["w_out"].to(h.dtype)


def _make_layer_body(cfg: TransformerConfig, use_kernel: bool = True):
    """One transformer layer, body(h0, lp, rope) -> h, with cfg.remat
    mapped onto torch.utils.checkpoint (non-reentrant):

    - "none": every activation autograd needs is kept;
    - "full": the whole body is recomputed in the backward (the flash
      forward included);
    - "save_attn_qkv": two checkpointed regions around the attention, the
      pre-attention part (norm1, q/k/v projections, rope) and the
      post-attention part (out projection, residual, norm2, MLP,
      residual). The flash Function sits between them, outside any
      checkpoint, so its saved q, k, v, o and lse persist: the backward
      runs no attention forward, only the projections and the MLP again.
    """
    def pre(h0, lp, rope):
        return _attention_qkv(_norm(h0, lp["ln1_scale"], None, cfg), lp, cfg, rope)

    def post(h0, att, lp):
        hmid = h0 + _attention_out(att, lp)
        return hmid + _mlp_delta(_norm(hmid, lp["ln2_scale"], None, cfg), lp, cfg)

    def body(h0, lp, rope):
        return post(h0, causal_attention(*pre(h0, lp, rope), use_flash=use_kernel), lp)

    def ckpt(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)

    if cfg.remat == "none":
        return body
    if cfg.remat == "full":
        return lambda h0, lp, rope: ckpt(body, h0, lp, rope)

    def body_save_qkv(h0, lp, rope):
        att = causal_attention(*ckpt(pre, h0, lp, rope), use_flash=use_kernel)
        return ckpt(post, h0, att, lp)

    return body_save_qkv


def forward_hidden(params: Dict[str, Any], tokens: torch.Tensor, cfg: TransformerConfig,
                   rng: Optional[torch.Generator] = None,
                   use_kernel: bool = True) -> torch.Tensor:
    """tokens [B, S] -> final hidden states [B, S, E] (post ln_f), in the
    dtype of params["embed"]. The reference's lax.scan over the stacked
    layers is a Python loop over views of the [L, ...] leaves (one unbind
    per leaf, so the backward stacks each leaf's gradient once). `rng` is
    accepted for the reference's signature; nothing here draws from it
    (dropout raises in check_trained)."""
    check_trained(cfg)
    x = F.embedding(tokens.long(), params["embed"])
    rope = _rope_tables(torch.arange(tokens.shape[1], device=tokens.device), cfg)
    body = _make_layer_body(cfg, use_kernel)
    views = {name: w.unbind(0) for name, w in params["layers"].items()}
    for li in range(cfg.n_layers):
        x = body(x, {name: ws[li] for name, ws in views.items()}, rope)
    return _norm(x, params["ln_f_scale"], None, cfg)


def _lm_head(params: Dict[str, Any], cfg: TransformerConfig) -> torch.Tensor:
    """[E, V] output projection (the tied embedding's transpose, a view)."""
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: TransformerConfig,
            rng: Optional[torch.Generator] = None, use_kernel: bool = True) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] in the compute dtype."""
    x = forward_hidden(params, tokens, cfg, rng, use_kernel)
    return x @ _lm_head(params, cfg).to(x.dtype)


def _ce_chunk(x_c, head, t_c, m_c):
    """Summed next-token NLL and mask count of one sequence chunk; the
    [B, C, V] logits are computed in f32 from the compute-dtype product."""
    logits = (x_c @ head.to(x_c.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, t_c.long()[..., None])[..., 0]
    return ((lse - tgt) * m_c).sum(), m_c.sum()


def _chunked_ce(x, head, targets, mask, n_chunks: int):
    """Cross-entropy without materialising [B, S, V] through the backward:
    each chunk's logits and logsumexp run under a checkpoint, so they are
    recomputed in the backward and peak memory is [B, S / n_chunks, V].
    Returns (sum_nll, sum_mask)."""
    C = x.shape[1] // n_chunks
    tot = cnt = 0.0
    for c in range(n_chunks):
        sl = slice(c * C, (c + 1) * C)
        s, n = checkpoint(_ce_chunk, x[:, sl], head, targets[:, sl], mask[:, sl],
                          use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + s, cnt + n
    return tot, cnt


def _shift_mask(batch, targets: torch.Tensor) -> torch.Tensor:
    """Loss mask aligned with the shifted targets ([..., 1:])."""
    if "mask" in batch:
        return torch.as_tensor(batch["mask"], device=targets.device)[..., 1:].float()
    return torch.ones(targets.shape, dtype=torch.float32, device=targets.device)


def _ce_chunk_count(seq_len: int, loss_chunks: int) -> int:
    return max(loss_chunks if seq_len % max(loss_chunks, 1) == 0 else 1, 1)


def _token_mean_ce(x, head, targets, mask, n_chunks: int):
    """Token-mean CE for one (micro)batch."""
    tot, cnt = _chunked_ce(x, head, targets, mask, n_chunks)
    return tot / cnt.clamp(min=1.0)


def make_loss_fn(cfg: TransformerConfig, loss_chunks: int = 8, use_kernel: bool = True):
    """Next-token cross-entropy over batch {"tokens": [B, S + 1]} (and an
    optional "mask"): loss_fn(params, batch, rng) -> scalar f32 loss.

    loss_chunks: sequence-chunked CE (memory [B, S / chunks, V] instead of
    [B, S, V]); 1 disables chunking. use_kernel=False computes attention
    with the dense plain version: the reference the kernel path is held
    against on the card, never the default."""
    check_trained(cfg)

    def loss_fn(params, batch, rng):
        tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        x = forward_hidden(params, inputs, cfg, rng, use_kernel)
        n = _ce_chunk_count(inputs.shape[1], loss_chunks)
        return _token_mean_ce(x, _lm_head(params, cfg), targets, _shift_mask(batch, targets), n)

    return loss_fn
