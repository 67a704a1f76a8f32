"""Shared inputs for the port's parity tests (tests/test_torch_*.py): one
tiny Llama config built for both packages, the tiny Falcon-, Phi-,
GPT-NeoX- and GPT-J-class forms, and parameters made from a numpy seed so
the JAX package and the port get the same numbers."""

import numpy as np

# 2 layers, d_model 256, 2 heads x head_dim 128, vocab 512
TINY = dict(vocab_size=512, n_layers=2, n_heads=2, d_model=256, max_seq=256,
            variant="llama")
# serving geometry: 16-token KV blocks, 8 of them per sequence
SERVE = dict(max_seq_len=128, kv_block_size=16, num_kv_blocks=48,
             min_prefill_bucket=16, max_batch_size=16)

# the Falcon- and Phi-class forms of the serving and training parity
# tests (tests/test_torch_falcon_phi*.py), tiny widths
_BASE = dict(vocab_size=512, n_layers=2, max_seq=256, variant="llama", norm_type="layer",
             gated_mlp=False, parallel_residual=True)
# the Falcon-7B form (config_from_hf of a FalconConfig with multi_query,
# parallel_attn and no bias): one shared LayerNorm, 12 query heads of 64
# over one KV head, erf GELU, tied embeddings
FALCON_7B_TINY = dict(_BASE, n_heads=12, n_kv_heads=1, d_model=768, d_ff=3072,
                      activation="gelu_exact", qkv_bias=False, attn_out_bias=False,
                      mlp_bias=False, shared_ln=True)
# the Falcon-40B form (new_decoder_architecture): two LayerNorms (ln_attn,
# ln_mlp), GQA with groups of 16 (32 query heads of 64 over 2 KV heads), a
# narrow MLP
FALCON_40B_TINY = dict(_BASE, n_heads=32, n_kv_heads=2, d_model=2048, d_ff=1024,
                       activation="gelu_exact", qkv_bias=False, attn_out_bias=False,
                       mlp_bias=False, shared_ln=False)
# the Phi-2 form: 4 heads of 80, partial rotary 0.4 (32 of 80 dims), tanh
# GELU, biases everywhere, an untied lm_head with its bias
PHI_2_TINY = dict(_BASE, n_heads=4, d_model=320, d_ff=1280, activation="gelu",
                  qkv_bias=True, attn_out_bias=True, mlp_bias=True, shared_ln=True,
                  rotary_pct=0.4, tie_embeddings=False, lm_head_bias=True)
FALCON_PHI = {"falcon_7b": FALCON_7B_TINY, "falcon_40b": FALCON_40B_TINY, "phi_2": PHI_2_TINY}
# the GPT-NeoX-20B form (config_from_hf of a GPTNeoXConfig): 2 heads of 96,
# rotary on 24 of 96 dims (rotary_pct 0.25, split halves), two LayerNorms
# and the parallel residual, biases on q/k/v, output and MLP, tanh GELU
# (gelu_fast), an untied lm_head without a bias
GPT_NEOX_TINY = dict(_BASE, n_heads=2, d_model=192, d_ff=768, activation="gelu",
                     qkv_bias=True, attn_out_bias=True, mlp_bias=True, shared_ln=False,
                     rotary_pct=0.25, tie_embeddings=False)
# the GPT-J-6B form (config_from_hf of a GPTJConfig): 2 heads of 256,
# interleaved rotary on 64 of 256 dims (rotary_dim / head_dim), one shared
# LayerNorm, unbiased attention, a biased MLP, an untied lm_head with its
# bias
GPT_J_TINY = dict(_BASE, n_heads=2, d_model=512, d_ff=2048, activation="gelu",
                  qkv_bias=False, attn_out_bias=False, mlp_bias=True, shared_ln=True,
                  rotary_pct=0.25, rope_interleaved=True, tie_embeddings=False,
                  lm_head_bias=True)
NEOX_GPTJ = {"gpt_neox": GPT_NEOX_TINY, "gpt_j": GPT_J_TINY}
# weight std of each form's numpy weights: the ALiBi engine tests' 0.3 at
# their d_model 256 (large enough that greedy tokens vary), scaled by
# sqrt(256 / d_model) so that the logits keep the size they have there,
# where the 1e-4 pin was set (logit RMS ~ std * sqrt(E); the two
# frameworks' f32 sums differ by ~1e-5 of a logit's size)
FALCON_PHI_STD = {name: 0.3 * (256 / over["d_model"]) ** 0.5
                  for name, over in FALCON_PHI.items()}
NEOX_GPTJ_STD = {name: 0.3 * (256 / over["d_model"]) ** 0.5
                 for name, over in NEOX_GPTJ.items()}


def jax_config(**over):
    from deepspeed_tpu.models import transformer as JT

    return JT.TransformerConfig(**{**TINY, **over})


def torch_config(**over):
    from deepspeed_tpu_torch.models import transformer as PT

    return PT.TransformerConfig(**{**TINY, **over})


def numpy_params(cfg, seed=0, std=0.08):
    """Training-layout parameters of the JAX package's leaf names and
    shapes, drawn from numpy: normal(0, std) weights, norm scales near 1.
    std is larger than training init so greedy tokens vary."""
    from deepspeed_tpu.models import transformer as JT

    r = np.random.default_rng(seed)
    E, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    params = {"embed": r.normal(0, std, (V, E)).astype(np.float32),
              "ln_f_scale": (1 + r.normal(0, 0.1, (E,))).astype(np.float32)}
    layers = {}
    for name, (shape, _) in sorted(JT._layer_shapes(cfg).items()):
        full = (L,) + tuple(shape)
        if "ln" in name:
            layers[name] = (1 + r.normal(0, 0.1, full)).astype(np.float32)
        else:
            layers[name] = r.normal(0, std, full).astype(np.float32)
    params["layers"] = layers
    if not cfg.tie_embeddings:  # drawn last: tied configs keep their draws
        params["lm_head"] = r.normal(0, std, (E, V)).astype(np.float32)
        if cfg.lm_head_bias:  # Phi-2
            params["lm_head_b"] = r.normal(0, std, (V,)).astype(np.float32)
    # the Bloom-class top-level leaves, after every draw above
    if cfg.embedding_layernorm:
        params["embed_ln_scale"] = (1 + r.normal(0, 0.1, (E,))).astype(np.float32)
        if cfg.norm_has_bias:
            params["embed_ln_bias"] = r.normal(0, 0.1, (E,)).astype(np.float32)
    if cfg.norm_has_bias:
        params["ln_f_bias"] = r.normal(0, 0.1, (E,)).astype(np.float32)
    return params


def to_jax(tree):
    import jax.numpy as jnp

    return {k: ({n: jnp.asarray(a) for n, a in v.items()} if k == "layers"
                else jnp.asarray(v)) for k, v in tree.items()}


def flatten(tree, prefix=""):
    """{"a/b": leaf} for a nested dict, in sorted-key order (the order of
    deepspeed_tpu_torch.utils.tree.leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}
