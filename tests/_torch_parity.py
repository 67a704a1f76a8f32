"""Shared inputs for the port's parity tests (tests/test_torch_*.py): one
tiny Llama config built for both packages, and its parameters made from a
numpy seed so the JAX package and the port get the same numbers."""

import numpy as np

# 2 layers, d_model 256, 2 heads x head_dim 128, vocab 512
TINY = dict(vocab_size=512, n_layers=2, n_heads=2, d_model=256, max_seq=256,
            variant="llama")
# serving geometry: 16-token KV blocks, 8 of them per sequence
SERVE = dict(max_seq_len=128, kv_block_size=16, num_kv_blocks=48,
             min_prefill_bucket=16, max_batch_size=16)


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
