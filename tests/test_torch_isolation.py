"""The port stands alone: it imports neither JAX nor the JAX package.

A fresh interpreter imports the port, serves a tiny model on the CPU end
to end (prefill, single-token decode, chunked continuation, greedy
decode_multi) and takes one bf16 train step through `initialize`;
afterwards neither `jax` nor `deepspeed_tpu` may be in
sys.modules. A static scan of the port's sources and chip_smoke.py backs
it up for modules the run does not import."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SLICE = r"""
import sys
import numpy as np
import torch
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.ops import cuda as K

cfg = T.TransformerConfig(vocab_size=512, n_layers=2, n_heads=2, d_model=256,
                          max_seq=256, variant="llama")
params = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
eng = init_inference(params, cfg, dict(max_seq_len=128, kv_block_size=16,
                     num_kv_blocks=32, min_prefill_bucket=16, max_batch_size=16),
                     dtype=torch.float32, device="cpu")
r = np.random.default_rng(0)
logits = eng.put([0, 1], [r.integers(0, 512, 24), r.integers(0, 512, 9)])
logits = np.concatenate([logits, eng.put([0], [np.array([3])]),
                         eng.put([1], [np.array([4, 5])])])
uids = [0, 1]
tables = eng.state.block_table(uids, eng.config.blocks_per_seq, eng.pad_block)
ctx = np.array([eng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
gen, last, _, _ = eng.decode_multi_fn(2, 4)(eng.params, eng.cache,
                                            np.array([6, 7], np.int32), tables, ctx)
assert np.isfinite(logits).all() and torch.isfinite(last).all()
assert gen.shape == (4, 2)
from deepspeed_tpu_torch import initialize
tcfg = T.TransformerConfig(vocab_size=512, n_layers=2, n_heads=2, d_model=256,
                           max_seq=256, variant="llama", remat="save_attn_qkv")
trainer = initialize({"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True},
                      "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                      "gradient_clipping": 1.0},
                     loss_fn=T.make_loss_fn(tcfg, loss_chunks=4),
                     param_init_fn=lambda g: T.init(tcfg, g, device="cpu"), device="cpu")
m = trainer.train_batch({"tokens": r.integers(0, 512, (2, 33)).astype(np.int32)})
assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]), m
assert K.launch_counts() == {n: 0 for n in K.WRAPPERS}  # CPU: no kernel launched
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "deepspeed_tpu" or m.startswith("deepspeed_tpu."))
print("LEAKED", bad)
assert not bad, bad
"""


def test_port_runs_without_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _SLICE], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_no_source_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|deepspeed_tpu)\b", re.M)
    files = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert not hits, hits
