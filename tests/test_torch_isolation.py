"""The port stands alone: it imports neither JAX nor the JAX package.

A fresh interpreter imports the port, serves a tiny model on the CPU end
to end (prefill, single-token decode, chunked continuation, greedy
decode_multi) from f32 and from int8 KV pools, drives the serving
scheduler under pressure (spill to the host tier and resume, a corrupted
spill caught by its digest, inference/ and resilience/), generate(), and
an int8 export_kv/import_kv, takes one bf16 train step through `initialize` and runs
one forward and backward of `ds4sci_evoformer_attention` with both
biases; no kernel may launch, and afterwards neither `jax` nor
`deepspeed_tpu` may be in sys.modules. A static scan of the port's sources and chip_smoke.py backs
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
q8 = init_inference(params, cfg, dict(max_seq_len=128, kv_block_size=16, num_kv_blocks=32,
                    min_prefill_bucket=16, max_batch_size=16, kv_cache_dtype="int8"),
                    dtype=torch.float32, device="cpu")
l8 = np.concatenate([q8.put([0, 1], [r.integers(0, 512, 24), r.integers(0, 512, 9)]),
                     q8.put([0], [np.array([3])]), q8.put([1], [np.array([4, 5])])])
gen8, last8, _, _ = q8.decode_multi_fn(2, 4)(q8.params, q8.cache, np.array([6, 7], np.int32),
                                             tables, ctx)
assert np.isfinite(l8).all() and torch.isfinite(last8).all() and q8.cache.quantized
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
from deepspeed_tpu_torch.ops.evoformer_attention import ds4sci_evoformer_attention
qkv = [torch.from_numpy(r.standard_normal((1, 2, 40, 2, 32)).astype(np.float32)).requires_grad_()
       for _ in range(3)]
mask = torch.from_numpy(np.where(r.random((1, 2, 1, 1, 40)) < 0.1, -1e9, 0.0).astype(np.float32))
pair = torch.from_numpy(r.standard_normal((1, 1, 2, 40, 40)).astype(np.float32)).requires_grad_()
ds4sci_evoformer_attention(*qkv, [mask, pair]).sum().backward()
assert all(torch.isfinite(x.grad).all() for x in qkv + [pair])
from deepspeed_tpu_torch.inference import ServingScheduler, ServingSchedulerConfig
from deepspeed_tpu_torch.resilience import armed
small = init_inference(params, cfg, dict(max_seq_len=128, kv_block_size=16, num_kv_blocks=6,
                       min_prefill_bucket=16, max_batch_size=16), dtype=torch.float32,
                       device="cpu")
sched = ServingScheduler(small, ServingSchedulerConfig(
    prefill_chunk=8, max_num_batched_tokens=32, decode_chunk=4, warmup=False,
    pressure={"enabled": True, "yellow": 0.6, "red": 0.7, "brownout": 1.0}))
rids = [sched.submit(list(r.integers(0, 512, n)), 24) for n in (20, 30, 12, 25)]
with armed({"faults": [{"point": "handoff.payload", "kind": "corrupt", "at": 2}]}):
    sched.run()
assert all(len(sched.finished[i].output) == 24 for i in rids), sched.counters
assert sched.counters["spill_resumes"] > 0, sched.counters
assert sched.counters["spill_integrity_failures"] == 1, sched.counters
assert eng.generate([[1, 2, 3]], max_new_tokens=4, do_sample=True, seed=3)
q8.put([9], [r.integers(0, 512, 40)])
q8.import_kv(10, q8.export_kv(9))
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
    files = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                   ROOT / "port_timing.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert not hits, hits
