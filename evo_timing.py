#!/usr/bin/env python3
"""Time the port's evoformer attention path in one or more checkouts, in
turns, on one GPU.

    python3 evo_timing.py [ROOT ...]   # default: this checkout

ROOT is a directory holding a `deepspeed_tpu_torch/` package (this checkout,
or an older commit unpacked with `git archive <commit> deepspeed_tpu_torch |
tar -x -C ROOT`). Give the roots in the order to run them, e.g. `OLD NEW NEW
OLD`, to compare two versions on one card. For each, a fresh Python process
imports that root's package, builds its evoformer kernels from its own
sources (into ROOT/build/kernels) and, at the evoformer cases E1-E3 of
chip_smoke.py (bf16, both biases, inputs from a seeded generator), times
`ds4sci_evoformer_attention`'s forward and forward+backward (gradients of
q, k, v and both biases): CUDA events around 10 back-to-back calls after 3
warm-ups, the median of 3 such runs. It also records each evoformer
kernel's device time per call over 5 forward+backward calls
(torch.profiler). Prints one JSON line per root, then the card's name and
power limit as nvidia-smi gives them. Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _events_ms(torch, fn, iters=10, warmup=3, runs=3):
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / iters)
    return statistics.median(out)


def _kernel_ms(torch, fn, iters=5):
    """Device ms per call of each evoformer kernel (by its name's first 60
    characters) over `iters` calls of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and "evo_" in e.name():
            key = e.name()[:60]
            out[key] = out.get(key, 0.0) + e.duration_ns() / 1e6 / iters
    return out


def worker(root):
    """Time one checkout (runs in its own process)."""
    root = Path(root).resolve()
    sys.path[:0] = [str(root), str(HERE)]  # the root's package; this checkout's chip_smoke.py
    import torch

    from chip_smoke import EVO_CASES, _evo_inputs

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.cuda import build
    from deepspeed_tpu_torch.ops.evoformer_attention import ds4sci_evoformer_attention

    if not Path(deepspeed_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {deepspeed_tpu_torch.__file__}, not the package in {root}")
    build.build_all([n for n in build.SOURCES if n.startswith("evoformer")])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": str(root), "cases": {}}
    for i, (name, case) in enumerate(EVO_CASES.items()):
        q, k, v, b1, b2, do = _evo_inputs(case, dev, seed=10 + i)
        leaves = [x.clone().requires_grad_() for x in (q, k, v, b1, b2)]
        fwd = lambda: ds4sci_evoformer_attention(q, k, v, [b1, b2])

        def fwd_bwd():
            o = ds4sci_evoformer_attention(leaves[0], leaves[1], leaves[2], leaves[3:])
            return torch.autograd.grad(o, leaves, do)

        with torch.no_grad():
            fwd_ms = _events_ms(torch, fwd)
        out["cases"][name] = {"shape": [case[x] for x in "BSNHD"], "fwd_ms": fwd_ms,
                              "fwd_bwd_ms": _events_ms(torch, fwd_bwd),
                              "kernel_device_ms": _kernel_ms(torch, fwd_bwd)}
        del q, k, v, b1, b2, do, leaves
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main(roots):
    import torch

    if not torch.cuda.is_available():
        sys.exit("evo_timing.py: no CUDA device")
    for root in roots or [str(HERE)]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root], check=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(gpu.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        main(sys.argv[1:])
