#!/usr/bin/env python3
"""Time the port on one GPU, in one or more checkouts, in turns.

    python3 port_timing.py MODE [ROOT ...]   # default ROOT: this checkout

ROOT is a directory holding a `deepspeed_tpu_torch/` package (this checkout,
or an older commit unpacked with `git archive <commit> deepspeed_tpu_torch |
tar -x -C ROOT`). Give the roots in the order to run them, e.g. `OLD NEW NEW
OLD`, to compare two versions on one card. For each root a fresh Python
process imports that root's package and builds the kernels MODE needs from
its own sources (into ROOT/build/kernels); the shapes, models and helpers
are this checkout's chip_smoke.py. Prints one JSON line per root, then the
card's name and power limit as nvidia-smi gives them. Imports nothing of
JAX.

MODE:
- evo: at the evoformer cases E1-E3 of chip_smoke.py (bf16, both biases,
  inputs from a seeded generator), `ds4sci_evoformer_attention`'s forward
  and forward+backward (gradients of q, k, v and both biases): CUDA events
  around 10 back-to-back calls after 3 warm-ups, the median of 3 such runs;
  and where a forward+backward's device time goes, per call over 5 of them
  (torch.profiler): each evoformer kernel, the torch ops of the wrapper's
  `_delta` (delta = rowsum(dO * O)) and `_db1` (bias1's head sum), the
  rest, and the busy total.
- serve: every model chip_smoke.py serves (the flagship and SERVED_7B, at
  full width and depth, random bf16 weights from seed 0), from bf16 and
  from int8 KV pools: the long prompt (the 7B models) and the wave of
  96-token prompts (64 for the flagship), then greedy decode_multi_fn(b,
  24) over the first b rows (the 7B models: b = 8; the flagship: b = 8, 32
  and 64, and chip_smoke's sampled lane at 32), eagerly and, where the
  root has warmup()'s CUDA graphs, replayed: the median and the least of
  5 CUDA-event timings of one call (after one warm-up), decode tok/s = b x
  24 / the median, the host's time to issue the call (until it returns,
  the card still working), and where the time of one call goes
  (torch.profiler: busy and idle share, the largest kernels). A root
  without the sampled lane or warmup() gives the eager greedy numbers
  only. Also the decode wrapper's own cost at the flagship's decode
  shape (8 rows, 8 heads of 128, 1024-position tables), where the kernel
  is shorter than its launch: 5 runs of 200 back-to-back
  paged_decode_fused calls, CUDA-event ms a call and host us a call, the
  median and the least of the runs.
- serve8w: the per-channel int8 weight lane (chip_smoke.py's serve_int8w
  engines, from bf16 pools) beside the bf16 engine of the same weights:
  the flagship (random bf16 weights from seed 0, 64 rows of 96 tokens,
  greedy decode_multi_fn(b, 24) at b = 8 and 64) and Llama-2-7B at
  bench.py's widths (weights built and quantized layer by layer, 32 rows,
  b = 1, 8 and 32), eagerly and replayed after warmup(), as `serve` times
  them, and each engine's TTFT at chip_smoke's LONG_LEN (512 tokens); and
  the W8A16 GEMM alone (int8_matmul) at the two models' products and
  Falcon-7B's mlp_out (GEMM_SHAPES) for M = 1, 8, 32, 64 (decode) and 512,
  768, 4096 (prefill): device ms a call, cold (the weights rotated through
  copies that total more than twice the 50 MB L2, as a step finds them)
  and warm, beside cuBLAS bf16 timed the same two ways and the bound. A
  root whose engine takes no `quantization` raises: this mode compares
  versions of the int8 lane.
- gemm: the W8A16 GEMM alone as serve8w times it, and in a root whose
  wrapper has the wgmma plan also each alternative plan of
  _gemm_variants (other token widths and grids) forced in its place,
  cold: the sweep that sets matmul_split_plan's rules.
- splits: the decode kernel's device time (torch.profiler) at chip_smoke.py's
  phase-2 decode rows (Falcon-7B, Mistral's window, BLOOM-7B1, Phi-2) and
  the flagship's, fused bf16 and int8, for split counts 1, 2, 4, ... forced
  in place of decode_split_plan, beside the plan's own choice.
- write: #6's int8 write (paged_kv_write_int8) at chip_smoke.py's
  KV_WRITE_CASES (the flagship's prefill wave, Phi-2's, Mistral 7B's and
  Falcon-7B's prefills; inputs from a seeded generator): device ms a call
  (torch.profiler over 50 calls), the median of 3 such and each, and its
  byte bound; the static SASS instruction count of each
  instantiation of the int8 kernel (cuobjdump, where the toolkit has it);
  and #6's share of one int8 prefill: where the device time of a Mistral
  7B put() of a fresh 6144-token prompt goes (torch.profiler: busy, idle
  share, the int8 write's kernels' ms and share of busy), the model at
  full width and depth from int8 pools, random bf16 weights from seed 0.
- tiles: where a 64-column tile's time goes in the one-CTA-a-row decode
  kernel that split-K replaced (ROOT a checkout of that kernel: one CTA
  walks its row's whole context, 8 query heads a CTA; its source has the
  anchors of _CLOCK_PATCHES, and another source raises): a copy of ROOT's
  csrc/paged_decode.cu with clock64() counters read by thread 0 at the tile
  loop's phase boundaries, built beside ROOT (ROOT/build/decode_clk), at
  Falcon-7B's, Mistral's and BLOOM-7B1's phase-2 decode rows, bf16 and
  int8 fused: cycles a tile by phase summed over all CTAs, and the longest
  CTA's loop cycles.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _import_root(root):
    """Put ROOT's package first on the path (this checkout's chip_smoke.py
    next), check that it is the one imported, and return chip_smoke."""
    root = Path(root).resolve()
    sys.path[:0] = [str(root), str(HERE)]
    import chip_smoke
    import deepspeed_tpu_torch

    if not Path(deepspeed_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {deepspeed_tpu_torch.__file__}, not the package in {root}")
    return root, chip_smoke


def _seeded_randn(torch, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# evo: the evoformer attention path
# ---------------------------------------------------------------------------

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


# the torch functions of the evoformer wrapper around its kernels, timed by name
EVO_AROUND = ("_delta", "_db1")


def _kernel_ms(torch, EV, fn, iters=5):
    """Device ms per call over `iters` calls of fn: each evoformer kernel
    (by its name's first 60 characters), and the torch ops around them:
    those `_delta` launches (delta's casts, product and sum), those `_db1`
    launches (bias1's gradient, the head sum of the row sums; each traced
    in a profiler range while this runs), the rest ("other": autograd's
    and the wrapper's casts and copies) and the sum of all ("busy")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def traced(name, f):
        def run(*args):
            with record_function(f"evo::{name}"):
                return f(*args)
        return run

    fn()
    torch.cuda.synchronize()
    saved = {n: getattr(EV, n) for n in EVO_AROUND}
    try:
        for n, f in saved.items():
            setattr(EV, n, traced(n, f))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    finally:
        for n, f in saved.items():
            setattr(EV, n, f)
    kernels, busy = {}, 0.0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        ms = e.duration_ns() / 1e6 / iters
        busy += ms
        if "evo_" in e.name():
            key = e.name()[:60]
            kernels[key] = kernels.get(key, 0.0) + ms
    around = {n: 0.0 for n in EVO_AROUND}
    for a in prof.key_averages():
        if a.key.startswith("evo::"):
            us = getattr(a, "device_time_total", None)
            around[a.key[5:]] = (a.cuda_time_total if us is None else us) / 1e3 / iters
    around["other"] = busy - sum(kernels.values()) - sum(around.values())
    around["busy"] = busy
    return kernels, around


def evo_worker(root):
    root, C = _import_root(root)
    import torch

    from deepspeed_tpu_torch.ops.cuda import build
    from deepspeed_tpu_torch.ops.cuda import evoformer_attention as EV
    from deepspeed_tpu_torch.ops.evoformer_attention import ds4sci_evoformer_attention

    build.build_all([n for n in build.SOURCES if n.startswith("evoformer")])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"mode": "evo", "root": str(root), "cases": {}}
    for i, (name, case) in enumerate(C.EVO_CASES.items()):
        q, k, v, b1, b2, do = C._evo_inputs(case, dev, seed=10 + i)
        leaves = [x.clone().requires_grad_() for x in (q, k, v, b1, b2)]
        fwd = lambda: ds4sci_evoformer_attention(q, k, v, [b1, b2])

        def fwd_bwd():
            o = ds4sci_evoformer_attention(leaves[0], leaves[1], leaves[2], leaves[3:])
            return torch.autograd.grad(o, leaves, do)

        with torch.no_grad():
            fwd_ms = _events_ms(torch, fwd)
        kernels, around = _kernel_ms(torch, EV, fwd_bwd)
        out["cases"][name] = {"shape": [case[x] for x in "BSNHD"], "fwd_ms": fwd_ms,
                              "fwd_bwd_ms": _events_ms(torch, fwd_bwd),
                              "kernel_device_ms": kernels, "around_kernels_device_ms": around}
        del q, k, v, b1, b2, do, leaves
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# serve: decode tok/s of every served model, and the decode wrapper's cost
# ---------------------------------------------------------------------------

def _served_models(C):
    """name -> (model, serving config, long prompt's tokens (0: none),
    96-token prompts, prompt seed): chip_smoke.py's flagship (phase
    serve_graphs: 64 prompts) and SERVED_7B (phases serve_<mode>: 8 rows)."""
    out = {"flagship": (C.FLAGSHIP, C.SERVE_G, 0, C.GRAPH_PROMPTS, 0)}
    for mode, model in C.SERVED_7B:
        serve, n_long, n_wave, seed, _ = C.SERVE_LONG[mode]
        out[mode] = (model, serve, n_long, n_wave, seed)
    return out


def _decode_rates(C, eng, V, n_long, n_wave, seed, widths, sampled_width=0):
    """Prefill the rows (a long prompt when n_long, then n_wave 96-token
    prompts), then for each width b the greedy decode_multi_fn(b, 24) over
    the first b rows, eagerly and, where the root's engine has warmup()
    (its CUDA graphs), replayed; with sampled_width, the sampled lane
    (chip_smoke.SAMPLED_LANE, keys _row_keys(0, arange(b)), counters from
    ctx) at that width likewise. A root without the sampled lane or
    warmup leaves those entries out."""
    import numpy as np

    r = np.random.default_rng(seed)
    last, rows = {}, []
    if n_long:
        last[100] = eng.put([100], [r.integers(0, V, n_long).astype(np.int32)])[0]
        rows.append(100)
    uids = list(range(n_wave))
    wave = eng.put(uids, [r.integers(0, V, C.PROMPT_LEN).astype(np.int32) for _ in uids])
    last.update({u: wave[u] for u in uids})
    rows += uids
    calls = {}
    for b in widths:
        tables = eng.state.block_table(rows[:b], eng.config.blocks_per_seq, eng.pad_block)
        ctx = np.array([eng.state.get(u).seen_tokens + 1 for u in rows[:b]], np.int32)
        toks = np.array([last[u].argmax() for u in rows[:b]], np.int32)
        calls[f"b{b}"] = (eng.decode_multi_fn(b, C.DECODE_STEPS), (toks, tables, ctx))
    if sampled_width:
        try:
            from deepspeed_tpu_torch.inference.sampling import SamplingConfig
        except ImportError:
            sampled_width = 0
    if sampled_width:
        fn, (toks, tables, ctx) = calls[f"b{sampled_width}"]
        calls[f"sampled_b{sampled_width}"] = (
            eng.decode_multi_fn(sampled_width, C.DECODE_STEPS,
                                sampling=SamplingConfig(**C.SAMPLED_LANE)),
            (toks, tables, ctx, eng._row_keys(0, np.arange(sampled_width)), ctx.copy()))
    out = {}
    for name, (fn, args) in calls.items():
        eager = dict(eng.params)  # not the engine's dict: never replayed
        out[name] = {"ctx": [int(args[2].min()), int(args[2].max())],
                     "eager": C._decode_call_stats(lambda: fn(eager, eng.cache, *args),
                                                   len(args[0]), runs=5)}
    if hasattr(eng, "graphs"):
        eng.warmup(widths=list(widths), decode_chunks=[C.DECODE_STEPS])
        if sampled_width:
            eng.warmup(sampling=C.SAMPLED_LANE, widths=[sampled_width],
                       decode_chunks=[C.DECODE_STEPS])
        for name, (fn, args) in calls.items():
            out[name]["replayed"] = C._decode_call_stats(
                lambda: fn(eng.params, eng.cache, *args), len(args[0]), runs=5)
    return out


def _wrapper_cost(C, torch, PA, dev, iters=200, runs=5):
    """paged_decode_fused at the flagship's decode shape: CUDA-event ms a
    call and host us a call over `iters` back-to-back calls, the median and
    the least of `runs`."""
    H = KV = C.FLAGSHIP["n_heads"]
    D = C.FLAGSHIP["d_model"] // H
    bs = C.SERVE["kv_block_size"]
    NB = -(-C.SERVE["max_seq_len"] // bs)
    ctx_list = [C.PROMPT_LEN + 1 + 3 * i for i in range(C.N_PROMPTS)]
    _, call, run = C._decode_fixture(PA, _seeded_randn(torch, dev, 31), dev, H, KV, D, bs, NB,
                                     ctx_list, 31)
    pools = run("paged_decode_fused", 0)[1]
    fn = lambda: call("paged_decode_fused", 0, pools)
    call_ms, host_us = [], []
    for _ in range(runs):
        call_ms.append(C._time_ms(fn, iters))
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        host_us.append((time.perf_counter() - t) / iters * 1e6)
        torch.cuda.synchronize()
    return {"call_ms": statistics.median(call_ms), "call_ms_least": min(call_ms),
            "host_us": statistics.median(host_us), "host_us_least": min(host_us),
            "host_us_runs": host_us}


def serve_worker(root):
    root, C = _import_root(root)
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops.cuda import build
    from deepspeed_tpu_torch.ops.cuda import paged_attention as PA

    build.build_all(["paged_kv_write", "paged_decode", "flash_fwd"])
    dev = torch.device("cuda")
    out = {"mode": "serve", "root": str(root),
           "decode_wrapper_at_flagship": _wrapper_cost(C, torch, PA, dev), "models": {}}
    for name, (model, serve, n_long, n_wave, seed) in _served_models(C).items():
        cfg = T.TransformerConfig(**model)
        params = C._init_served(T, cfg, dev)
        flagship = name == "flagship"
        for dtype in ("bf16", "int8"):
            eng = init_inference(params, cfg, dict(serve, kv_cache_dtype=(
                "int8" if dtype == "int8" else "auto")))
            params = eng.params  # the serving layout, for the int8 engine
            out["models"][f"{name}/{dtype}"] = _decode_rates(
                C, eng, cfg.vocab_size, n_long, n_wave, seed,
                C.GRAPH_WIDTHS if flagship else (n_wave + bool(n_long),),
                C.SAMPLED_WIDTH if flagship else 0)
            del eng
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    return out


# the W8A16 GEMM's products timed by serve8w and gemm: the flagship's and
# Llama-2-7B's (chip_smoke.INT8_MM_SHAPES), and Falcon-7B's 18176-deep
# mlp_out; decode rows and the prefill waves (512: a 512-token prompt;
# 768: _serving_bench's 8 x 96 wave; 4096)
GEMM_SHAPES = ("flagship_qkv", "flagship_wo", "flagship_gate_up", "flagship_down",
               "flagship_logits", "llama2_7b_qkv", "llama2_7b_wo", "llama2_7b_gate_up",
               "llama2_7b_down", "llama2_7b_logits", "falcon_7b_mlp_out")
GEMM_M = (1, 8, 32, 64, 512, 768, 4096)


def _gemm_variants(IM, M, N, K, sms):
    """name -> plan: the alternatives to the root's own plan that `gemm`
    times (the next token width at decode; grids of one wave of balanced
    CTAs, of one CTA a tile and of at least 4 units a CTA), where the
    root's wrapper has the wgmma plan; else none."""
    if not hasattr(IM, "TOKEN_WIDTHS"):
        return {}
    tn0 = IM.token_width(M)
    out = {}
    for tn in (tn0, 2 * tn0) if tn0 <= 64 else (tn0,):
        base = IM.matmul_split_plan_for(M, N, K, sms, tn)
        for ctas in sorted({sms, base.tiles, max(1, min(sms, base.units // 4))}):
            if ctas <= min(base.units, 8 * sms):
                out[f"tn{tn}_ctas{ctas}"] = IM.matmul_split_plan_for(M, N, K, ctas, tn)
    return out


def _gemm_ms(C, torch, IM, dev, Ms=GEMM_M, variants=False):
    """The W8A16 GEMM's device ms a call (torch.profiler, chip_smoke's
    _device_ms) at GEMM_SHAPES for each M, in the form each path uses,
    cold (_cold_ms: the weights rotated through copies that total more
    than twice the 50 MB L2, as a step finds them) and warm (the same
    weights back to back), beside cuBLAS bf16 on the codes as bf16 weights
    (the yardstick, timed the same two ways) and the bound. With
    `variants`, each of _gemm_variants' plans too (cold), forced in place
    of the root's plan."""
    from deepspeed_tpu_torch.platform.accelerator import bound_ms

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for name in GEMM_SHAPES:
        N, K, f32 = C.INT8_MM_SHAPES[name]
        x_all, q, s = C._int8_mm_inputs(N, K, max(Ms), dev,
                                        seed=100 + list(C.INT8_MM_SHAPES).index(name))
        copies = C._weight_copies(lambda: (q.clone(), s.clone()), N * K)
        w16 = q.to(torch.bfloat16)
        w16s = C._weight_copies(lambda: (w16.clone(),), 2 * N * K)
        for M in Ms:
            x = x_all[:M].contiguous()
            iters = 20 if M <= 64 else 5
            kern = lambda q_, s_: IM.int8_matmul(x, q_, s_, f32)
            row = {"bound_ms": bound_ms(M * K * 2 + N * K + N * 4 + M * N * (4 if f32 else 2),
                                        2.0 * M * N * K)[0],
                   "cold_ms": C._cold_ms(kern, copies, iters),
                   "warm_ms": C._device_ms(lambda: kern(q, s), iters),
                   "cublas_bf16_cold_ms": C._cold_ms(lambda w: x @ w.t(), w16s, iters),
                   "cublas_bf16_warm_ms": C._device_ms(lambda: x @ w16.t(), iters)}
            if hasattr(IM, "TOKEN_WIDTHS"):
                row["plan"] = IM.matmul_split_plan(M, N, K, sms)._asdict()
            if variants:
                own = IM.matmul_split_plan
                row["variants"] = {}
                try:
                    for vname, plan in _gemm_variants(IM, M, N, K, sms).items():
                        IM.matmul_split_plan = lambda *a, plan=plan: plan
                        row["variants"][vname] = C._cold_ms(kern, copies, iters)
                finally:
                    IM.matmul_split_plan = own
            out[f"{name}/M{M}"] = row
        del x_all, q, s, copies, w16, w16s
        torch.cuda.empty_cache()
    return out


def gemm_worker(root):
    root, C = _import_root(root)
    import torch

    from deepspeed_tpu_torch.ops.cuda import build
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as IM

    build.build_all(["int8_matmul"])
    return {"mode": "gemm", "root": str(root),
            "gemm": _gemm_ms(C, torch, IM, torch.device("cuda"), variants=True)}


def _lane(C, eng, V, n_wave, seed, widths):
    """_decode_rates of an engine, then its TTFT at chip_smoke's LONG_LEN
    (chip_smoke._ttft: CUDA events around put() of a fresh prompt, 5
    after 2 warm-ups) and their median."""
    import numpy as np

    out = _decode_rates(C, eng, V, 0, n_wave, seed, widths)
    ttft = C._ttft(eng, np.random.default_rng(seed + 7), V, C.LONG_LEN)
    out[f"ttft_ms_{C.LONG_LEN}"] = {"p50": statistics.median(ttft), "all": ttft}
    return out


def serve8w_worker(root):
    root, C = _import_root(root)
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference import model as M
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops.cuda import build
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as IM

    build.build_all(["paged_kv_write", "paged_decode", "flash_fwd", "int8_matmul"])
    dev = torch.device("cuda")
    out = {"mode": "serve8w", "root": str(root), "gemm": _gemm_ms(C, torch, IM, dev),
           "models": {}}
    cfg = T.TransformerConfig(**C.FLAGSHIP)
    params = C._init_served(T, cfg, dev)
    for lane, quant in (("int8w", C.INT8W), ("bf16", None)):
        eng = init_inference(params, cfg, dict(C.SERVE_G), quantization=quant)
        out["models"][f"flagship/{lane}"] = _lane(C, eng, cfg.vocab_size, C.GRAPH_PROMPTS, 0,
                                                  C.INT8W_FLAGSHIP_WIDTHS)
        del eng
        torch.cuda.empty_cache()
    del params
    mc = T.TransformerConfig(**C.LLAMA2_7B_BENCH)
    trees = dict(zip(("bf16", "int8w"), C._int8w_7b_weights(T, M, mc, dev)))
    torch.cuda.empty_cache()
    for lane in ("int8w", "bf16"):
        eng = init_inference(trees.pop(lane), mc, dict(C.SERVE_7B_INT8W),
                             quantization=C.INT8W if lane == "int8w" else None)
        out["models"][f"llama2_7b/{lane}"] = _lane(C, eng, mc.vocab_size,
                                                   max(C.INT8W_7B_WIDTHS), 1, C.INT8W_7B_WIDTHS)
        del eng
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# splits: the decode kernel at forced split counts
# ---------------------------------------------------------------------------

def _decode_cases(C):
    """name -> (H, KV, D, serving config, decode rows' ctx, window): the
    phase-2 decode rows of chip_smoke.py and the flagship's decode."""
    return {"falcon_7b": (71, 1, 64, C.SERVE_A, C.DECODE_FP_CTX, 0),
            "mistral_window_4096": (32, 8, 128, C.SERVE_W, C.DECODE_W_CTX, C.WINDOW),
            "bloom_alibi": (32, 32, 128, C.SERVE_A, C.DECODE_ALIBI_CTX, 0),
            "phi_2": (32, 32, 80, C.SERVE_A, C.DECODE_FP_CTX, 0),
            "flagship": (8, 8, 128, C.SERVE,
                         [C.PROMPT_LEN + 1 + 3 * i for i in range(C.N_PROMPTS)], 0)}


def splits_worker(root):
    root, C = _import_root(root)
    import torch

    from deepspeed_tpu_torch.ops.cuda import build
    from deepspeed_tpu_torch.ops.cuda import paged_attention as PA

    build.build_all(["paged_decode"])
    dev = torch.device("cuda")
    randn = _seeded_randn(torch, dev, 1)
    plan = PA.decode_split_plan
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"mode": "splits", "root": str(root), "cases": {}}
    for case, (H, KV, D, serve, ctx_list, window) in _decode_cases(C).items():
        bs = serve["kv_block_size"]
        NB = -(-serve["max_seq_len"] // bs)
        x, call, run = C._decode_fixture(PA, randn, dev, H, KV, D, bs, NB, list(ctx_list), 5)
        own = plan(len(ctx_list), KV, H // KV, D, NB * bs, sms)
        res = {"plan": {"n": own.n, "split_len": own.split_len}}
        for name in ("paged_decode_fused", "paged_decode_fused_int8"):
            pools = run(name, window)[1]
            times = {}
            for n in sorted({1, 2, 4, 8, 16, 32, own.n}):
                forced = PA.decode_split_plan_for(len(ctx_list), KV, H // KV, D, NB * bs, n)
                PA.decode_split_plan = lambda *a, _p=forced: _p
                try:
                    times[forced.n] = C._device_ms(lambda: call(name, window, pools), 20)
                finally:
                    PA.decode_split_plan = plan
            res[name] = times
        out["cases"][case] = res
        del x, call, run
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# tiles: the phases of the one-CTA-a-row kernel's tile loop, by clock64()
# ---------------------------------------------------------------------------

# (anchor, text put after it, or before it when the anchor starts with
# "<"): the phases of the tile loop of the one-CTA-a-row kernel are the K/V
# staging with its barrier, the warp-shuffle scores, the online softmax and
# the scalar P V; thread 0 adds each phase's cycles, and at the end flushes
# them, its tile count and its loop's cycles to g_decode_clk
_FLUSH = """  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) atomicAdd(&g_decode_clk[i], (unsigned long long)_ph[i]);
    atomicAdd(&g_decode_clk[5], (unsigned long long)_nt);
    const unsigned long long cta = (unsigned long long)(clock64() - _cs);
    atomicAdd(&g_decode_clk[6], cta);
    atomicMax(&g_decode_clk[7], cta);
    atomicAdd(&g_decode_clk[8], 1ull);
    atomicAdd(&g_decode_clk[9], (unsigned long long)(_cs - _cb));
  }
"""
_CLOCK_PATCHES = (
    ("<namespace {\n", "__device__ unsigned long long g_decode_clk[10];\n"),
    ("  const int tid = threadIdx.x;\n", "  const long long _cb = clock64();\n"),
    ("  const int32_t* allow = allowed ? allowed + (size_t)s * table_width : nullptr;\n",
     "  long long _ph[4] = {0, 0, 0, 0};\n  long long _nt = 0;\n"
     "  const long long _cs = clock64();\n"),
    ("  for (int c0 = start;;) {\n", "    const long long _c0 = clock64();\n"),
    ("<\n    // scores: warp w takes columns", "\n    const long long _c1 = clock64();"),
    ("<\n    // online softmax: warp w takes heads", "\n    const long long _c2 = clock64();"),
    ("<\n    // P V: thread tid owns column tid", "\n    const long long _c3 = clock64();"),
    ("<    c0 = end;\n  }\n", """    if (threadIdx.x == 0) {
      _ph[0] += _c1 - _c0; _ph[1] += _c2 - _c1; _ph[2] += _c3 - _c2;
      _ph[3] += clock64() - _c3; ++_nt;
    }
"""),
    ("    c0 = end;\n  }\n", _FLUSH))
_CLOCK_READ = """
extern "C" int decode_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_decode_clk, sizeof(g_decode_clk));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_decode_clk, zero, sizeof(zero));
}
"""
PHASES = ("stage_kv_and_barrier", "scores_warp_shuffle", "online_softmax", "p_v_scalar")


def _clock_source(src):
    """The one-CTA-a-row kernel's source with the clock64() counters."""
    for anchor, text in _CLOCK_PATCHES:
        before = anchor.startswith("<")
        anchor = anchor.lstrip("<")
        if src.count(anchor) != 1:
            raise RuntimeError("ROOT's csrc/paged_decode.cu is not the one-CTA-a-row kernel: "
                               f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, text + anchor if before else anchor + text)
    return src + _CLOCK_READ


def tiles_worker(root):
    root, C = _import_root(root)
    import ctypes

    import torch

    from deepspeed_tpu_torch.ops.cuda import build
    from deepspeed_tpu_torch.ops.cuda import paged_attention as PA

    work = root / "build" / "decode_clk"
    csrc = work / "csrc"
    shutil.rmtree(work, ignore_errors=True)
    csrc.mkdir(parents=True)
    for h in build.CSRC.glob("*.cuh"):
        shutil.copy(h, csrc)
    (csrc / "paged_decode.cu").write_text(_clock_source((build.CSRC / "paged_decode.cu")
                                                        .read_text()))
    build.CSRC, build.BUILD_DIR = csrc, work / "kernels"
    lib = build.load("paged_decode")
    lib.decode_clocks.argtypes = [ctypes.c_void_p]
    lib.decode_clocks.restype = ctypes.c_int
    clocks = (ctypes.c_ulonglong * 10)()
    dev = torch.device("cuda")
    randn = _seeded_randn(torch, dev, 1)
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, timeout=60, check=True).stdout.split()[0])
    out = {"mode": "tiles", "root": str(root), "sm_clock_max_mhz": mhz, "cases": {}}
    cases = {k: v for k, v in _decode_cases(C).items()
             if k in ("falcon_7b", "mistral_window_4096", "bloom_alibi")}
    for case, (H, KV, D, serve, ctx_list, window) in cases.items():
        bs = serve["kv_block_size"]
        NB = serve["max_seq_len"] // bs
        x, call, run = C._decode_fixture(PA, randn, dev, H, KV, D, bs, NB, list(ctx_list), 5)
        for name in ("paged_decode_fused", "paged_decode_fused_int8"):
            pools = run(name, window)[1]
            call(name, window, pools)
            torch.cuda.synchronize()
            build.check(lib, lib.decode_clocks(clocks), "decode_clocks")  # reset
            call(name, window, pools)
            torch.cuda.synchronize()
            build.check(lib, lib.decode_clocks(clocks), "decode_clocks")
            ph, (n_tiles, cta_sum, cta_max, ctas, setup) = list(clocks[:4]), clocks[5:]
            tile_cycles = sum(ph) / max(n_tiles, 1)
            out["cases"][f"{case}/{name}"] = {
                "ctas": ctas, "tiles": n_tiles,
                "cycles_a_tile": tile_cycles,
                "us_a_tile_at_max_clock": tile_cycles / mhz,
                "cycles_a_tile_by_phase": {p: c / max(n_tiles, 1) for p, c in zip(PHASES, ph)},
                "share_by_phase": {p: c / max(sum(ph), 1) for p, c in zip(PHASES, ph)},
                "longest_cta_loop_cycles": cta_max,
                "longest_cta_loop_us_at_max_clock": cta_max / mhz,
                "mean_cta_loop_cycles": cta_sum / max(ctas, 1),
                "mean_cta_setup_cycles": setup / max(ctas, 1),
                "device_ms": C._device_ms(lambda: call(name, window, pools), 10)}
        del x, call, run
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# write: #6's int8 write at its bounding shapes, and its share of a prefill
# ---------------------------------------------------------------------------

def _sass_counts(lib_path, kernel="kv_write_int8_kernel"):
    """{instantiation: {"instructions": n, "FCHK"/"MUFU"/...: n}}: the
    static SASS of each entry function of the library whose mangled name
    holds `kernel` (cuobjdump -sass), or None where cuobjdump is missing."""
    import re

    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    if not tool.is_file():
        return None
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = None
            if kernel in m.group(1):
                ints = re.findall(r"L[ib](\d+)E", m.group(1))
                current = f"{kernel}<{','.join(ints)}>"
                out[current] = {"instructions": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if current and m:
            op = m.group(1)
            out[current]["instructions"] += 1
            if op in ("FCHK", "MUFU", "CALL", "LDG", "STG", "SHFL", "F2I", "BRA"):
                out[current][op] = out[current].get(op, 0) + 1
    return out


def _prefill_share(C, torch, dev):
    """Where one int8 Mistral 7B put() of a fresh W_LONG-token prompt spends
    its device time: busy ms, idle share, the ms of the int8 write's
    kernels and their share of busy (torch.profiler), after one warm-up
    put."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(**C.MISTRAL)
    eng = init_inference(C._init_served(T, cfg, dev), cfg, dict(C.SERVE_W, kv_cache_dtype="int8"))
    r = np.random.default_rng(0)
    prompt = lambda: r.integers(0, cfg.vocab_size, C.W_LONG).astype(np.int32)
    eng.put([1], [prompt()])
    eng.flush(1)
    p = prompt()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.put([2], [p])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = C._device_events(prof)
    busy = sum(us for _, us in events) / 1e3
    write = [us / 1e3 for n, us in events if "kv_write_int8" in n]
    del eng
    torch.cuda.empty_cache()
    return {"prompt_tokens": C.W_LONG, "wall_ms_profiled": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall, "write_launches": len(write),
            "write_ms": sum(write), "write_share_of_busy": sum(write) / busy}


def write_worker(root):
    root, C = _import_root(root)
    import torch

    from deepspeed_tpu_torch.ops.cuda import build
    from deepspeed_tpu_torch.ops.cuda import paged_attention as PA
    from deepspeed_tpu_torch.platform.accelerator import bound_ms

    libs = build.build_all(["paged_kv_write", "paged_decode", "flash_fwd"])
    dev = torch.device("cuda")
    out = {"mode": "write", "root": str(root), "sass": _sass_counts(libs["paged_kv_write"]),
           "cases": {}}
    for i, (name, case) in enumerate(C.KV_WRITE_CASES.items()):
        KV, D, T = case["KV"], case["D"], case["T"]
        x = C._kv_write_fixture(PA, _seeded_randn(torch, dev, 40 + i), dev, case)
        run = lambda: PA.paged_kv_write_int8(*x["pools"], x["kn"], x["vn"], x["slots"])
        ms = [C._device_ms(run, 50) for _ in range(3)]
        out["cases"][name] = {"shape": [T, x["n_live"], KV, D],
                              "device_ms": statistics.median(ms), "runs_ms": ms,
                              "bound_ms": bound_ms(x["bytes"], 0.0)[0]}
        del x, run
        torch.cuda.empty_cache()
    out["mistral_int8_prefill"] = _prefill_share(C, torch, dev)
    return out


WORKERS = {"evo": evo_worker, "serve": serve_worker, "serve8w": serve8w_worker,
           "gemm": gemm_worker, "splits": splits_worker, "tiles": tiles_worker,
           "write": write_worker}


def main(mode, roots):
    import torch

    if not torch.cuda.is_available():
        sys.exit("port_timing.py: no CUDA device")
    if mode not in WORKERS:
        sys.exit(f"port_timing.py: MODE must be one of {sorted(WORKERS)}")
    for root in roots or [str(HERE)]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", mode, root],
                       check=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(gpu.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        print(json.dumps(WORKERS[sys.argv[2]](sys.argv[3])), flush=True)
    elif len(sys.argv) < 2:
        sys.exit(__doc__)
    else:
        main(sys.argv[1], sys.argv[2:])
