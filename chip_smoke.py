#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (deepspeed_tpu_torch) starts
on one NVIDIA GPU and serves through its hand-written kernels.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (any failure raises and exits nonzero):

1. build   - compile every kernel of the serving path from
             deepspeed_tpu_torch/csrc/*.cu with nvcc for sm_90a, one nvcc per
             source, all in parallel (ops/cuda/build.py; into build/kernels/).
2. kernels - call each kernel's wrapper on CUDA tensors at the shapes the
             serving path gives it and hold the result against its plain
             PyTorch version on the same inputs; time kernel, plain version
             and (where one exists) a single PyTorch library call computing
             the same function: device time from torch.profiler, and the
             time of back-to-back calls from CUDA events.
3. slice   - init_inference on the flagship Llama (24 layers, d_model 1024,
             8 x 128 heads, vocab 32000, random weights from a seeded
             torch.Generator) in bf16, then drive the serving path once with
             every launch counter at 0: one prefill put of 8 x 96-token
             prompts plus one 512-token prompt, a single-token decode put, a
             2-token continuation put, and greedy decode_multi_fn(8, 24).
             Every kernel must have launched. Checks: finite logits and
             tokens in range; prefill and decode logits of the kernel path
             no further from the f32 plain path than the bf16 plain path
             is. Then times TTFT of a 512-token prompt and batch-8 decode
             throughput, and profiles where the time goes in each.
4. report  - one JSON line with every kernel's launches, error and times
             beside its bound; the card's name and power limit; and last,
             {"ok": true, "device": {...}}.

Exits nonzero without a result when no CUDA device is present or when the
package is not beside this script.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FLAGSHIP = dict(vocab_size=32000, n_layers=24, n_heads=8, d_model=1024, max_seq=2048,
                variant="llama")
SERVE = dict(max_seq_len=1024, kv_block_size=128, num_kv_blocks=64,
             min_prefill_bucket=64, max_batch_size=64)
N_PROMPTS, PROMPT_LEN, LONG_LEN, DECODE_STEPS = 8, 96, 512, 24
PROMPT_BUCKET = 128  # the prefill bucket of a 96-token prompt at min_prefill_bucket 64

# kernel -> (source, TPU kernel it replaces: the pl.pallas_call site)
KERNELS = {
    "paged_kv_write": ("deepspeed_tpu_torch/csrc/paged_kv_write.cu",
                       "deepspeed_tpu/ops/pallas/paged_attention.py:889"),
    "paged_decode_fused": ("deepspeed_tpu_torch/csrc/paged_decode.cu",
                           "deepspeed_tpu/ops/pallas/paged_attention.py:795"),
    "paged_decode_attention": ("deepspeed_tpu_torch/csrc/paged_decode.cu",
                               "deepspeed_tpu/ops/pallas/paged_attention.py:443"),
    "flash_fwd": ("deepspeed_tpu_torch/csrc/flash_fwd.cu",
                  "deepspeed_tpu/ops/pallas/flash_attention.py:233"),
}
# kernel vs plain version on the card, (atol, rtol): the KV write is a copy
# (bit-exact); decode keeps f32 probabilities, so only the bf16 rounding of
# the output differs, at most one bf16 ulp (2^-7 of the value: rtol 8e-3,
# atol 1e-3 near zero); flash also feeds bf16 probabilities to the tensor
# cores (another 2^-9 relative per term)
KERNEL_TOL = {"paged_kv_write": (0.0, 0.0), "paged_decode_fused": (1e-3, 8e-3),
              "paged_decode_attention": (1e-3, 8e-3), "flash_fwd": (2e-2, 2e-2)}
# engine logits: the kernel path and the plain path both run in bf16 and
# round at different places in each of 24 layers, so they are not compared
# with each other by a fixed tolerance; each is compared with the plain path
# in f32, and the kernel path's error must stay within these factors of
# the plain bf16 path's error (RMS and max over all logits)
PATH_RMS_FACTOR, PATH_MAX_FACTOR = 1.5, 2.0


def _require_environment():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    if not (ROOT / "deepspeed_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: deepspeed_tpu_torch/ is not beside {Path(__file__).name}; "
              "run it from the root of a checkout", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))


def _time_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _device_ms(fn, iters, warmup=3):
    """Device time per call: the summed duration of every kernel and copy
    the call ran on the card (torch.profiler over `iters` calls), with the
    host's launch overhead left out. Raises when the profiler saw no
    device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time (CUPTI tracing is off)")
    return us / 1e3 / iters


def _where_time_goes(fn, top=8):
    """Wall time of one call that ends synchronised (profiler overhead
    included), the card's busy time in it and the number of kernels and
    copies it ran (torch.profiler), the idle share, and the largest
    device-time consumers by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    n_device = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_device += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy, "device_ops": n_device,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "top_kernels_ms": {k[:80]: v for k, v in ranked}}


def _check_close(name, got, ref, atol, rtol):
    import torch

    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    if bool((err > limit).any()):
        raise AssertionError(f"{name}: max |kernel - plain| {err.max().item():.3e} beyond "
                             f"atol {atol} + rtol {rtol} * |plain|")
    return err.max().item()


def _path_errors(name, kernel, plain, ref32):
    """Errors of the bf16 kernel path and the bf16 plain path against the
    f32 plain path; raises if the kernel path is the worse one by more
    than PATH_*_FACTOR."""
    import torch

    if not torch.isfinite(kernel).all():
        raise AssertionError(f"{name}: kernel path is not finite")
    ek, ep = (kernel - ref32).abs(), (plain - ref32).abs()
    rms = lambda e: e.square().mean().sqrt().item()
    stats = {"kernel_vs_plain_max": (kernel - plain).abs().max().item(),
             "kernel_vs_f32_max": ek.max().item(), "plain_vs_f32_max": ep.max().item(),
             "kernel_vs_f32_rms": rms(ek), "plain_vs_f32_rms": rms(ep),
             "f32_rms": rms(ref32),
             "argmax_agree_kernel_f32": (kernel.argmax(-1) == ref32.argmax(-1)).float().mean().item()}
    if (stats["kernel_vs_f32_rms"] > PATH_RMS_FACTOR * stats["plain_vs_f32_rms"] + 1e-4
            or stats["kernel_vs_f32_max"] > PATH_MAX_FACTOR * stats["plain_vs_f32_max"] + 1e-3):
        raise AssertionError(f"{name}: kernel path is further from the f32 reference "
                             f"than the plain bf16 path allows: {stats}")
    return stats


def _timings(kernel, plain, library, iters):
    """ms / plain_ms / library_ms: device time per call (what the card
    spends); call_ms etc.: CUDA-event time per call made back to back from
    Python, which the host's launch overhead sets when it exceeds the
    device time."""
    return {"ms": _device_ms(kernel, iters), "plain_ms": _device_ms(plain, iters),
            "library_ms": None if library is None else _device_ms(library, iters),
            "call_ms": {"kernel": _time_ms(kernel, iters), "plain": _time_ms(plain, iters),
                        "library": None if library is None else _time_ms(library, iters)}}


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the serving shapes
# ---------------------------------------------------------------------------

def check_kernels(cfg, dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.cuda import flash_attention as FA
    from deepspeed_tpu_torch.ops.cuda import paged_attention as PA
    from deepspeed_tpu_torch.platform.accelerator import bound_ms

    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    bs, nblk = SERVE["kv_block_size"], SERVE["num_kv_blocks"] + 1
    NB = -(-SERVE["max_seq_len"] // bs)
    results = {}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(bf16)

    def arena():
        return randn(nblk, bs, KV, D), randn(nblk, bs, KV, D)

    # -- paged_kv_write: one prefill wave of 8 prompts of 96 tokens in the
    #    128-token bucket -> 8 x 128 rows, 8 x 96 live, 256 dropped (-1)
    Tp = PROMPT_BUCKET
    T = N_PROMPTS * Tp
    kn, vn = randn(T, KV, D), randn(T, KV, D)
    pos = torch.arange(Tp, device=dev)
    slots = (torch.arange(N_PROMPTS, device=dev)[:, None] * bs + pos[None, :])
    slots = torch.where(pos[None, :] < PROMPT_LEN, slots, -1).reshape(T).to(torch.int32)
    ka, va = arena()
    kb, vb = ka.clone(), va.clone()
    PA.paged_kv_write(ka, va, kn, vn, slots)
    PA.paged_kv_write_plain(kb, vb, kn, vn, slots)
    err = max(_check_close("paged_kv_write k", ka, kb, 0.0, 0.0),
              _check_close("paged_kv_write v", va, vb, 0.0, 0.0))
    live = slots >= 0
    idx, k_live, v_live = slots[live].long(), kn[live], vn[live]
    n_live = int(live.sum())
    row = KV * D * 2
    results["paged_kv_write"] = dict(
        max_abs_err=err,
        **_timings(lambda: PA.paged_kv_write(ka, va, kn, vn, slots),
                   lambda: PA.paged_kv_write_plain(kb, vb, kn, vn, slots),
                   lambda: (kb.view(-1, KV, D).index_copy_(0, idx, k_live),
                            vb.view(-1, KV, D).index_copy_(0, idx, v_live)), 50),
        shape=f"T={T} rows ({n_live} live), arena [{nblk},{bs},{KV},{D}] bf16",
        bound=bound_ms(4 * n_live * row + 4 * T, 0.0))

    # -- paged decode, both modes: S = 8 distinct sequences, ctx 97..118,
    #    each sequence in its own block of the flagship arena
    S = N_PROMPTS
    ctx = torch.arange(S, device=dev, dtype=torch.int32) * 3 + PROMPT_LEN + 1
    tables = torch.full((S, NB), nblk - 1, dtype=torch.int32, device=dev)
    tables[:, 0] = torch.arange(S, dtype=torch.int32, device=dev)
    q = randn(S, H, D)
    k_new, v_new = randn(S, KV, D), randn(S, KV, D)
    slots_d = (tables[:, 0] * bs + (ctx - 1) % bs).to(torch.int32)
    ctx_sum = int(ctx.sum())
    io = S * H * D * 2 * 2 + S * NB * 4 + S * 4  # q in, out, tables, ctx
    ops = 4 * ctx_sum * H * D

    for name, fused in (("paged_decode_fused", True), ("paged_decode_attention", False)):
        ka, va = arena()
        kb, vb = ka.clone(), va.clone()
        if fused:
            run = lambda: PA.paged_decode_fused(q, ka, va, tables, ctx, k_new, v_new, slots_d)
            plain = lambda: PA.paged_decode_fused_plain(q, kb, vb, tables, ctx, k_new, v_new,
                                                        slots_d)
            out, ref = run()[0], plain()[0]
            _check_close(f"{name} cache k", ka, kb, 0.0, 0.0)
            _check_close(f"{name} cache v", va, vb, 0.0, 0.0)
            n_bytes = io + (ctx_sum - S) * row * 2 + S * row * 2 * 2 + S * 4
        else:
            run = lambda: PA.paged_decode_attention(q, ka, va, tables, ctx)
            plain = lambda: PA.paged_decode_attention_plain(q, kb, vb, tables, ctx)
            out, ref = run(), plain()
            n_bytes = io + ctx_sum * row * 2
        atol, rtol = KERNEL_TOL[name]
        results[name] = dict(
            max_abs_err=_check_close(name, out, ref, atol, rtol),
            **_timings(run, plain, None, 50),
            shape=f"S={S}, ctx {int(ctx.min())}..{int(ctx.max())}, H={H}, KV={KV}, D={D}, "
                  f"bs={bs}, arena {nblk} blocks, bf16",
            bound=bound_ms(n_bytes, ops))

    # -- flash forward: the 512-token prefill wave (B=1)
    B, Sq = 1, LONG_LEN
    q, k, v = randn(B, Sq, H, D), randn(B, Sq, KV, D), randn(B, Sq, KV, D)
    o, lse = FA.flash_attention(q, k, v)
    ro, rlse = FA.flash_attention_plain(q, k, v)
    atol, rtol = KERNEL_TOL["flash_fwd"]
    err = _check_close("flash_fwd o", o, ro, atol, rtol)
    _check_close("flash_fwd lse", lse, rlse, 1e-3, 1e-3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    results["flash_fwd"] = dict(
        max_abs_err=err,
        **_timings(lambda: FA.flash_attention(q, k, v),
                   lambda: FA.flash_attention_plain(q, k, v),
                   lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20),
        shape=f"B={B}, S={Sq}, H={H}, KV={KV}, D={D}, bf16",
        bound=bound_ms(B * Sq * (H * 2 + KV * 2) * D * 2 + B * H * Sq * 4,
                       4.0 * B * H * D * Sq * (Sq + 1) / 2))
    for name, r in results.items():
        print(json.dumps({"kernel_check": name, "max_err": r["max_abs_err"],
                          "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                          "library_ms": r["library_ms"], "call_ms": r["call_ms"],
                          "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                          "shape": r["shape"]}))
    return results


# ---------------------------------------------------------------------------
# phase 3: the serving slice at full flagship width
# ---------------------------------------------------------------------------

def run_slice(cfg, dev):
    import numpy as np
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference import model as M
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops import cuda as K

    t0 = time.perf_counter()
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                    dtype=torch.bfloat16)
    eng = init_inference(params, cfg, dict(SERVE))  # bf16 on the GPU by default
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    V = cfg.vocab_size
    r = np.random.default_rng(0)
    prompts = [r.integers(0, V, PROMPT_LEN).astype(np.int32) for _ in range(N_PROMPTS)]
    long_prompt = r.integers(0, V, LONG_LEN).astype(np.int32)
    uids = list(range(N_PROMPTS))

    # -- the main path, counted -------------------------------------------
    K.reset_launch_counts()
    prefill = eng.put(uids + [N_PROMPTS], prompts + [long_prompt])
    nxt = prefill.argmax(-1).astype(np.int32)
    decode = eng.put([0], [nxt[:1]])
    chunk = eng.put([1], [np.array([nxt[1], 1], np.int32)])
    tables = eng.state.block_table(uids, eng.config.blocks_per_seq, eng.pad_block)
    ctx = np.array([eng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
    toks = nxt[:N_PROMPTS].copy()
    toks[0], toks[1] = decode[0].argmax(), chunk[0].argmax()
    fn = eng.decode_multi_fn(N_PROMPTS, DECODE_STEPS)
    gen, last, eng.cache, _ = fn(eng.params, eng.cache, toks, tables, ctx)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    # -----------------------------------------------------------------------

    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"the serving path launched no {missing} kernel: {launches}")
    for name, x in (("prefill", prefill), ("decode", decode), ("chunk", chunk),
                    ("decode_multi", last.float().cpu().numpy())):
        if not np.isfinite(x).all():
            raise AssertionError(f"{name} logits are not finite")
    g = gen.cpu().numpy()
    if g.shape != (DECODE_STEPS, N_PROMPTS) or g.min() < 0 or g.max() >= V:
        raise AssertionError(f"decode_multi tokens out of range: {g.shape}")

    # -- kernel path vs plain versions, same engine weights, on the card ----
    # three runs of the same math: kernel path in bf16 (what put() served),
    # plain path in bf16, plain path in f32 (the reference for both)
    p32 = {k: ([{n: w.float() for n, w in lp.items()} for lp in v] if k == "layers"
               else v.float()) for k, v in eng.params.items()}
    bs = SERVE["kv_block_size"]
    NBt = eng.config.blocks_per_seq
    toks_b = np.zeros((N_PROMPTS, PROMPT_BUCKET), np.int32)
    for i, p in enumerate(prompts):
        toks_b[i, :PROMPT_LEN] = p
    tb = np.zeros((N_PROMPTS, NBt), np.int32)
    tb[:, 0] = np.arange(N_PROMPTS)
    tl = np.zeros((1, NBt), np.int32)
    tl[0, :LONG_LEN // bs] = np.arange(LONG_LEN // bs) + N_PROMPTS
    waves = [(toks_b, np.full((N_PROMPTS,), PROMPT_LEN, np.int32), tb),
             (long_prompt[None], np.array([LONG_LEN], np.int32), tl)]
    plain = {}
    for dtype, prm in ((torch.bfloat16, eng.params), (torch.float32, p32)):
        scratch = M.init_cache(cfg, N_PROMPTS + LONG_LEN // bs + 1, bs, dtype, dev)
        plain[dtype] = torch.cat([
            M.prefill_batch(prm, scratch, *(torch.as_tensor(a, device=dev) for a in w),
                            cfg, use_kernel=False)[0] for w in waves]).cpu()
        del scratch
    prefill_stats = _path_errors("prefill logits", torch.from_numpy(prefill),
                                 plain[torch.bfloat16], plain[torch.float32])
    # one decode step (fused kernel) on copies of the live cache
    dec = (torch.as_tensor(g[-1], device=dev), torch.as_tensor(tables, device=dev),
           torch.as_tensor(ctx + DECODE_STEPS, device=dev))
    outs = []
    for use_kernel, dtype, prm in ((True, torch.bfloat16, eng.params),
                                   (False, torch.bfloat16, eng.params),
                                   (False, torch.float32, p32)):
        cache = M.PagedCache(k=[x.to(dtype, copy=True) for x in eng.cache.k],
                             v=[x.to(dtype, copy=True) for x in eng.cache.v])
        outs.append(M.decode_step(prm, cache, *dec, cfg, use_kernel=use_kernel,
                                  unique_rows=True)[0].cpu())
        del cache
    decode_stats = _path_errors("decode logits", *outs)
    del p32

    # -- timings (after the counted run) ------------------------------------
    ttft = []
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for i in range(7):  # the first two are warm-up
        p = r.integers(0, V, LONG_LEN).astype(np.int32)
        uid = 1000 + i
        torch.cuda.synchronize()
        start.record()
        eng.put([uid], [p])  # returns host logits, so the host waits for the card
        stop.record()
        torch.cuda.synchronize()
        eng.flush(uid)
        if i >= 2:
            ttft.append(start.elapsed_time(stop))
    step_ms = _time_ms(lambda: fn(eng.params, eng.cache, toks, tables, ctx), 3, warmup=1)
    p = r.integers(0, V, LONG_LEN).astype(np.int32)
    breakdown = {
        "decode_multi_b8_24steps": _where_time_goes(
            lambda: fn(eng.params, eng.cache, toks, tables, ctx)),
        "prefill_put_512": _where_time_goes(lambda: eng.put([2000], [p])),
    }
    eng.flush(2000)
    return {
        "init_s": init_s,
        "launches": launches,
        "prefill_logits": prefill_stats,
        "decode_logits": decode_stats,
        "ttft_ms_512_p50": statistics.median(ttft),
        "ttft_ms_512_all": ttft,
        "decode_multi_ms_b8_24steps": step_ms,
        "decode_tok_s_b8": N_PROMPTS * DECODE_STEPS / (step_ms / 1e3),
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "where_time_goes": breakdown,
        "prefix_cache": {k: v for k, v in eng.prefix_cache_stats().items()
                         if k in ("lookup_hits", "lookup_misses", "cow_copies")},
    }


def _gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    _require_environment()
    import torch

    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops.cuda import build

    dev = torch.device("cuda")
    cfg = T.TransformerConfig(**FLAGSHIP)

    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "libraries": {n: p.name for n, p in libs.items()}}))
    for name in libs:
        for line in (build.build_log(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    kernels = check_kernels(cfg, dev)
    print(json.dumps({"phase": "kernels", "ok": True}))
    sl = run_slice(cfg, dev)
    print(json.dumps({"phase": "slice", **sl}))

    line = []
    for name, (source, replaces) in KERNELS.items():
        k = kernels[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": sl["launches"][name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
                     "bound_by": k["bound"][1], "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": line}))
    print(_gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
