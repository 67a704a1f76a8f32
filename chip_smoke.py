#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (deepspeed_tpu_torch) starts
on one NVIDIA GPU, trains and serves through its hand-written kernels.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (any failure raises and exits nonzero):

1. build   - compile every kernel from deepspeed_tpu_torch/csrc/*.cu with
             nvcc for sm_90a, one nvcc per source, all in parallel
             (ops/cuda/build.py; into build/kernels/).
2. kernels - call each kernel's wrapper on CUDA tensors at the shapes its
             path gives it (the flash kernels at the training shape B=8,
             S=2048, the serving kernels at the serving shapes) and hold the
             result against its plain PyTorch version on the same inputs
             (for the flash backward, two faults planted in the kernels'
             output must fail that check);
             time kernel, plain version and (where one exists) a single
             PyTorch library call computing the same function: device time
             from torch.profiler, and the time of back-to-back calls from
             CUDA events.
3. train   - initialize() the flagship Llama (24 layers, d_model 1024, 8 x
             128 heads, vocab 32000, remat save_attn_qkv, random weights
             from a seeded torch.Generator) in bf16 with an fp32 master,
             AdamW, clipping 1.0 and loss_chunks 16, and train on a fixed
             [8, 2049] batch: one step with every launch counter at 0 (each
             flash kernel must launch once per layer), then more steps over
             which the loss must fall. Checks: finite loss and grad norm;
             per-token loss and gradients of the kernel path no further
             from the f32 plain path than the bf16 plain path is (B=1,
             S=2048). Then times steps with CUDA events (tokens/s, MFU),
             profiles where one step's time goes, and reads peak memory.
4. serve   - init_inference on the same model shape in bf16, then drive the
             serving path once with every launch counter at 0: one prefill
             put of 8 x 96-token prompts plus one 512-token prompt, a
             single-token decode put, a 2-token continuation put, and greedy
             decode_multi_fn(8, 24). Every serving kernel must have
             launched. Checks: finite logits and tokens in range; prefill
             and decode logits of the kernel path no further from the f32
             plain path than the bf16 plain path is. Then times TTFT of a
             512-token prompt and batch-8 decode throughput, and profiles
             where the time goes in each.
5. report  - one JSON line with every kernel's launches (per path and in
             all), error and times beside its bound; the card's name and
             power limit; and last, {"ok": true, "device": {...}}.

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

# the training path: bench.py's flagship train step on one GPU
TRAIN_MODEL = dict(FLAGSHIP, remat="save_attn_qkv", use_flash=True, flash_block_q=1024,
                   flash_block_k=1024)
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": 8, "gradient_accumulation_steps": 1,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-4, "weight_decay": 0.1}},
                "zero_optimization": {"stage": 1}, "bf16": {"enabled": True},
                "gradient_clipping": 1.0, "steps_per_print": 10**9}
TRAIN_B, TRAIN_S, LOSS_CHUNKS = 8, 2048, 16
TRAIN_STEPS, TIMED_STEPS = 8, 5  # loss must fall over TRAIN_STEPS; then time TIMED_STEPS
H100_BF16_FLOPS = 989e12

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
    "flash_bwd_dq": ("deepspeed_tpu_torch/csrc/flash_bwd.cu",
                     "deepspeed_tpu/ops/pallas/flash_attention.py:438"),
    "flash_bwd_dkv": ("deepspeed_tpu_torch/csrc/flash_bwd.cu",
                      "deepspeed_tpu/ops/pallas/flash_attention.py:467"),
}
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SERVE_KERNELS = ("paged_kv_write", "paged_decode_fused", "paged_decode_attention", "flash_fwd")
# kernel vs plain version on the card, (atol, rtol): the KV write is a copy
# (bit-exact); decode keeps f32 probabilities, so only the bf16 rounding of
# the output differs, at most one bf16 ulp (2^-7 of the value: rtol 8e-3,
# atol 1e-3 near zero); flash also feeds bf16 probabilities to the tensor
# cores (another 2^-9 relative per term)
KERNEL_TOL = {"paged_kv_write": (0.0, 0.0), "paged_decode_fused": (1e-3, 8e-3),
              "paged_decode_attention": (1e-3, 8e-3), "flash_fwd": (2e-2, 2e-2)}
# the backward kernels: against the plain backward on the same bf16 inputs
# (which rounds P and dS to bf16 where they do), under FA.bwd_mismatch's
# tolerance (one bf16 ulp of the value + 2^-5 of the row's RMS); two faults
# planted in their output must fail it (_planted_faults)
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
             "f32_rms": rms(ref32)}
    if kernel.dim() > 1:
        stats["argmax_agree_kernel_f32"] = (kernel.argmax(-1)
                                            == ref32.argmax(-1)).float().mean().item()
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
# phase 2: each kernel against its plain version at its path's shapes
# ---------------------------------------------------------------------------

def _flash_fwd_check(FA, randn, B, S, H, KV, D, bound_ms):
    import torch.nn.functional as F

    q, k, v = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D)
    o, lse = FA.flash_fwd(q, k, v)
    ro, rlse = FA.flash_attention_plain(q, k, v)
    atol, rtol = KERNEL_TOL["flash_fwd"]
    err = _check_close("flash_fwd o", o, ro, atol, rtol)
    _check_close("flash_fwd lse", lse, rlse, 1e-3, 1e-3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return dict(
        max_abs_err=err,
        **_timings(lambda: FA.flash_fwd(q, k, v), lambda: FA.flash_attention_plain(q, k, v),
                   lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=KV != H), 10),
        shape=f"B={B}, S={S}, H={H}, KV={KV}, D={D}, bf16, causal",
        bound=bound_ms(B * S * (H * 2 + KV * 2) * D * 2 + B * H * S * 4,
                       4.0 * B * H * D * S * (S + 1) / 2))


def _planted_faults(FA, got, ref, q, k, v, do, lse, delta, tile=64):
    """Proof that the backward tolerance catches a wrong kernel: two faults
    planted in the kernels' own output, each of which must fail
    FA.bwd_mismatch against the plain backward. "scale_1.02": every
    gradient 2% too large. "skip_last_diag_tile": the causal block of the
    last `tile` queries and keys left out (a dq block that stops one K/V
    tile short, a dkv block that stops one q tile short), i.e. the
    contribution of that block (the plain backward on it, with the full
    rows' lse and delta) taken off. Returns {name: {fault: elements
    beyond the tolerance}}."""
    import torch

    t = q.shape[1] - tile
    last = lambda x: x[:, t:].contiguous()
    part = FA._bwd_plain(last(q), last(k), last(v), lse[:, :, t:].contiguous(),
                         delta[:, :, t:].contiguous(), last(do))
    out = {}
    for (name, g), p in zip(got.items(), part):
        skipped = g.to(torch.float32, copy=True)
        skipped[:, t:] -= p.float()
        out[name] = {
            "scale_1.02": FA.bwd_mismatch((g.float() * 1.02).to(torch.bfloat16),
                                          ref[name])["n_over"],
            "skip_last_diag_tile": FA.bwd_mismatch(skipped.to(torch.bfloat16),
                                                   ref[name])["n_over"]}
        if not all(out[name].values()):
            raise AssertionError(f"flash_bwd {name}: the tolerance passes a planted fault: "
                                 f"{out[name]}")
    return out


def _flash_train_checks(FA, randn, B, S, H, KV, D, bound_ms):
    """Kernel #1 at the training shape, and kernels #2 (dq) and #3 (dk,
    dv) against the plain backward on the forward kernel's o and lse.
    library_ms of both backward kernels is the device time of the
    backward of F.scaled_dot_product_attention, which computes dq, dk and
    dv in one call; plain_ms is that of the dense plain backward, which
    also computes all three."""
    import torch
    import torch.nn.functional as F

    out = {"flash_fwd": _flash_fwd_check(FA, randn, B, S, H, KV, D, bound_ms)}
    q, k, v, do = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D), randn(B, S, H, D)
    o, lse = FA.flash_fwd(q, k, v)
    delta = FA._delta(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta)
    got = {"dq": dq, "dk": dk, "dv": dv}
    ref = dict(zip(got, FA.flash_attention_bwd_plain(q, k, v, o, lse, do)))
    # for the record: the same math with nothing rounded to bf16
    f32 = dict(zip(got, FA.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                                     o.float(), lse, do.float())))
    planted = _planted_faults(FA, got, ref, q, k, v, do, lse, delta)
    report = {}
    for name in got:
        stats = FA.bwd_mismatch(got[name], ref[name])
        if stats["n_over"]:
            raise AssertionError(f"flash_bwd {name}: kernel beyond the tolerance of the "
                                 f"plain backward: {stats}")
        report[name] = {"vs_plain": stats,
                        "vs_plain_f32": FA.bwd_mismatch(got[name], f32[name]),
                        "planted_faults_n_over": planted[name]}
    del ref, f32
    print(json.dumps({"flash_bwd_tolerance": {
        "rtol": FA.BWD_RTOL, "row_rms_atol": FA.BWD_ROW_ATOL, "floor": FA.BWD_FLOOR,
        **report}}))
    errs = {name: r["vs_plain"]["max_abs_err"] for name, r in report.items()}
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=KV != H)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
    pairs = B * H * S * (S + 1) / 2  # causal (query, key) pairs
    io_in = B * S * (2 * H + 2 * KV) * D * 2 + 2 * B * H * S * 4  # q, k, v, dO, lse, delta
    shape = f"B={B}, S={S}, H={H}, KV={KV}, D={D}, bf16, causal"
    out["flash_bwd_dq"] = dict(
        max_abs_err=errs["dq"],
        **_timings(lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta),
                   lambda: FA._bwd_plain(q, k, v, lse, delta, do)[0], sdpa_bwd, 5),
        shape=shape, bound=bound_ms(io_in + B * S * H * D * 2, 3 * 2.0 * pairs * D))
    out["flash_bwd_dkv"] = dict(
        max_abs_err=max(errs["dk"], errs["dv"]),
        **_timings(lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta),
                   lambda: FA._bwd_plain(q, k, v, lse, delta, do)[1:], sdpa_bwd, 5),
        shape=shape, bound=bound_ms(io_in + 2 * B * S * KV * D * 2, 4 * 2.0 * pairs * D))
    both = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    print(json.dumps({"flash_backward_vs_sdpa": {
        "dq_plus_dkv_ms": both, "sdpa_backward_ms": out["flash_bwd_dq"]["library_ms"],
        "ratio": both / out["flash_bwd_dq"]["library_ms"], "shape": shape}}))
    return out


def check_kernels(cfg, dev):
    import torch

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

    # -- flash forward: the 512-token prefill wave of the serving path (B=1)
    #    and the training shape; the kernels line carries the training one
    results["flash_fwd@serve"] = _flash_fwd_check(FA, randn, 1, LONG_LEN, H, KV, D, bound_ms)
    results.update(_flash_train_checks(FA, randn, TRAIN_B, TRAIN_S, H, KV, D, bound_ms))
    for name, r in results.items():
        print(json.dumps({"kernel_check": name, "max_err": r["max_abs_err"],
                          "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                          "library_ms": r["library_ms"], "call_ms": r["call_ms"],
                          "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                          "shape": r["shape"]}))
    return results


# ---------------------------------------------------------------------------
# phase 3: the training path at full flagship width and depth
# ---------------------------------------------------------------------------

def _grads_three_paths(T, eng, cfg, tokens):
    """Per-token loss [S] and the flattened gradient of the mean loss on
    one sequence, by three paths from the engine's weights: the kernel
    path in bf16 (what training runs), the plain path in bf16 and the
    plain path in f32 (the reference for both)."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.utils.tree import leaves, tree_map

    tokens = torch.as_tensor(tokens, device=eng.device).long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    out = []
    for use_kernel, dtype in ((True, torch.bfloat16), (False, torch.bfloat16),
                              (False, torch.float32)):
        live = tree_map(lambda m: m.detach().to(dtype, copy=True).requires_grad_(),
                        eng.state.master)
        logits = T.forward(live, inputs, cfg, use_kernel=use_kernel).float()
        nll = F.cross_entropy(logits.flatten(0, 1), targets.flatten(), reduction="none")
        grads = torch.autograd.grad(nll.mean(), leaves(live))
        out.append((nll.detach(), torch.cat([g.float().flatten() for g in grads])))
        del live, logits, grads
    return out


def run_train(mcfg, dev):
    import numpy as np
    import torch

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops import cuda as K

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = initialize(dict(TRAIN_CONFIG), loss_fn=T.make_loss_fn(mcfg, loss_chunks=LOSS_CHUNKS),
                     param_init_fn=lambda g: T.init(mcfg, g, device=dev),
                     param_logical_specs=T.logical_specs(mcfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {"tokens": np.random.default_rng(0).integers(
        0, mcfg.vocab_size, (TRAIN_B, TRAIN_S + 1)).astype(np.int32)}

    # -- the main path, counted: one train step --------------------------------
    K.reset_launch_counts()
    t0 = time.perf_counter()
    first = eng.train_batch(batch)
    first_step_s = time.perf_counter() - t0
    launches = K.launch_counts()
    # ---------------------------------------------------------------------------

    want = {n: (mcfg.n_layers if n in TRAIN_KERNELS else 0) for n in launches}
    if launches != want:
        raise AssertionError(f"a train step should launch each flash kernel once per layer "
                             f"and nothing else: {launches}, expected {want}")
    history = [first] + [eng.train_batch(batch) for _ in range(TRAIN_STEPS - 1)]
    losses = [m["loss"] for m in history]
    if not all(np.isfinite(losses + [m["grad_norm"] for m in history])):
        raise AssertionError(f"non-finite loss or grad_norm: {history}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall over {TRAIN_STEPS} steps on a fixed "
                             f"batch: {losses}")

    # -- timing: TIMED_STEPS async steps between two CUDA events ---------------
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TIMED_STEPS):
        eng.train_batch_async(batch)
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / TIMED_STEPS
    tok_s = TRAIN_B * TRAIN_S / (step_ms / 1e3)
    breakdown = _where_time_goes(lambda: eng.train_batch(batch), top=10)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    # -- kernel path vs plain paths on one sequence -----------------------------
    r = np.random.default_rng(1)
    one = r.integers(0, mcfg.vocab_size, (1, TRAIN_S + 1)).astype(np.int32)
    (nk, gk), (npl, gp), (n32, g32) = _grads_three_paths(T, eng, mcfg, one)
    loss_stats = _path_errors("per-token loss", nk, npl, n32)
    # gradients in units of the f32 gradient's RMS, so the fixed slack of
    # _path_errors is relative to the gradient's scale
    unit = g32.square().mean().sqrt()
    grad_stats = _path_errors("gradients", gk / unit, gp / unit, g32 / unit)
    grad_stats["f32_grad_rms"] = unit.item()
    loss_stats["mean_loss"] = {"kernel": nk.mean().item(), "plain_bf16": npl.mean().item(),
                               "plain_f32": n32.mean().item()}
    del gk, gp, g32, eng
    torch.cuda.empty_cache()
    return {
        "init_s": init_s,
        "first_step_s": first_step_s,
        "launches": launches,
        "losses": losses,
        "grad_norms": [m["grad_norm"] for m in history],
        "step_ms": step_ms,
        "tokens_per_s": tok_s,
        "mfu": tok_s * mcfg.flops_per_token(TRAIN_S) / H100_BF16_FLOPS,
        "flops_per_token": mcfg.flops_per_token(TRAIN_S),
        "peak_mem_gib": peak_gib,
        "where_time_goes": breakdown,
        "path_loss": loss_stats,
        "path_grads": grad_stats,
    }


# ---------------------------------------------------------------------------
# phase 4: the serving slice at full flagship width
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

    missing = [n for n in SERVE_KERNELS if launches[n] == 0]
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
    tr = run_train(T.TransformerConfig(**TRAIN_MODEL), dev)
    print(json.dumps({"phase": "train", **tr}))
    sl = run_slice(cfg, dev)
    print(json.dumps({"phase": "serve", **sl}))

    line = []
    for name, (source, replaces) in KERNELS.items():
        k = kernels[name]
        by_path = {"train": tr["launches"][name], "serve": sl["launches"][name]}
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": sum(by_path.values()),
                     "launches_by_path": by_path, "shape": k["shape"],
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
