"""Build and load the port's hand-written CUDA kernels.

Every `deepspeed_tpu_torch/csrc/<name>.cu` is compiled on first use, by
`nvcc` straight into a shared library with a plain C interface, and
loaded with `ctypes` (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

The library lands in `build/kernels/` at the root of the checkout (listed
in .gitignore), named by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source rebuilds and an
unchanged one loads at once. The compiler's `-Xptxas -v` report
(registers, shared memory, spills) is kept beside it as
`<name>-<hash>.log`. `build_all()` starts one `nvcc` per source, all at
once, and records each one's seconds in `BUILD_SECONDS`. A missing
`nvcc`, a failed build or a failed load raises.

A name may carry preprocessor defines after the source, joined by `+`
(`flash_fwd+DS_FAULT_PV_HI_SKIPPED`): that source built with `-D` of each,
in a library of its own. The f32 serving kernels are sources of their
own (`paged_kv_write_f32`, `paged_decode_f32`, `flash_fwd_f32`); the f16
flash kernels are such builds
(`flash_fwd+DS_F16`, `flash_bwd+DS_F16`: csrc/hopper.cuh's element type),
and so are the planted faults that `chip_smoke.py` aims at a kernel's own
code; `routed(name, variant)` makes the wrappers load the variant for the
length of a block.

Each kernel function returns its `cudaError_t` as an int (the launch
status from `cudaGetLastError`); `check()` raises on a nonzero value.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# every library the port runs: each source (the f32 serving kernels,
# #1 and #4-#6 on f32 operands, in sources of their own), and the f16
# builds of the flash kernels (#1-#3 on f16 operands, fp16 training)
SOURCES = ("paged_kv_write", "paged_decode", "flash_fwd", "flash_bwd", "evoformer_fwd",
           "evoformer_bwd", "evoformer_db2", "int8_matmul", "grouped_gemm",
           "flash_fwd+DS_F16", "flash_bwd+DS_F16", "paged_kv_write_f32", "paged_decode_f32",
           "flash_fwd_f32")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# source -> C signature of each kernel function it exports (all return
# cudaError_t)
SIGNATURES = {
    "paged_kv_write": {"paged_kv_write": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
                       # ..., head_dim, the magic numbers and shifts of 2 KV and
                       # of the block size
                       "paged_kv_write_int8": [_P] * 7 + [_I] * 5 + [_U, _I, _U, _I, _P],
                       # the quantizer's exhaustive route check: out[3], stream
                       "kv_quant_check": [_P, _P]},
    # ..., allowed, the split's f32 partials, its arrival counters; ...,
    # window, the split count and length
    "paged_decode": {"paged_decode": [_P] * 15 + [_I] * 12 + [_F, _P]},
    # the f32 kernels: f32 q, rows and pools (or int8 pools), the bf16
    # kernels' arguments; the int8 write of f32 rows takes ..., the row
    # count, the block count and size, KV, head_dim, stream
    "paged_kv_write_f32": {"paged_kv_write_int8_f32": [_P] * 7 + [_I] * 5 + [_P]},
    "paged_decode_f32": {"paged_decode_f32": [_P] * 15 + [_I] * 12 + [_F, _P]},
    "flash_fwd_f32": {"flash_fwd_f32": [_P] * 6 + [_I] * 6 + [_F, _P]},
    "flash_fwd": {"flash_fwd": [_P] * 6 + [_I] * 6 + [_F, _P],
                  # host nanoseconds to encode a call's three TMA maps `iters` times
                  "flash_fwd_encode_ns": [_P] * 3 + [_I] * 6},
    "flash_bwd": {
        "flash_bwd_dq": [_P] * 8 + [_I] * 6 + [_F, _P],
        # ... slopes, the group split's f32 scratch; ..., window, its chunk count
        "flash_bwd_dkv": [_P] * 10 + [_I] * 7 + [_F, _P],
    },
    # ..., D, the count of sequence runs
    "evoformer_fwd": {"evoformer_fwd": [_P] * 7 + [_I] * 6 + [_F, _P]},
    # ..., D, the count of sequence runs
    "evoformer_bwd": {
        "evoformer_bwd_dq": [_P] * 9 + [_I] * 6 + [_F, _P],
        "evoformer_bwd_dkv": [_P] * 11 + [_I] * 6 + [_F, _P],
    },
    # db2, the sequence split's f32 scratch, ...; ..., D, its chunk count
    "evoformer_db2": {"evoformer_bwd_db2": [_P] * 10 + [_I] * 6 + [_F, _P]},
    # out, x, codes, scale, the cut tiles' f32 partials, their arrival
    # counters; M, N, K, token rows a tile, the grid, f32 output
    "int8_matmul": {"int8_matmul": [_P] * 6 + [_I] * 6 + [_P],
                    # host nanoseconds to make a call's two TMA maps `iters` times
                    "int8_matmul_encode_ns": [_P] * 2 + [_I] * 5},
    # out, xs, w, counts, split K's f32 partials, their arrival counters; A,
    # K, N, X, rows a tile, splits (the int8 form: codes and scales for w,
    # the scale groups after X)
    "grouped_gemm": {"grouped_gemm": [_P] * 6 + [_I] * 6 + [_P],
                     "grouped_gemm_int8": [_P] * 7 + [_I] * 7 + [_P]},
}

_loaded: Dict[str, ctypes.CDLL] = {}
# name -> the variant that load(name) returns inside routed()
_routes: Dict[str, str] = {}
# name -> seconds its nvcc took in the last build_all() that built it
BUILD_SECONDS: Dict[str, float] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels are built from source at first use")
    return found


def _source_and_flags(name: str):
    """`name` -> its source file and nvcc flags (`+DEFINE` suffixes -> -D)."""
    source, *defines = name.split("+")
    return CSRC / f"{source}.cu", NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _library_path(name: str) -> Path:
    src, flags = _source_and_flags(name)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # a shared header's edit rebuilds too
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Build every named kernel library that is not built yet, one `nvcc`
    process per source, all started together. Returns name -> library."""
    names = list(names)
    out = {n: _library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        src, flags = _source_and_flags(n)
        cmd = [nvcc, *flags, "-o", str(tmp), str(src)]
        # the report goes to a file of this process's own, not a pipe: nothing blocks on it
        log = open(out[n].with_suffix(f".{os.getpid()}.log"), "w")
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    while procs:
        for n, (proc, tmp, log) in list(procs.items()):
            if proc.poll() is None:
                continue
            BUILD_SECONDS[n] = time.perf_counter() - t0
            log.close()
            del procs[n]
            os.replace(log.name, out[n].with_suffix(".log"))
            if proc.returncode != 0:
                text = out[n].with_suffix(".log").read_text()
                src, flags = _source_and_flags(n)
                label = " ".join((src.name,) + flags[len(NVCC_FLAGS):])
                failed.append(f"{label} (exit {proc.returncode}):\n{text}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out[n])  # atomic: a concurrent loader sees all or nothing
        if procs:
            time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def build_log(name: str) -> Optional[str]:
    """The compiler's report for the current build of `name`, if built."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed (inside
    routed(name, variant): the variant's)."""
    name = _routes.get(name, name)
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name.split("+")[0]].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ds_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


@contextlib.contextmanager
def routed(name: str, variant: str):
    """Within the block, load(name) returns the library of `variant` (the
    same build with further `+DEFINE` suffixes: `flash_fwd+DS_F16+DS_X`
    for `flash_fwd+DS_F16`), so every wrapper that loads `name` runs that
    build."""
    if not variant.startswith(name + "+"):
        raise ValueError(f"{variant!r} is not a build of {name!r}")
    _routes[name] = variant
    try:
        yield
    finally:
        del _routes[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        msg = lib.ds_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
