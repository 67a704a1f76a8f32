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

Each kernel function returns its `cudaError_t` as an int (the launch
status from `cudaGetLastError`); `check()` raises on a nonzero value.
"""

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
SOURCES = ("paged_kv_write", "paged_decode", "flash_fwd", "flash_bwd", "evoformer_fwd",
           "evoformer_bwd", "evoformer_db2", "int8_matmul")
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
}

_loaded: Dict[str, ctypes.CDLL] = {}
# source -> seconds its nvcc took in the last build_all() that built it
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


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # a shared header's edit rebuilds too
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
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
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
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
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{text}")
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
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ds_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        msg = lib.ds_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
