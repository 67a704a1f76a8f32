"""Build and load the port's hand-written CUDA kernels.

Every `deepspeed_tpu_torch/csrc/<name>.cu` is compiled on first use, by
`nvcc` straight into a shared library with a plain C interface, and
loaded with `ctypes` (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

The library lands in `build/kernels/` at the root of the checkout (listed
in .gitignore), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once. The compiler's
`-Xptxas -v` report (registers, shared memory, spills) is kept beside it
as `<name>-<hash>.log`. `build_all()` starts one `nvcc` per source, all at
once. A missing `nvcc`, a failed build or a failed load raises.

Each kernel function returns its `cudaError_t` as an int (the launch
status from `cudaGetLastError`); `check()` raises on a nonzero value.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_kv_write", "paged_decode", "flash_fwd", "flash_bwd")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# source -> C signature of each kernel function it exports (all return
# cudaError_t)
SIGNATURES = {
    "paged_kv_write": {"paged_kv_write": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]},
    "paged_decode": {"paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]},
    "flash_fwd": {"flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]},
    "flash_bwd": {
        "flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        "flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


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
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        out[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])  # atomic: a concurrent loader sees all or nothing
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
