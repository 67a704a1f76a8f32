"""The port's kernel build (`deepspeed_tpu_torch/ops/cuda/build.py`) on the
CPU, with a stand-in `nvcc`: every source built by its own process, all
started together, each one's seconds recorded, the compiler's report kept
beside the library, a failed build raising with its report, and an
unchanged source not rebuilt. The real compiler runs only on the GPU
machine (`chip_smoke.py` prints the seconds there)."""

import importlib.util
import re
import shutil
import stat

import pytest

from deepspeed_tpu_torch.ops.cuda import build as PB

# Writes ~200 KB of report (more than a pipe holds), logs its call, fails
# for any source named in $FAIL_ON, else creates the -o file.
FAKE_NVCC = """#!/bin/bash
out=""; prev=""
for a in "$@"; do if [ "$prev" = "-o" ]; then out="$a"; fi; prev="$a"; done
echo "$out" >> "$CALLS"
echo "$@" >> "$CALLS.args"
for i in $(seq 1 4000); do echo "ptxas info    : Used 128 registers, line $i of the report"; done
for name in $FAIL_ON; do
  case "$out" in *"/$name-"*) echo "error: planted failure"; exit 3;; esac
done
touch "$out"
"""


@pytest.fixture
def fake_cuda(tmp_path, monkeypatch):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    calls = tmp_path / "calls.txt"
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("CALLS", str(calls))
    monkeypatch.setenv("FAIL_ON", "")
    monkeypatch.setattr(PB, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(PB, "BUILD_SECONDS", {})
    return calls


def test_every_source_builds_with_its_seconds_and_report(fake_cuda):
    libs = PB.build_all()
    assert sorted(libs) == sorted(PB.SOURCES)
    assert all(p.exists() for p in libs.values())
    assert sorted(PB.BUILD_SECONDS) == sorted(PB.SOURCES)
    assert all(s > 0 for s in PB.BUILD_SECONDS.values())
    for name in PB.SOURCES:
        assert PB.build_log(name).count("Used 128 registers") == 4000
    assert not list(PB.BUILD_DIR.glob("*.tmp"))
    assert len(fake_cuda.read_text().split()) == len(PB.SOURCES)


def test_a_failed_build_raises_with_its_report(fake_cuda, monkeypatch):
    monkeypatch.setenv("FAIL_ON", "flash_fwd")
    with pytest.raises(RuntimeError, match="flash_fwd.cu \\(exit 3\\)") as err:
        PB.build_all()
    assert "planted failure" in str(err.value)
    assert not PB._library_path("flash_fwd").exists()
    assert PB._library_path("flash_bwd").exists()
    assert not list(PB.BUILD_DIR.glob("*.tmp")) and not list(PB.BUILD_DIR.glob("*.*.log"))


def test_an_unchanged_source_is_not_rebuilt(fake_cuda):
    PB.build_all(["flash_fwd"])
    PB.BUILD_SECONDS.clear()
    PB.build_all(["flash_fwd", "flash_bwd"])
    assert [line.split("/")[-1].split("-")[0] for line in fake_cuda.read_text().split()] == [
        "flash_fwd", "flash_bwd"]
    assert list(PB.BUILD_SECONDS) == ["flash_bwd"]


def test_a_define_variant_builds_a_library_of_its_own(fake_cuda):
    """`source+DEFINE` names that source built with -DDEFINE, beside the
    plain build and at the same time, in a library of another name."""
    libs = PB.build_all(["flash_fwd", "flash_fwd+DS_A+DS_B"])
    assert libs["flash_fwd"] != libs["flash_fwd+DS_A+DS_B"]
    assert libs["flash_fwd+DS_A+DS_B"].name.startswith("flash_fwd+DS_A+DS_B-")
    assert all(p.exists() for p in libs.values())
    args = {line.split(" -o ")[1].split()[0].split("/")[-1].split("-")[0]: line.split()
            for line in (fake_cuda.parent / "calls.txt.args").read_text().splitlines()}
    assert args["flash_fwd+DS_A+DS_B"][-1].endswith("/flash_fwd.cu")
    assert {"-DDS_A", "-DDS_B"} <= set(args["flash_fwd+DS_A+DS_B"])
    assert not any(a.startswith("-D") for a in args["flash_fwd"])
    assert sorted(PB.BUILD_SECONDS) == ["flash_fwd", "flash_fwd+DS_A+DS_B"]


def test_routed_loads_the_variant_within_its_block(monkeypatch):
    plain, variant = object(), object()
    monkeypatch.setattr(PB, "_loaded", {"flash_fwd": plain, "flash_fwd+DS_A": variant})
    assert PB.load("flash_fwd") is plain
    with PB.routed("flash_fwd", "flash_fwd+DS_A"):
        assert PB.load("flash_fwd") is variant
        assert PB.load("flash_fwd+DS_A") is variant
    assert PB.load("flash_fwd") is plain
    with pytest.raises(ValueError, match="not a build of"):
        with PB.routed("flash_fwd", "paged_decode+DS_A"):
            pass
    assert not PB._routes


def test_the_planted_fault_defines_are_in_their_sources():
    """Each of chip_smoke.py's FAULT_BUILDS names defines that its source
    tests, in its own text or in a header of csrc it includes (the f16
    faults live in hopper.cuh): a define the source does not know would
    build the genuine kernel under a fault's name."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  PB.CSRC.parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.FAULT_BUILDS
    for variant in smoke.FAULT_BUILDS.values():
        source, *defines = variant.split("+")
        text = "\n".join((PB.CSRC / f).read_text() for f in [f"{source}.cu"] + [
            h.name for h in sorted(PB.CSRC.glob("*.cuh")) if _includes(PB.CSRC, f"{source}.cu",
                                                                        h.name)])
        for d in defines:
            assert re.search(r"#if(n?def| defined\()\s*" + d + r"\b", text), variant


def test_the_shared_hopper_header_rebuilds_both_flash_libraries(tmp_path, monkeypatch):
    """flash_fwd.cu and flash_bwd.cu take their mbarrier, TMA and wgmma
    helpers from csrc/hopper.cuh: an edit of it changes both libraries'
    names, so neither loads a stale build."""
    csrc = tmp_path / "csrc"
    shutil.copytree(PB.CSRC, csrc)
    monkeypatch.setattr(PB, "CSRC", csrc)
    names = ("flash_fwd", "flash_bwd")
    for name in names:
        assert '#include "hopper.cuh"' in (csrc / f"{name}.cu").read_text()
    before = {n: PB._library_path(n) for n in names}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {n: PB._library_path(n) for n in names}
    assert all(before[n] != after[n] for n in names)


def _includes(csrc, source, header):
    """Whether `source` (a file in csrc) includes `header`, directly or
    through another header of csrc."""
    seen, todo = set(), [source]
    while todo:
        for inc in re.findall(r'#include "([^"]+)"', (csrc / todo.pop()).read_text()):
            if inc == header:
                return True
            if inc not in seen:
                seen.add(inc)
                todo.append(inc)
    return False


@pytest.mark.parametrize("header,names", [
    # the evoformer kernels (#7-#10) take their TMA, mbarrier and wgmma
    # helpers from hopper.cuh too (#7 and the backward through
    # evoformer_band.cuh), as the flash kernels do
    ("hopper.cuh", ("evoformer_fwd", "evoformer_bwd", "evoformer_db2", "flash_fwd", "flash_bwd")),
    # the pair-bias band of #7 and of the backward's #8 and #9
    ("evoformer_band.cuh", ("evoformer_fwd", "evoformer_bwd")),
])
def test_the_shared_hopper_header_rebuilds_the_evoformer_libraries(tmp_path, monkeypatch, header,
                                                                   names):
    """An edit of a shared header changes the library names of the sources
    that include it, and of every other source (the build hash covers all
    of csrc/*.cuh), so none loads a stale build: the evoformer backward's
    as well as the forward's and db2's."""
    csrc = tmp_path / "csrc"
    shutil.copytree(PB.CSRC, csrc)
    monkeypatch.setattr(PB, "CSRC", csrc)
    for name in names:
        assert _includes(csrc, f"{name}.cu", header), name
    before = {n: PB._library_path(n) for n in PB.SOURCES}
    path = csrc / header
    path.write_text(path.read_text() + "\n// an edit\n")
    after = {n: PB._library_path(n) for n in PB.SOURCES}
    assert all(before[n] != after[n] for n in PB.SOURCES)


def test_no_wmma_kernel_and_no_old_header_remain():
    """Every kernel of csrc runs on wgmma or mma.sync: no WMMA API call is
    left, and the WMMA tile helpers' header is gone."""
    assert not (PB.CSRC / "evoformer_common.cuh").exists()
    for path in sorted(PB.CSRC.glob("*.cu*")):
        assert not re.search(r"\bwmma::", path.read_text()), path.name


@pytest.mark.parametrize("fn,n_ptrs", [("evoformer_bwd_dq", 9), ("evoformer_bwd_dkv", 11)])
def test_the_evoformer_backward_takes_its_run_count(fn, n_ptrs):
    """#8 and #9 walk runs of sequences: their C entry points take the run
    count after D, and build.SIGNATURES passes it as an int."""
    text = (PB.CSRC / "evoformer_bwd.cu").read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    assert params[n_ptrs:] == ["int B", "int S", "int N", "int H", "int D", "int n_runs",
                               "float scale", "void* stream"]
    assert PB.SIGNATURES["evoformer_bwd"][fn] == [PB._P] * n_ptrs + [PB._I] * 6 + [PB._F, PB._P]
