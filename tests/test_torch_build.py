"""The port's kernel build (`deepspeed_tpu_torch/ops/cuda/build.py`) on the
CPU, with a stand-in `nvcc`: every source built by its own process, all
started together, each one's seconds recorded, the compiler's report kept
beside the library, a failed build raising with its report, and an
unchanged source not rebuilt. The real compiler runs only on the GPU
machine (`chip_smoke.py` prints the seconds there)."""

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


def test_the_shared_hopper_header_rebuilds_the_evoformer_libraries(tmp_path, monkeypatch):
    """The evoformer forward (#7) and pair-bias gradient (#10) take their
    TMA, mbarrier and wgmma helpers from csrc/hopper.cuh too: an edit of it
    changes their libraries' names, as it does the flash kernels'."""
    csrc = tmp_path / "csrc"
    shutil.copytree(PB.CSRC, csrc)
    monkeypatch.setattr(PB, "CSRC", csrc)
    names = ("evoformer_fwd", "evoformer_db2", "flash_fwd", "flash_bwd")
    for name in names:
        assert '#include "hopper.cuh"' in (csrc / f"{name}.cu").read_text()
    before = {n: PB._library_path(n) for n in names}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {n: PB._library_path(n) for n in names}
    assert all(before[n] != after[n] for n in names)
