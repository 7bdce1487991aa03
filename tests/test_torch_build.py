"""The port's nvcc build cache (``flexdm_tpu_torch/ops/_build.py``): a
library is rebuilt when a source or a shared header changes, and reused
otherwise.  nvcc is replaced by a stub, so this runs anywhere."""

import subprocess

import pytest

from flexdm_tpu_torch.ops import _build


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """csrc and build dirs under ``tmp_path``; returns the list of compile
    commands that were run (each writes its ``-o`` file)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kernel.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("so")
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")

    monkeypatch.setattr(_build.subprocess, "run", run)
    return csrc, calls


def test_build_is_reused_until_a_header_changes(fake_nvcc):
    csrc, calls = fake_nvcc
    first = _build.build_library("k", ["kernel.cu"])
    assert first.exists() and len(calls) == 1
    assert _build.build_library("k", ["kernel.cu"]) == first
    assert len(calls) == 1
    (csrc / "shared.cuh").write_text("// v2\n")
    second = _build.build_library("k", ["kernel.cu"])
    assert second != first and second.exists() and len(calls) == 2


def test_build_depends_on_its_sources(fake_nvcc):
    csrc, calls = fake_nvcc
    (csrc / "other.cu").write_text("// other\n")
    base = _build.build_library("k", ["kernel.cu"])
    both = _build.build_library("k", ["kernel.cu", "other.cu"])
    assert both != base and str(csrc / "other.cu") in calls[-1]
    (csrc / "kernel.cu").write_text('#include "shared.cuh"\n// edit\n')
    assert _build.build_library("k", ["kernel.cu"]) not in (base, both)
    assert len(calls) == 3
