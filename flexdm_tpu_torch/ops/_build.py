"""Build the port's native sources and load them with ctypes.

CUDA: each library is compiled with nvcc once per hash of its sources, the
shared headers and the flags into ``build/flexdm_tpu_torch/`` at the
repository root, for ``sm_90a`` (Hopper), with a plain C interface: the
caller passes device pointers as ``ctypes.c_void_p`` and PyTorch's current
stream.  Nothing here links against PyTorch, so a build takes seconds.  A
missing ``nvcc`` or a failed compile raises with the compiler's output;
there is no fallback.

Host C++ (:func:`build_host_library`, the record decoder
``csrc/tfrecord_io.cc``): compiled with g++ (``$CXX`` if set) and
``-O3 -fPIC -std=c++17 -shared``, keyed by a hash of the source and the
flags, into the same directory.  A failed compile raises with the
compiler's output; only the caller decides what a missing compiler means
(:func:`find_cxx` returns None).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "flexdm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

# Compiler output (ptxas register / shared-memory report) of each library
# built by this process, keyed by library name.
BUILD_LOGS: Dict[str, str] = {}

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin);"
        " the port's CUDA kernels cannot be built"
    )


def _compile(out: Path, cmd_before_output, inputs, compiler: str) -> str:
    """Run ``cmd_before_output + ["-o", tmp, *inputs]`` into a per-pid
    temporary file and move it to ``out`` (several processes may build the
    same library at once); returns the compiler's output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [*cmd_before_output, "-o", str(tmp), *map(str, inputs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{compiler} failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def build_library(name: str, sources: Sequence[str]) -> Path:
    """Compile ``csrc/<sources>`` into ``lib<name>-<hash>.so``; reuse it when
    the sources, every header ``csrc/*.cuh`` (a source may include any of
    them) and the flags are unchanged."""
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [*paths, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_LOGS[name] = _compile(out, [find_nvcc(), *NVCC_FLAGS], paths,
                                    "nvcc")
    return out


def find_cxx() -> Optional[str]:
    """The host C++ compiler: ``$CXX`` if set, else ``g++``, looked up on
    ``PATH``; None where there is none."""
    return shutil.which(os.environ.get("CXX") or "g++")


def build_host_library(name: str, source, cxx: Optional[str] = None,
                       build_dir: Optional[Path] = None) -> Path:
    """Compile one host C++ ``source`` into ``lib<name>-<hash>.so`` under
    ``build_dir`` (default ``build/flexdm_tpu_torch/``); reuse it when the
    source and the flags are unchanged.  Raises where there is no compiler
    or the compile fails."""
    source = Path(source)
    cxx = cxx or find_cxx()
    if cxx is None:
        raise RuntimeError("no host C++ compiler ($CXX or g++ on PATH)")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(source.read_bytes())
    out = Path(build_dir or BUILD_DIR) / (
        f"lib{name}-{digest.hexdigest()[:16]}.so")
    if not out.exists():
        _compile(out, [cxx, *CXX_FLAGS], [source], Path(cxx).name)
    return out


def load_library(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """The loaded library, built on first use."""
    with _lock:
        if name not in _libraries:
            _libraries[name] = ctypes.CDLL(str(build_library(name, sources)))
        return _libraries[name]
