"""Builds the port's kernels from the sources in the checkout, at first use.

Every kernel is CUDA C++ (``csrc/*.cu``): ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface in ``build/`` at the repository
root (git-ignored), loaded with ctypes. The file name carries a hash of the
source and of the shared headers (``csrc/*.cuh``), so an edited source is
rebuilt and a stale library is never loaded. A host C++ source
(``csrc/*.cc``: the RLE codec of the training data) is built the same way
with the host's C++ compiler (``$CXX``, else ``c++``).

Nothing is downloaded, and nothing outside the checkout is written.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build"
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# what the last build of each library printed and how long it took; read by
# chip_smoke.py to show registers, shared memory and spills per kernel
BUILD_LOG: dict = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use")
    return found


def _source(name: str) -> Path:
    """``csrc/<name>.cu``, else the host source ``csrc/<name>.cc``."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cc"


def _library_path(name: str) -> Path:
    """``build/lib<name>_<hash>.so`` for ``csrc/<name>.cu`` (or ``.cc``)."""
    h = hashlib.sha256(_source(name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _compile_command(src: Path, out: Path) -> list:
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    cxx = os.environ.get("CXX") or shutil.which("c++") or "c++"
    return [cxx, *HOST_CXX_FLAGS, "-o", str(out), str(src)]


def build_libraries(names) -> None:
    """Compile the source of every name not built yet, one compiler process
    per source, all started together; a failed build raises with the
    compiler's log."""
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "log": "(cached)"})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _compile_command(_source(name), tmp)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{proc.args[0]} failed for csrc/"
                          f"{_source(name).name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (or ``.cc``) into
    ``build/lib<name>_<hash>.so``."""
    build_libraries([name])
    return _library_path(name)


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name)))
