"""Builds the port's CUDA kernels (``styler_tpu_torch/csrc/*.cu``) at
first use and loads them with ``ctypes``.

Each source is compiled on its own by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
The library's file name carries a hash of its source, so an edited
kernel is never served from a stale build. Outputs go to
``styler_tpu_torch/_build/`` (git-ignored) or ``$STYLER_TORCH_BUILD_DIR``.
Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
KERNELS = ("resblock", "lstm", "lstm_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: ptxas register/shared-memory/spill report of the last build, per kernel
ptxas_report: Dict[str, str] = {}


def build_dir() -> str:
    return os.environ.get("STYLER_TORCH_BUILD_DIR", os.path.join(_PKG, "_build"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}; set CUDA_HOME")
    return path


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(build_dir(), f"lib{name}-{digest}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns the
    library path per kernel; raises if any compile fails."""
    names = tuple(names or KERNELS)
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        ptxas_report[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _target(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The built library for one kernel, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
