"""Build and load the port's CUDA kernels.

All sources under ``alg_tpu_torch/csrc`` compile with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, which would multiply the build time). The library lands
in ``alg_tpu_torch/_build/``, named by a hash of the sources and flags, and is
built at first use; later calls in the process reuse the loaded handle.

Nothing here runs at import time, and nothing falls back: a missing ``nvcc``
or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of the C entry points (csrc/common.cuh, enum alg::DType)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): cannot build the CUDA kernels")


def _sources():
    return sorted(SOURCE_DIR.glob("*.cu")), sorted(SOURCE_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libalg_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is already built; return its path.

    The compiler's resource report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    cu, _ = _sources()
    if not cu:
        raise RuntimeError(f"no CUDA sources under {SOURCE_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (rc={proc.returncode}):\n{proc.stderr[-8000:]}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
