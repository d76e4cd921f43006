"""Build and load the port's CUDA kernels.

The sources under ``alg_tpu_torch/csrc`` compile with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, which would multiply the build time). Each
source is one compile unit, unless it declares variants in a comment line
``// build-variants: MACRO=v1,v2,...``: it is then compiled once per value
with ``-DMACRO=<value>`` and gives each variant its own entry point. The
units compile side by side, one ``nvcc -c`` process each, and are then linked. The library lands in
``alg_tpu_torch/_build/``, named by a hash of the sources, units and flags,
and is built at first use; later calls in the process reuse the loaded
handle.

Nothing here runs at import time, and nothing falls back: a missing ``nvcc``
or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_VARIANTS = re.compile(r"^//\s*build-variants:\s*(\w+)\s*=\s*([\w,\s]+?)\s*$", re.MULTILINE)

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


def variants(src: Path):
    """``(macro, values)`` of a source's ``// build-variants:`` line, or None."""
    found = _VARIANTS.search(src.read_text())
    if found is None:
        return None
    return found.group(1), tuple(v.strip() for v in found.group(2).split(","))


def compile_units():
    """(object stem, source, extra nvcc flags) for every compile unit."""
    units = []
    for src in _sources()[0]:
        declared = variants(src)
        if declared is None:
            units.append((src.stem, src, ()))
        else:
            macro, values = declared
            units += [(f"{src.stem}.{macro}_{v}", src, (f"-D{macro}={v}",)) for v in values]
    return units


def library_path() -> Path:
    """Where the library for the current sources, units and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for stem, _, extra in compile_units():
        h.update(" ".join((stem, *extra)).encode())
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
    units = compile_units()
    if not units:
        raise RuntimeError(f"no CUDA sources under {SOURCE_DIR}")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.tmp{os.getpid()}"

    def compile_one(unit):
        stem, src, extra = unit
        obj = BUILD_DIR / f"{tag}.{stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(src)]
        return obj, cmd, subprocess.run(cmd, capture_output=True, text=True)

    with ThreadPoolExecutor(max_workers=len(units)) as pool:
        results = list(pool.map(compile_one, units))
    objs = [obj for obj, _, _ in results]
    log = "".join(" ".join(cmd) + "\n" + proc.stdout + proc.stderr for _, cmd, proc in results)
    tmp = BUILD_DIR / f"{tag}.so"
    failed = [proc for _, _, proc in results if proc.returncode != 0]
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        log += " ".join(cmd) + "\n" + link.stdout + link.stderr
        if link.returncode != 0:
            failed = [link]
    out.with_suffix(".log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (rc={failed[0].returncode}):\n{failed[0].stderr[-8000:]}")
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
