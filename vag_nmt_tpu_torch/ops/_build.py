"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/kernels/`` at the
repository root, named by a hash of its source, flags and defines (so an
edited source rebuilds), and loaded through ``ctypes``. Pointers and the
stream are passed as ``c_void_p``. A kernel's wrapper module declares it
with its C entry point and the ``-D`` defines that carry the tiling the
wrapper plans with, so the tiling has one owner. Nothing here runs at
import time: the first call of a kernel builds it, and ``build_all`` builds
every declared kernel at once, one ``nvcc`` process per source, all started
together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# name -> (C function name, argtypes, -D defines); filled by each kernel's
# wrapper module.
_KERNELS: Dict[str, Tuple[str, list, Dict[str, int]]] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def declare(name: str, fn: str, argtypes: list,
            defines: Optional[Dict[str, int]] = None) -> None:
    _KERNELS[name] = (fn, argtypes, dict(defines or {}))


def _flags(name: str) -> List[str]:
    defines = _KERNELS[name][2]
    return NVCC_FLAGS + [f"-D{k}={v}" for k, v in sorted(defines.items())]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, target) or None
    when the library for this source hash already exists."""
    so = _target(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, job) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, so)


def build_all() -> float:
    """Build every declared kernel in parallel; returns the seconds spent."""
    t0 = time.perf_counter()
    jobs: List = [(n, _start(n)) for n in sorted(_KERNELS)]
    try:
        for n, job in jobs:
            if job is not None:
                _finish(n, job)
    finally:
        for _, job in jobs:
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_target(name)))
        fn, argtypes, _ = _KERNELS[name]
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
