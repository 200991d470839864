"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/kernels/`` at the
repository root, named by a hash of its source, the shared headers
``csrc/*.cuh``, flags and defines (so an edited source rebuilds), and
loaded through ``ctypes``. Pointers and the
stream are passed as ``c_void_p``. A kernel's wrapper module declares it
with its C entry point and the ``-D`` defines that carry the tiling the
wrapper plans with, so the tiling has one owner. Nothing here runs at
import time: the first call of a kernel builds it, and ``build_all`` builds
every declared kernel at once, one ``nvcc`` process per source, all started
together. ``build_variants`` and ``loaded_as`` serve the tuning studies
(``ops/*_tune.py``): builds of a source with text edits, put in place of
the kernel's own library under its wrapper; no path of the port runs them.
A source may be built more than once under names of its own (``declare``'s
``src``), each with its own defines: the beam top-K kernels have one
instance for K <= 8 and one for K <= 16.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> ({C function name: argtypes}, -D defines, source name); filled
# by each kernel's wrapper module.
_KERNELS: Dict[str, Tuple[Dict[str, list], Dict[str, int], str]] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, str] = {}      # nvcc's output (ptxas -v) of each build here


def declare(name: str, fn: str, argtypes: list,
            defines: Optional[Dict[str, int]] = None,
            src: Optional[str] = None) -> None:
    """Declare C entry point ``fn`` of the build ``name`` of csrc/<src>.cu
    (``src`` defaults to ``name``); a build with several entry points
    declares each, with the same defines."""
    fns, _, _ = _KERNELS.setdefault(name, ({}, dict(defines or {}),
                                           src or name))
    fns[fn] = argtypes


def _src(name: str) -> Path:
    return CSRC / f"{_KERNELS[name][2] if name in _KERNELS else name}.cu"


def _flags(name: str) -> List[str]:
    defines = _KERNELS[name][1]
    return NVCC_FLAGS + [f"-D{k}={v}" for k, v in sorted(defines.items())]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = _src(name)
    h = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode())
    for hdr in sorted(CSRC.glob("*.cuh")):     # shared device code
        h.update(hdr.read_bytes())
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
    cmd = [_nvcc(), *_flags(name), "-o", tmp, str(_src(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, job) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    _LOGS[name] = out
    os.replace(tmp, so)


_PTXAS_FN = re.compile(r"Function properties for (\S+)")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def spills(name: str) -> Dict[str, Tuple[int, int]]:
    """{mangled kernel name: (spill store bytes, spill load bytes)} from
    ptxas's report of build ``name`` in this process (empty where the
    library was already built)."""
    out, fn = {}, None
    for line in _LOGS.get(name, "").splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            fn = m.group(1)
            continue
        m = _PTXAS_SPILL.search(line)
        if m and fn is not None:
            out[fn] = (int(m.group(1)), int(m.group(2)))
            fn = None
    return out


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


def _bind(name: str, path: Path) -> ctypes.CDLL:
    """The library at ``path`` with build ``name``'s entry points typed."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _KERNELS[name][0].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of build ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = _LOADED[name] = _bind(name, _target(name))
    return lib


def apply_edits(text: str, label: str, edits) -> str:
    """``text`` with each (old, new) of ``edits`` replaced in turn; raises,
    naming ``label``, where an old text is not there (the source changed
    under a tuning study's edit)."""
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant {label!r}: {old!r} not in the source")
        text = text.replace(old, new)
    return text


_LOCAL_INCLUDE = re.compile(r'^#include "(\w+\.cuh)"\n', re.M)


def source(name: str) -> str:
    """Build ``name``'s source with each ``#include "<header>.cuh"`` of csrc/
    replaced by that header's text (without its ``#pragma once``): the text
    that the tuning studies edit, helpers shared through a header
    included."""
    def inline(m):
        hdr = (CSRC / m.group(1)).read_text()
        return hdr.replace("#pragma once\n", "")

    return _LOCAL_INCLUDE.sub(inline, _src(name).read_text())


def build_variants(name: str, variants, out_dir: Path) -> List[ctypes.CDLL]:
    """One library of csrc/<name>.cu for each (label, edits) of
    ``variants``, ``source(name)`` edited by ``apply_edits`` and built with
    the kernel's flags into ``out_dir``, all nvcc processes at once; each
    with the kernel's entry points typed."""
    src = source(name)
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for n, (label, edits) in enumerate(variants):
            cu = out_dir / f"{name}_{n}.cu"
            cu.write_text(apply_edits(src, label, edits))
            jobs.append(subprocess.Popen(
                [_nvcc(), *_flags(name), "-I", str(CSRC),
                 "-o", str(out_dir / f"{name}_{n}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for (label, _), proc in zip(variants, jobs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu, variant "
                                   f"{label!r}:\n{out}")
    finally:
        for proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [_bind(name, out_dir / f"{name}_{n}.so") for n in range(len(jobs))]


@contextlib.contextmanager
def loaded_as(name: str, lib: ctypes.CDLL):
    """Within the block, the wrappers of csrc/<name>.cu launch through
    ``lib`` (one of ``build_variants``) in place of the kernel's library."""
    old = _LOADED.get(name)
    _LOADED[name] = lib
    try:
        yield lib
    finally:
        if old is None:
            _LOADED.pop(name, None)
        else:
            _LOADED[name] = old
