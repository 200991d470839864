"""The traced run's window: ``torch.profiler`` over it (host operations and
the card's), reduced to what the per-layer metrics read.

``busy_s`` is the time in which some operation (kernel, copy, set) ran on
the device, the union of their intervals within the window; ``window_s``
the window's length. Each kernel's device seconds are summed by name. An
idle gap is an interval of the window in which nothing ran on the device;
the longest are put down to the innermost host operation running at their
middle (the benchmark's own spans, ``portbench.*``, name the calls into
the program)."""

from __future__ import annotations

import contextlib
import heapq
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "portbench.window"
GAPS_ATTRIBUTED = 4000


def span(name: str):
    """A named host span (a ``record_function`` range in the trace)."""
    return torch.profiler.record_function(name)


class Tracer:
    """``with tracer.window():`` profiles the block when on, else runs it
    bare; ``reduce()`` then gives the trace's readings (None when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with span(WINDOW_SPAN):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self.prof = prof

    def reduce(self) -> Optional[Dict]:
        """The trace's readings, from the profiler's raw events (the
        per-event objects that ``prof.events()`` builds cost a minute a
        million events). Annotations that the profiler mirrors onto the
        device's timeline (the spans) are not device work and are left
        out."""
        if self.prof is None:
            return None
        cpu = torch.autograd.DeviceType.CPU
        w0 = w1 = None
        dev: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str]] = []
        for e in self.prof.profiler.kineto_results.events():
            a, b = e.start_ns() * 1e-3, e.end_ns() * 1e-3
            if e.device_type() != cpu:
                if not e.is_user_annotation():
                    dev.append((a, b, e.name()))
                continue
            host.append((a, b, e.name()))
            if e.name() == WINDOW_SPAN:
                w0, w1 = a, b
        self.prof = None
        if w0 is None:
            return None
        kernels: Dict[str, float] = {}
        for a, b, name in dev:
            kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-6
        busy, gaps = _union(sorted((max(a, w0), min(b, w1))
                                   for a, b, _ in dev if b > w0 and a < w1),
                            w0, w1)
        return {"busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6,
                "kernels": kernels,
                "idle_gaps": _attribute(gaps, host)}


def _union(iv, w0: float, w1: float) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length of the intervals' union, the gaps of [w0, w1] that
    they leave)."""
    busy, gaps, end = 0.0, [], w0
    for a, b in iv:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    return busy, gaps


def _attribute(gaps, host) -> List[List]:
    """The idle seconds by the innermost host operation (the latest
    started of those running) at each of the longest gaps' middles, the
    ten largest, [[name, seconds], ...]: one sweep over the host
    operations in start order, a heap of those started by the latest
    start."""
    if not gaps or not host:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_ATTRIBUTED]
    gaps.sort(key=lambda g: g[0] + g[1])
    host = sorted(host)
    heap: List = []
    i = 0
    out: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(no host operation)"
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:10]]


def device_ops(kernels: Dict[str, float]) -> List[List]:
    """The ten device operations that took most time, [[name, seconds]]."""
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return [[k[:160], v] for k, v in top]


def kernel_s(kernels: Dict[str, float], *prefixes: str) -> float:
    """Device seconds of the kernels whose name holds a word that starts
    with one of ``prefixes`` (a kernel's C name, e.g. ``readout_topk``)."""
    import re

    pat = re.compile(r"\b(" + "|".join(re.escape(p) for p in prefixes) + r")")
    return sum(v for k, v in kernels.items() if pat.search(k))
