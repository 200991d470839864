"""Tracing hooks (counterpart of the JAX package's ``core/profiling.py``,
on ``torch.profiler``).

    with maybe_trace(trace_dir):          # no-op when trace_dir is falsy
        ... work on the card ...

    with step_annotation("train_step"):   # labels the region in the trace
        state, aux = step_fn(...)

The trace is a Chrome-trace JSON (``trace.json`` in ``trace_dir``), which
TensorBoard's profile plugin and Perfetto (ui.perfetto.dev) open."""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler over the block (host ops, and the card's kernels when
    CUDA is there), written to ``trace_dir/trace.json``; a no-op without
    ``trace_dir``."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def step_annotation(name: str):
    """A named region in the profiler's timeline."""
    return torch.profiler.record_function(name)
