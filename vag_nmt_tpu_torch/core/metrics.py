"""Structured metrics logging: a JSON-lines file plus a human-readable
line on a stream, and a step timer that waits for the card (own copy of
the JAX package's ``core/metrics.py``)."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, IO, Optional

import torch


class MetricsLogger:
    def __init__(self, jsonl_path: Optional[str] = None, stream: IO = sys.stdout):
        self._stream = stream
        self._fh: Optional[IO] = None
        if jsonl_path:
            Path(jsonl_path).parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(jsonl_path, "a", buffering=1)

    def log(self, tag: str, **fields: Any) -> None:
        rec: Dict[str, Any] = {"tag": tag, "time": time.time(), **fields}
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        human = " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in fields.items()
        )
        self._stream.write(f"[{tag}] {human}\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class StepTimer:
    """Wall-clock timer that waits for the work it times: ``stop`` first
    synchronizes the CUDA device of each tensor it is given (CPU tensors
    need no fence: their work is done when they exist)."""

    def __init__(self):
        self._t0 = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, *fence_on: torch.Tensor) -> float:
        for dev in {x.device for x in fence_on if x.is_cuda}:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - self._t0
