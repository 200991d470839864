"""Structured metrics logging: a JSON-lines file plus a human-readable
line on a stream (own copy of the JAX package's ``core/metrics.py``
``MetricsLogger``)."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, IO, Optional


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
