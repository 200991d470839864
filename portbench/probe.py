"""The calibration probe printed before a run's result: the host-to-device
copy rate, one fixed kernel's time and the card's clocks and power, so
that a drift between machines can be told apart from a drift in the code.
It reads only; nothing of it enters a result."""

from __future__ import annotations

import subprocess
from typing import Dict

import torch

SMI_FIELDS = ("name,clocks.sm,clocks.mem,clocks.max.sm,power.draw,"
              "power.limit,temperature.gpu")


def _events_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def probe(dev) -> Dict:
    out: Dict = {}
    host = torch.empty(64 << 20, dtype=torch.float32, pin_memory=True)
    card = torch.empty_like(host, device=dev)
    card.copy_(host)
    ms = _events_ms(lambda: card.copy_(host, non_blocking=True), 5)
    out["h2d_gb_per_s"] = host.numel() * 4 / ms / 1e6
    a = torch.ones((8192, 8192), dtype=torch.bfloat16, device=dev)
    a @ a
    out["bf16_gemm_8192_ms"] = _events_ms(lambda: a @ a, 5)
    del host, card, a
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30)
        out["nvidia_smi"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"unavailable: {e}"
    return out
