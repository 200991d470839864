"""Readings for the check's limits, on the chip: for each seed, the
program's numbers over a short window of the cell's own load, the
control's (the reference at the next precision down, in the program's
place) and each planted fault's, in one process.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 2 [--control tf32|fp8] [--faults state_unchanged,...] \\
        [--program-seeds 4,5,...] [--out chiprun_out/readings.jsonl]

Each reading is a JSON line: the cell, the seed, what stood in ("program",
"control:<precision>", "fault:<name>"), the numbers compared and
``correct`` under the cell's limits. The benchmark's own runs never call
this."""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time

from portbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = run.load_benchmark()
    w = run.workload(bench, a.workload)
    kind = run.traffic_of(w)["kind"]
    drv = importlib.import_module(f"portbench.drivers.{kind}")
    seeds = [int(s) for s in a.seeds.split(",") if s]
    pseeds = [int(s) for s in a.program_seeds.split(",") if s]
    jobs = [(s, "program", None, None) for s in pseeds]
    for s in seeds:
        jobs.append((s, "program", None, None))
        if a.control:
            jobs.append((s, f"control:{a.control}", None,
                         drv.control(a.control)))
        for f in (x for x in a.faults.split(",") if x):
            jobs.append((s, f"fault:{f}", f, None))
    out = open(a.out, "a") if a.out else None
    try:
        for seed, what, fault, replace in jobs:
            t0 = time.perf_counter()
            res = run.execute(bench, w, seed, a.seconds, False, dev, t0,
                              fault=fault, replace=replace)
            line = json.dumps({
                "workload": w["name"], "seed": seed, "what": what,
                "correct": res["correct"], "failed": res["failed"],
                "numbers": {k: c["value"] for k, c in res["_checks"].items()},
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "look": res["_look"],
                "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            # the last run's graphs are freed here, not inside the next
            # run's captures (no graph may be destroyed while one captures)
            del res
            gc.collect()
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
