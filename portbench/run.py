"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything a cell is made of is found by
name: the cell in ``BENCHMARK.json``, its configuration in the file that
names, its traffic in ``portbench/traffic/<traffic>.json`` (whose
``kind`` picks the driver, ``portbench/drivers/<kind>.py``), the limits of
its check in ``portbench/limits/<cell>.json`` and each per-layer metric's
reader in ``portbench/metrics/<metric>.py``.

A run makes its inputs and weights from the seed, warms up the cell's own
shapes, measures for ``--seconds`` (under ``torch.profiler`` with
``--trace 1``), then checks what the window produced against the plain
reference and prints, last, one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``,
and ``checks``, each number compared beside its limit (also the last
lines on standard error). A calibration probe goes out on a line before
it. Without a card, or with fewer than the cell asks for, it exits with 2
and prints no result; with JAX or the JAX package loaded once the window
has closed, with 3."""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock (from
    /proc; the interpreter's own start-up where that cannot be read)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
# every build and kernel cache at a fixed place inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / "portbench_cache" / _sub)
os.environ["USE_FLAX"] = "0"
# one intra-op thread: the host's work is one Python thread's, and a pool
# of spinning workers would only take cores from it
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vag_nmt_tpu")


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: Dict, w: Dict, root: Path = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == w["config"]:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration {w['config']!r} in BENCHMARK.json")


def traffic_of(w: Dict, pkg: Path = PKG) -> Dict:
    return load_json(pkg / "traffic" / f"{w['traffic']}.json")


def limits_of(w: Dict, pkg: Path = PKG) -> Dict:
    return load_json(pkg / "limits" / f"{w['name']}.json")


def metric_reader(name: str, pkg: Path = PKG):
    """The ``read`` of ``portbench/metrics/<name>.py``."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_of(bench: Dict, w: Dict) -> List[Dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    that list no cells where the cell reports the metric they move."""
    mine = {e["name"] for e in end_to_end_of(bench, w)}
    return [p for p in bench["per_layer"]
            if (w["name"] in p["workloads"] if "workloads" in p
                else p["moves"] in mine)]


def end_to_end_of(bench: Dict, w: Dict) -> List[Dict]:
    return [e for e in bench["end_to_end"]
            if "workloads" not in e or w["name"] in e["workloads"]]


def judge(numbers: Dict[str, float], limits: Dict) -> Dict[str, Dict]:
    """Each number compared beside its limit, and whether it holds."""
    out = {}
    for name, lim in limits["numbers"].items():
        v = numbers.get(name, float("nan"))
        out[name] = {"value": v, "limit": lim["max"], "holds": "<=",
                     "ok": bool(v <= lim["max"])}
    return out


def _num(v: float):
    """A number for the JSON line: a value that is not finite as its
    name ("inf", "nan"), which strict JSON has no number for."""
    return v if v == v and abs(v) != float("inf") else repr(v)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(bench: Dict, w: Dict, seed: int, seconds: float, trace_on: bool,
            device, t_start: float, *, fault: Optional[str] = None,
            replace=None, root: Path = ROOT, pkg: Path = PKG) -> Dict:
    """One run of cell ``w`` on ``device``: the result's fields (without
    the device check), plus ``_checks`` for the caller to print and
    ``_look``, what a check keeps behind its numbers (training's)."""
    import torch

    from portbench import faults, trace

    conf = config_of(bench, w, root)
    traffic = traffic_of(w, pkg)
    limits = limits_of(w, pkg)
    drv = importlib.import_module(f"portbench.drivers.{traffic['kind']}")
    tracer = trace.Tracer(trace_on)
    cuda = device.type == "cuda"
    with faults.planted(fault, traffic["kind"]):
        cell = drv.Cell(conf, traffic, seed, device)
        cell.warm()
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        with tracer.window():
            e2e = cell.window(seconds, trace.span)
    reduced = tracer.reduce()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    reading = cell.reading(reduced)
    cell.release()
    numbers, attempted, failed = cell.check(traffic.get("check_sample", 0),
                                            replace)
    checks = judge(numbers, limits)
    correct = failed == 0 and all(c["ok"] for c in checks.values())
    metrics: Dict[str, Dict] = {}
    if trace_on:
        for p in per_layer_of(bench, w):
            v = metric_reader(p["name"], pkg)(reading)
            if v is not None:
                metrics[p["name"]] = {"value": v, "unit": p["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for e in end_to_end_of(bench, w):
            if e["name"] in e2e:
                metrics[e["name"]] = {"value": e2e[e["name"]],
                                      "unit": e["unit"]}
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": w["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev_info}
    if reduced is not None:
        dev_info["busy_s"] = reduced["busy_s"]
        dev_info["window_s"] = reduced["window_s"]
        out["breakdown"] = {"device_ops": trace.device_ops(reduced["kernels"]),
                            "idle_gaps": reduced["idle_gaps"]}
    out["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                     for k, c in checks.items()}
    out["_checks"] = checks
    out["_look"] = getattr(cell, "look", None)
    return out


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if a.seed < 0 or a.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")
    return a


def main(argv=None) -> int:
    args = parse(argv)
    bench = load_benchmark()
    w = workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"portbench: {w['name']} needs {w['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.probe import probe

    dev = torch.device("cuda", 0)
    out = execute(bench, w, args.seed, args.seconds, bool(args.trace), dev,
                  T_START)
    checks = out.pop("_checks")
    out.pop("_look")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps({"probe": probe(dev)}), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} {c['holds']} {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
