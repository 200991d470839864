"""What the port's CUDA graphs share: the dispatch rule, the memory their
pools hold, and the accounting that carries the kernels' launch counters
through replays.

The kernels' wrappers count their host calls in integer attributes
(``.launches``, ``.grids``, ...), which a replay of a captured graph does
not make. A graph records the counters' deltas over its capture
(``counter_deltas``) and each replay adds them (``replayed``). A caller
names the wrappers its graphs may launch as (module, wrapper name) pairs;
each counter is read and written through the module, so a caller that
rebinds a wrapper is counted on its own. ``decode/graphs.py`` (the beam
loops) and ``train/graphs.py`` (the K-step train dispatch) each keep
their list."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

DISPATCHES = ("graph", "eager")

# the integer counters a kernel's wrapper may carry
COUNTS = ("launches", "grids", "passes", "bf16_launches", "beam_groups",
          "replays")

Wrappers = Sequence[Tuple[object, str]]


def resolve_dispatch(dispatch: Optional[str], dev: torch.device,
                     mesh=None) -> str:
    """"graph" or "eager" on ``dev``. None: "graph" on a CUDA device with
    no mesh (or a 1 x 1 one), else "eager": the CPU, and a mesh of several
    ranks, whose gloo collectives pass through the host. "graph" on the
    CPU or on such a mesh raises ValueError."""
    multi = mesh is not None and mesh.n_data * mesh.n_model > 1
    if dispatch is None:
        return "graph" if dev.type == "cuda" and not multi else "eager"
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown dispatch {dispatch!r}; one of {DISPATCHES}")
    if dispatch == "graph" and dev.type != "cuda":
        raise ValueError("dispatch='graph' needs a CUDA device (CUDA graphs); "
                         f"the loop runs on {dev}")
    if dispatch == "graph" and multi:
        raise ValueError("dispatch='graph' runs no mesh of several ranks: "
                         "its collectives pass through the host")
    return dispatch


def counter_deltas(before: Dict, after: Dict) -> Dict:
    """The counters that moved between two readings, by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def replayed(counts: Dict, deltas: Dict, n: int) -> Dict:
    """``counts`` after ``n`` replays of a graph whose capture moved them by
    ``deltas``."""
    out = dict(counts)
    for k, d in deltas.items():
        out[k] = out.get(k, 0) + n * d
    return out


def read_counts(wrappers: Wrappers) -> Dict:
    """{(wrapper name, counter): value} of each wrapper in ``wrappers``."""
    out = {}
    for mod, name in wrappers:
        fn = getattr(mod, name)
        for attr in COUNTS:
            v = getattr(fn, attr, None)
            if isinstance(v, int):
                out[(name, attr)] = v
    return out


def write_counts(counts: Dict, wrappers: Wrappers) -> None:
    """Sets the counters of ``counts`` on the wrappers of ``wrappers``."""
    mods = {name: mod for mod, name in wrappers}
    for (name, attr), v in counts.items():
        setattr(getattr(mods[name], name), attr, v)


def pool_bytes(pools) -> int:
    """Device memory that the graph memory pools ``pools``
    (``torch.cuda.graph_pool_handle``s) hold."""
    ids = {tuple(p) for p in pools}
    if not ids:
        return 0
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) in ids)
