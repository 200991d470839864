"""The K-step train dispatch as CUDA graphs (counterpart of the
``lax.scan`` in the JAX package's ``make_multi_step``: K train steps of
one batch shape as one device program).

``StepGraphs`` serves one ``train_loop`` call. It holds one set of static
state buffers (params, mu, nu, the device step ``count``, lr: the
tensors of the state it is given) that every graph reads and, at its end,
writes back in place; a state that eager single steps made in between is
copied into them before a replay (``copy_state``). Per shape key (every
leaf's shape and dtype: src T, tgt T, K, the compute dtype's streams) it
keeps a static stacked batch on the device, which the host fills with
one copy per dispatch, and a graph captured the first time the key is
seen: K steps of ``train/step.py``'s body (``run_steps``, the code the
eager ``make_multi_step`` runs), the state copied back into the static
buffers and the aux stack into a static output. All of the call's graphs
share one memory pool (``torch.cuda.graph_pool_handle``) and are captured
on one stream of their own (not the default stream): the caching
allocator hands a freed block only to the stream that freed it, so with a
stream per graph (the decode graphs' design, kept there for replays on
several streams at once) every shape key would hold a step's worth of the
pool alone (15.6 GB for 14 keys on an H100, chip_smoke.py phase 26). The
replays all run on the caller's stream, one after another.

Dropout: K generators on the device, registered with every graph
(``CUDAGraph.register_generator_state``). Before each replay the host
seeds generator k to (seed + 1, step + k), as ``make_train_step`` seeds
step k's own generator, and the replay reads that seed and offset 0 on the
device: its draws are those of K eager single steps.

Before a capture the body runs once on the capture stream (autograd,
cuBLAS handles, the kernels' lazy build); that warm-up leaves the static
state, the generators and the launch counters as they were. The kernels'
counters (kernels 2-5: ``gru_fwd``, ``gru_bwd``, ``dec_scan_fwd``,
``dec_scan_bwd``) count host calls, which a replay does not make: a graph
keeps its capture's counter deltas and each replay adds them
(``core/graphs.py``). A failed capture raises; nothing falls back to eager.

``StepGraphs(capture=False)`` runs each graph's captured code
(``_StepGraph.advance``) eagerly in place of a replay: the CPU tests'
model of the graph path."""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vag_nmt_tpu_torch.core import graphs as _graphs
from vag_nmt_tpu_torch.core.config import Config
from vag_nmt_tpu_torch.ops import dec_scan as _dec_scan
from vag_nmt_tpu_torch.ops import gru_kernel as _gru_kernel
from vag_nmt_tpu_torch.train.state import TrainState, copy_state
from vag_nmt_tpu_torch.train.step import (make_step_body, row, run_steps,
                                          step_seed)

# (module, wrapper name): the kernels a train step launches
_WRAPPERS = ((_gru_kernel, "gru_fwd"), (_gru_kernel, "gru_bwd"),
             (_dec_scan, "dec_scan_fwd"), (_dec_scan, "dec_scan_bwd"))


def read_counts() -> Dict:
    """{(wrapper name, counter): value} of kernels 2-5's wrappers."""
    return _graphs.read_counts(_WRAPPERS)


def write_counts(counts: Dict) -> None:
    _graphs.write_counts(counts, _WRAPPERS)


def _host_leaf(v: Any) -> np.ndarray:
    """A host leaf of a stacked batch as the device holds it: uint16
    tokens widened to int32 (as ``to_device``)."""
    a = np.asarray(v)
    return a.astype(np.int32) if a.dtype == np.uint16 else a


_KINDS = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


def stack_key(stack: Dict[str, Any]) -> Tuple:
    """A stacked batch's shape key: each leaf's name, shape and dtype."""
    return tuple((k, tuple(np.shape(v)), str(_host_leaf(v).dtype))
                 for k, v in sorted(stack.items()) if k != "index")


class _StackBuffer:
    """A static stacked batch on the device: one flat int32 buffer, each
    leaf (int32 or fp32, 4 bytes an element) a view of it, filled by one
    host copy from a staging buffer (pinned on a CUDA device, reused once
    its last copy has run)."""

    def __init__(self, stack: Dict[str, Any], dev: torch.device):
        self.layout = []
        n = 0
        for k, v in sorted(stack.items()):
            if k == "index":
                continue
            a = _host_leaf(v)
            if a.dtype not in _KINDS:
                raise ValueError(f"stacked batch leaf {k!r}: dtype {a.dtype} "
                                 "(int32, uint16 or float32)")
            self.layout.append((k, a.shape, a.dtype, n))
            n += a.size
        self.flat = torch.empty(n, dtype=torch.int32, device=dev)
        cuda = dev.type == "cuda"
        self.staging = torch.empty(n, dtype=torch.int32, pin_memory=cuda)
        self.host = self.staging.numpy()
        self.copied = torch.cuda.Event() if cuda else None
        self.views = {k: self.flat[o:o + int(np.prod(shape))]
                      .view(_KINDS[dt]).view(shape)
                      for k, shape, dt, o in self.layout}

    def fill(self, stack: Dict[str, Any]) -> None:
        if self.copied is not None:
            self.copied.synchronize()
        for k, shape, dt, o in self.layout:
            a = _host_leaf(stack[k])
            if a.shape != shape or a.dtype != dt:
                raise ValueError(f"stacked batch leaf {k!r}: {a.shape} "
                                 f"{a.dtype}, the buffer's {shape} {dt}")
            self.host[o:o + a.size] = a.reshape(-1).view(np.int32)
        self.flat.copy_(self.staging, non_blocking=True)
        if self.copied is not None:
            self.copied.record()


class _StepGraph:
    """One shape key's static batch, its K-step code and its graph."""

    def __init__(self, owner: "StepGraphs", stack: Dict[str, Any]):
        self.owner = owner
        self.batch = _StackBuffer(stack, owner.state.lr.device)
        self.k = int(np.shape(stack["src"])[0])
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.keys: List[str] = []
        self.out: Optional[torch.Tensor] = None    # (len(keys), K) fp32
        self.deltas: Dict = {}
        self.capture_s = 0.0

    def advance(self) -> None:
        """K steps from the static state and batch, the state written back
        into the static buffers and the aux stack into ``out``: the code a
        graph captures (and, eagerly, the tests' model of a replay)."""
        o = self.owner
        st, aux = run_steps(o.body, o.state, self.batch.views,
                            o.gens[:self.k], o.img_table)
        copy_state(o.state, st)
        self.keys = self.keys or sorted(aux)
        stacked = torch.stack([aux[k].to(torch.float32) for k in self.keys])
        if self.out is None:
            self.out = torch.empty_like(stacked)
        self.out.copy_(stacked)

    def capture(self) -> None:
        """Warm up one step on the call's capture stream (counting
        nothing, the generators' states put back), then capture
        ``advance`` on it into the call's memory pool, the K generators
        registered with the graph. The capture's counter deltas are kept
        for the replays, its host seconds (warm-up included) in
        ``capture_s``."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError("CUDA graphs of train steps need "
                               "CUDAGraph.register_generator_state (torch "
                               f"{torch.__version__} has none)")
        o = self.owner
        dev = o.state.lr.device
        gens = o.gens[:self.k]
        if o.stream is None:
            o.stream = torch.cuda.Stream(dev)
        stream = o.stream
        before = read_counts()
        saved = [g.get_state() for g in gens]
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            _, aux = o.body(o.state, row(self.batch.views, 0), gens[0],
                            o.img_table)
            self.keys = sorted(aux)
            self.out = torch.empty((len(aux), self.k), dtype=torch.float32,
                                   device=dev)
        torch.cuda.current_stream(dev).wait_stream(stream)
        for g, s in zip(gens, saved):
            g.set_state(s)
        write_counts(before)
        for g in gens:
            graph.register_generator_state(g)
        # capture_begin / capture_end on the capture stream, not
        # torch.cuda.graph, which also empties the allocator's cache
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=o.pool)
            try:
                self.advance()
            finally:
                graph.capture_end()
        self.deltas = _graphs.counter_deltas(before, read_counts())
        write_counts(before)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0


class StepGraphs:
    """The K-step dispatches of one ``train_loop`` call (see above). The
    state's tensors become the static buffers (each replay overwrites
    them); ``run(state, stack)`` returns the state after the stack's K
    steps and its aux stack. ``captures``, ``replays`` and ``capture_s``
    count what it did."""

    def __init__(self, cfg: Config, state: TrainState, *,
                 img_table: Optional[torch.Tensor] = None,
                 with_img_table: bool = False, capture: bool = True):
        self.cfg = cfg
        self.state = state
        self.img_table = img_table
        self.body = make_step_body(cfg, with_img_table=with_img_table)
        self.capture = capture
        self.gens: List[torch.Generator] = []
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.stream: Optional[torch.cuda.Stream] = None    # the captures'
        self.graphs: Dict[Tuple, _StepGraph] = {}
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def _seed(self, step: int, k: int) -> None:
        dev = self.state.lr.device
        while len(self.gens) < k:
            self.gens.append(torch.Generator(device=dev))
        for i, g in enumerate(self.gens[:k]):
            g.manual_seed(step_seed(self.cfg.train.seed + 1, step + i))

    def run(self, state: TrainState, stack: Dict[str, Any]
            ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """The K steps of ``stack`` (a host stacked batch) from ``state``
        (copied into the static buffers where it is not them) as one
        replay: (the static state at step + K, the aux stack, each leaf
        (K,))."""
        key = stack_key(stack)
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = _StepGraph(self, stack)
        self.state = copy_state(self.state, state)
        g.batch.fill(stack)
        self._seed(state.step, g.k)
        if g.graph is None and self.capture:
            g.capture()
            self.captures += 1
            self.capture_s += g.capture_s
            self._seed(state.step, g.k)
        if g.graph is not None:
            g.graph.replay()
            write_counts(_graphs.replayed(read_counts(), g.deltas, 1))
        else:
            g.advance()
        self.replays += 1
        self.state = self.state._replace(step=state.step + g.k)
        out = g.out.clone()
        return self.state, {k: out[i] for i, k in enumerate(g.keys)}

    def pool_bytes(self) -> int:
        """Device memory the graphs' shared pool holds (0 without
        captures)."""
        if self.pool is None or not self.captures:
            return 0
        return _graphs.pool_bytes([self.pool])

    def stats(self) -> Dict[str, Any]:
        return {"dispatch": "graph", "captures": self.captures,
                "replays": self.replays, "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes()}


def eager_stats() -> Dict[str, Any]:
    """An eager run's dispatch stats."""
    return {"dispatch": "eager", "captures": 0, "replays": 0,
            "capture_s": 0.0, "pool_bytes": 0}
