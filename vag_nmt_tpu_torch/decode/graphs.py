"""The decode loops as device programs (counterpart of the JAX package's
jitted loops: a chunk's beam search is one ``lax.while_loop``, the corpus
one program, ``make_fused_corpus_fn``).

A loop body maps a carry to the next one: (t, ..., finished, ...), t a
0-dim int64 tensor on the device, finished the (rows, ...) bool tensor at
index ``fin``. ``run_loop`` runs U bodies per check of the exit condition
(t < t_end and not every entry of finished set), one device read a check,
in one of two dispatches:

- "eager": the host enqueues every operation of every step;
- "graph": ``LoopGraphs`` captures U bodies once as a ``torch.cuda
  .CUDAGraph`` over static carry and state buffers (``_Loop.advance``) and
  replays it; each replay runs U steps, and the host reads the exit flag
  once a replay. The host mirrors t as an int, since t grows by exactly U
  a replay. Tokens, lengths, scores and trip counts are the eager loop's,
  bit for bit: both run the same body.

The streaming-refill loop (``run_stream``, the JAX package's
``beam_search_streaming``: one ``lax.while_loop`` whose body ends in a
``lax.cond``-gated refill) is two programs over static buffers, a trip
and a refill (``_StreamLoop``; ``decode/beam.py`` builds them). Each trip
writes a 0-dim flag, which the host reads once a trip: ``REFILL`` runs
the refill next, ``DONE`` ends the loop. Eagerly the host calls the two
programs; under "graph" each is a captured graph, both captured on one
stream into one memory pool, and the refill graph is replayed only on
the trips that flag it, as the reference's ``lax.cond`` fires.

One ``LoopGraphs`` serves one decode call (``translate_corpus``, or one
``beam_search`` / ``greedy_decode`` / ``beam_search_streaming``) and is
freed with it (nothing holds it past the call): params and decode tables
are per call, and a graph baked on their addresses would decode a later
call's params with this call's weights. Within the call a loop is
captured once per key (its body's arguments and the carry's and state's
shapes and dtypes) and each chunk, or each super-chunk's pool, copies its
initial carry and its ``DecodeState`` rows into the loop's static
buffers.

The kernels' launch counters (``.launches``, ``.grids``, ``.passes``,
``.bf16_launches``, ``.beam_groups``) count host calls, which a replay
does not make: a graph records their deltas over its capture, and each
replay adds them (``core/graphs.py``). The warm-up before a capture
counts nothing, and the readout's device-side recovery counter is
set back after it. Each loop is captured on a stream of its own, with
arrival counters of its own (``ops/topk.stream_counters``)."""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from vag_nmt_tpu_torch.core import graphs as _graphs
from vag_nmt_tpu_torch.core.graphs import (counter_deltas, replayed,
                                           resolve_dispatch)
from vag_nmt_tpu_torch.core.knobs import decode_knobs
from vag_nmt_tpu_torch.models.model import DecodeState
from vag_nmt_tpu_torch.ops import dec_step as _dec_step
from vag_nmt_tpu_torch.ops import readout_topk as _readout
from vag_nmt_tpu_torch.ops import topk as _topk

# (module, wrapper name): the kernels a decode loop body may launch
_WRAPPERS = ((_topk, "beam_topk"), (_topk, "legacy_topk_blocks"),
             (_topk, "legacy_topk_rows"), (_readout, "readout_topk_rows"),
             (_dec_step, "dec_step"))

Carry = Tuple[torch.Tensor, ...]
MakeBody = Callable[[DecodeState, Optional[torch.Tensor]],
                    Callable[[Carry], Carry]]

# a streaming trip's flag: the refill runs next, or the loop ends
REFILL, DONE = 1, 2


class Stream(NamedTuple):
    """A streaming loop's two programs over its static buffers, each in
    place: ``trip`` one decoder step of the working set and its ``flag``
    (REFILL, DONE or 0), ``refill`` the masked refill."""
    trip: Callable[[], None]
    refill: Callable[[], None]
    flag: torch.Tensor


# make_stream(pool, row_cap, set): the programs over the static pool, its
# step caps and the set (a NamedTuple of tensors or None, its ``scores``
# field one entry a beam row)
MakeStream = Callable[[DecodeState, Optional[torch.Tensor], NamedTuple],
                      Stream]


def read_counts() -> Dict:
    """{(wrapper name, counter): value} of every loop kernel's wrapper."""
    return _graphs.read_counts(_WRAPPERS)


def write_counts(counts: Dict) -> None:
    _graphs.write_counts(counts, _WRAPPERS)


def _buffer(x: torch.Tensor) -> torch.Tensor:
    """A static, contiguous buffer of x's shape and dtype (x expanded
    views included), filled by ``copy_``."""
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _signature(x: Optional[torch.Tensor]):
    return None if x is None else (tuple(x.shape), x.dtype)


def _load(dsts, srcs) -> None:
    for dst, src in zip(dsts, srcs):
        if dst is not None:
            dst.copy_(src)


def _saved_recoveries() -> Optional[torch.Tensor]:
    rec = _readout.readout_topk_rows.recoveries
    return None if rec is None else rec.clone()


def _undo_warmup(before: Dict, rec_saved: Optional[torch.Tensor]) -> None:
    """The counters as they were before a warm-up: the launch counts
    ``before``, the readout's recovery counter ``rec_saved`` (zero where
    the warm-up made it)."""
    rec = _readout.readout_topk_rows.recoveries
    if rec is not None and rec_saved is not None:
        rec.copy_(rec_saved)
    elif rec is not None:
        rec.zero_()
    write_counts(before)


class _Loop:
    """One loop's static buffers, body and graph."""

    def __init__(self, make_body: MakeBody, state: DecodeState,
                 row_cap: Optional[torch.Tensor], carry: Carry, unroll: int,
                 fin: int):
        self.state = DecodeState(*(_buffer(x) for x in state))
        self.row_cap = None if row_cap is None else _buffer(row_cap)
        self.carry = tuple(_buffer(x) for x in carry)
        self.done = torch.zeros((), dtype=torch.bool,
                                device=self.carry[0].device)
        self.body = make_body(self.state, self.row_cap)
        self.unroll, self.fin = unroll, fin
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.counters: Optional[torch.Tensor] = None   # kept with the graph
        self.deltas: Dict = {}
        self.capture_s = 0.0

    def load(self, state: DecodeState, row_cap, carry: Carry) -> None:
        _load((*self.state, self.row_cap, *self.carry),
              (*state, row_cap, *carry))

    def advance(self) -> None:
        """U bodies from the static carry back into it, and the exit flag:
        the code a graph captures (and, eagerly, the tests' model of a
        replay)."""
        c = self.carry
        for _ in range(self.unroll):
            c = self.body(c)
        for dst, src in zip(self.carry, c):
            dst.copy_(src)
        self.done.copy_(c[self.fin].all())

    def capture(self) -> None:
        """Warm up once on a side stream (kernel builds, module loads,
        cuBLAS handles), then capture ``advance`` on it. Neither counts a
        launch; the capture's counter deltas are kept for the replays, and
        its host seconds in ``capture_s``."""
        t0 = time.perf_counter()
        dev = self.carry[0].device
        stream = torch.cuda.Stream(dev)
        rows = max(x.shape[0] for x in self.carry if x.dim())
        before = read_counts()
        rec_saved = _saved_recoveries()
        with _topk.stream_counters(dev, stream.cuda_stream, rows) as buf:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self.body(self.carry)
            torch.cuda.current_stream(dev).wait_stream(stream)
            _undo_warmup(before, rec_saved)
            graph = torch.cuda.CUDAGraph()
            # capture_begin / capture_end on the loop's stream, not
            # torch.cuda.graph, which also empties the allocator's cache
            # at every capture (a decode call captures once a loop)
            with torch.cuda.stream(stream):
                graph.capture_begin()
                try:
                    self.advance()
                finally:
                    graph.capture_end()
            self.deltas = counter_deltas(before, read_counts())
            write_counts(before)
        self.graph, self.counters = graph, buf
        self.capture_s = time.perf_counter() - t0

    def run(self, state: DecodeState, row_cap, carry: Carry, t0: int,
            t_end: int, capture: bool) -> Tuple[Carry, int, int]:
        """From ``carry`` at t0: (the last carry, its t, the replays)."""
        self.load(state, row_cap, carry)
        t, n = t0, 0
        if t < t_end and not bool(self.carry[self.fin].all()):
            if self.graph is None and capture:
                self.capture()
            replay = self.graph.replay if self.graph is not None else self.advance
            while True:
                replay()
                n += 1
                t += self.unroll
                if t >= t_end or bool(self.done):
                    break
        if self.graph is not None:
            write_counts(replayed(read_counts(), self.deltas, n))
        return tuple(x.clone() for x in self.carry), t, n


class _StreamLoop:
    """One streaming loop's static buffers (the pool, its step caps and
    the set), its two programs and their graphs."""

    def __init__(self, make_stream: MakeStream, pool: DecodeState,
                 row_cap: Optional[torch.Tensor], init: NamedTuple):
        self.pool = DecodeState(*(_buffer(x) for x in pool))
        self.row_cap = None if row_cap is None else _buffer(row_cap)
        self.set = type(init)(*(None if x is None else _buffer(x)
                                for x in init))
        self.prog = make_stream(self.pool, self.row_cap, self.set)
        self.graphs: Optional[Tuple[torch.cuda.CUDAGraph, ...]] = None
        self.mempool = None              # the graphs' one memory pool
        self.counters: Optional[torch.Tensor] = None   # kept with the graphs
        self.deltas: Tuple[Dict, Dict] = ({}, {})
        self.capture_s = 0.0

    def load(self, pool: DecodeState, row_cap, init: NamedTuple) -> None:
        _load((*self.pool, self.row_cap, *self.set),
              (*pool, row_cap, *init))

    def capture(self, pool: DecodeState, row_cap, init: NamedTuple) -> None:
        """Warm up a trip and a refill on a stream of the loop's own
        (kernel builds, module loads, cuBLAS handles), load the buffers
        again, then capture the trip and the refill on that stream into
        one memory pool. The warm-ups count nothing; each capture's
        counter deltas are kept for its replays, the host seconds of both
        in ``capture_s``."""
        t0 = time.perf_counter()
        dev = self.prog.flag.device
        stream = torch.cuda.Stream(dev)
        cur = torch.cuda.current_stream(dev)
        mempool = torch.cuda.graph_pool_handle()
        rows = self.set.scores.numel()   # the set's beam rows
        before = read_counts()
        rec_saved = _saved_recoveries()
        graphs, deltas = [], []
        with _topk.stream_counters(dev, stream.cuda_stream, rows) as buf:
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                self.prog.trip()
                self.prog.refill()
            cur.wait_stream(stream)
            _undo_warmup(before, rec_saved)
            self.load(pool, row_cap, init)
            for fn in (self.prog.trip, self.prog.refill):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.stream(stream):
                    graph.capture_begin(pool=mempool)
                    try:
                        fn()
                    finally:
                        graph.capture_end()
                deltas.append(counter_deltas(before, read_counts()))
                write_counts(before)
                graphs.append(graph)
        self.graphs, self.mempool, self.counters = tuple(graphs), mempool, buf
        self.deltas = tuple(deltas)
        self.capture_s = time.perf_counter() - t0

    def run(self, pool: DecodeState, row_cap, init: NamedTuple,
            capture: bool) -> Tuple[NamedTuple, int, int]:
        """From ``init`` over ``pool``: (the last set, the trips, the
        refills), one flag read a trip."""
        self.load(pool, row_cap, init)
        if self.graphs is None and capture:
            self.capture(pool, row_cap, init)
        if self.graphs is not None:
            trip, refill = (g.replay for g in self.graphs)
        else:
            trip, refill = self.prog.trip, self.prog.refill
        trips = refills = 0
        while True:
            trip()
            trips += 1
            flag = int(self.prog.flag)
            if flag == REFILL:
                refill()
                refills += 1
            elif flag == DONE:
                break
        if self.graphs is not None:
            write_counts(replayed(replayed(read_counts(), self.deltas[0],
                                           trips), self.deltas[1], refills))
        return (type(self.set)(*(None if x is None else x.clone()
                                 for x in self.set)), trips, refills)


class LoopGraphs:
    """The captured loops of one decode call, keyed by their body's
    arguments and their buffers' shapes and dtypes; ``captures`` and
    ``replays`` count what it did (a streaming loop two captures, and a
    replay each trip and each refill; ``refill_replays`` the refills).
    ``capture=False`` runs each loop's captured code (``_Loop.advance``,
    a streaming loop's trip and refill) eagerly in place of a replay: the
    CPU tests' model of the graph path. ``capture_s``: the host seconds
    of the warm-ups and captures."""

    def __init__(self, capture: bool = True):
        self.capture = capture
        self.loops: Dict = {}
        self.captures = 0
        self.replays = 0
        self.refill_replays = 0
        self.capture_s = 0.0

    def run(self, key, make_body: MakeBody, state: DecodeState,
            row_cap: Optional[torch.Tensor], carry: Carry, t0: int,
            t_end: int, unroll: int, fin: int) -> Tuple[Carry, int]:
        sig = (key, decode_knobs(), unroll, fin, _signature(row_cap),
               tuple(_signature(x) for x in (*state, *carry)))
        loop = self.loops.get(sig)
        if loop is None:
            loop = self.loops[sig] = _Loop(make_body, state, row_cap, carry,
                                           unroll, fin)
        captured = loop.graph is not None
        carry, t, n = loop.run(state, row_cap, carry, t0, t_end, self.capture)
        if loop.graph is not None and not captured:
            self.captures += 1
            self.capture_s += loop.capture_s
        self.replays += n
        return carry, t

    def run_stream(self, key, make_stream: MakeStream, pool: DecodeState,
                   row_cap: Optional[torch.Tensor], init: NamedTuple
                   ) -> Tuple[NamedTuple, int, int]:
        sig = ("stream", key, decode_knobs(), _signature(row_cap),
               tuple(_signature(x) for x in (*pool, *init)))
        loop = self.loops.get(sig)
        if loop is None:
            loop = self.loops[sig] = _StreamLoop(make_stream, pool, row_cap,
                                                 init)
        captured = loop.graphs is not None
        out, trips, refills = loop.run(pool, row_cap, init, self.capture)
        if loop.graphs is not None and not captured:
            self.captures += len(loop.graphs)
            self.capture_s += loop.capture_s
        self.replays += trips + refills
        self.refill_replays += refills
        return out, trips, refills

    def pool_bytes(self) -> int:
        """Device memory the streaming loops' graph pools hold (0 without
        captures)."""
        return _graphs.pool_bytes(lp.mempool for lp in self.loops.values()
                                  if getattr(lp, "mempool", None) is not None)


Dispatch = Union[None, str, LoopGraphs]


def loop_graphs(dispatch: Dispatch, dev: torch.device,
                mesh=None) -> Optional[LoopGraphs]:
    """The loops' runner of one call: ``dispatch`` itself where it is a
    ``LoopGraphs`` (a caller's, shared by its loops), a new one where it
    resolves to "graph" (``resolve_dispatch``), else None: eager."""
    if isinstance(dispatch, LoopGraphs):
        return dispatch
    if resolve_dispatch(dispatch, dev, mesh) == "eager":
        return None
    return LoopGraphs()


def dispatch_stats(graphs: Optional[LoopGraphs]) -> Dict:
    """A decode call's stats of its loops' dispatch."""
    if graphs is None:
        return {"dispatch": "eager", "captures": 0, "replays": 0,
                "capture_s": 0.0}
    return {"dispatch": "graph", "captures": graphs.captures,
            "replays": graphs.replays, "capture_s": graphs.capture_s}


def run_loop(make_body: MakeBody, state: DecodeState,
             row_cap: Optional[torch.Tensor], carry: Carry, t0: int,
             t_end: int, *, unroll: int = 1, fin: int = 5,
             graphs: Optional[LoopGraphs] = None, key=()) -> Tuple[Carry, int]:
    """Run a loop from ``carry`` (its t at ``t0``) while t < t_end and not
    every entry of ``carry[fin]`` is set, ``unroll`` bodies per check:
    eagerly where ``graphs`` is None, else as replays of ``graphs``'s loop
    for ``key`` (the body's arguments). ``make_body(state, row_cap)``
    builds the body over the rows' decode state and step caps. Returns
    (the last carry, its t)."""
    if graphs is not None:
        return graphs.run(key, make_body, state, row_cap, carry, t0, t_end,
                          unroll, fin)
    body = make_body(state, row_cap)
    t = t0
    while t < t_end and not bool(carry[fin].all()):
        for _ in range(unroll):
            carry = body(carry)
        t += unroll
    return carry, t


def run_stream(make_stream: MakeStream, pool: DecodeState,
               row_cap: Optional[torch.Tensor], init: NamedTuple, *,
               graphs: Optional[LoopGraphs] = None,
               key=()) -> Tuple[NamedTuple, int, int]:
    """Run a streaming loop over ``pool`` (and its step caps) from the set
    ``init`` until a trip flags DONE, the refill after each trip that
    flags REFILL: eagerly where ``graphs`` is None, else as replays of
    ``graphs``'s loop for ``key`` (the programs' arguments).
    ``make_stream(pool, row_cap, set)`` builds the two programs over the
    static buffers. Returns (the last set, the trips, the refills)."""
    if graphs is not None:
        return graphs.run_stream(key, make_stream, pool, row_cap, init)
    return _StreamLoop(make_stream, pool, row_cap, init).run(
        pool, row_cap, init, capture=False)
