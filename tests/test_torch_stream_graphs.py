"""The streaming-refill loop as device programs (``decode/beam.py``'s trip
and masked refill, ``decode/graphs.py``'s ``_StreamLoop``) on the CPU at
the toy preset, from the JAX package's parameters through the weight
bridge.

- The graph path's code (``LoopGraphs(capture=False)``: the trip and the
  refill over the loop's static buffers, run eagerly in place of each
  replay) against the JAX package's ``beam_search_streaming`` on the same
  pool: tokens, lengths, trips and refills exactly, scores to 1e-6; and
  against the port's eager dispatch, bit for bit. Cases: no caps, row
  caps, ``eos_top``, an n-gram ban, prune off, refill thresholds 1 and
  the default, N not a multiple of the slots, N below the slots, and a
  pool that runs out during a refill (sentinel slots).
- A guard that a trip and a refill make no host read or host copy (a
  capture would fail on one, or bake in its value).
- The capture wiring on stand-ins for the CUDA stream and graph: two
  graphs on one stream and one memory pool, the refill replayed only on
  the trips that flag it, each pool loaded into the same buffers, the
  counters carried through the trip replays and none by the refill.

CUDA graphs themselves run only on the card: ``chip_smoke.py`` phase 27
holds graph against eager there."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import preset as jax_preset
from vag_nmt_tpu.decode import beam as jbeam
from vag_nmt_tpu.models import prepare_decode as jax_prepare_decode
from vag_nmt_tpu.models.decoder import decode_tables as jax_decode_tables

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.decode import beam as tbeam
from vag_nmt_tpu_torch.decode import graphs
from vag_nmt_tpu_torch.models.decoder import decode_tables
from vag_nmt_tpu_torch.models.model import decode_opts
from vag_nmt_tpu_torch.ops import topk

from tests.test_models import make_batch
from tests.test_torch_graph_decode import (HOST_OPS, KNOBS, _FakeStream,
                                           _NullContext, _Ops)
from tests.test_torch_serve import _params

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

SCORE_ATOL = 1e-6        # as tests/test_torch_serve.py's streaming test
CAPS = [3, 5, 12, 7, 2, 9, 4, 1, 12, 6]
N_POOL = 10


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_preset("toy")
    jp = _params(jcfg.model)
    m = vt.preset("toy").model
    tp = vt.params_from_numpy(jax.device_get(jp), m, device="cpu")
    batch = make_batch(jcfg, B=N_POOL, T=8, seed=3)
    jstate = jax_prepare_decode(jp, jcfg.model, batch)
    tstate = vt.prepare_decode(tp, m, {k: np.array(v) for k, v in batch.items()},
                               device="cpu")
    return jcfg.model, jp, jstate, m, tp, tstate


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in KNOBS + ("VAG_STREAM_DECODE",):
        monkeypatch.delenv(k, raising=False)


# (case: keyword arguments of both packages); slots 4 unless set, so N =
# 10 is no multiple of it
CASES = {
    "no_caps": {},
    "row_cap": {"row_cap": CAPS, "refill_threshold": 1},
    "eos_top": {"beam_finish": "eos_top"},
    "block_ngram": {"block_ngram": 2},
    "prune_off": {"prune": False},
    "threshold_1": {"refill_threshold": 1},
    "threshold_default_slots_3": {"slots": 3},
    "tables_caps_ngram": {"tables": True, "row_cap": CAPS, "block_ngram": 2},
    "n_below_slots": {"slots": 16},
    # R = W = 4: each refill takes 4 pool rows, and the second (rows 8, 9
    # and two past the pool) leaves two sentinel slots
    "pool_runs_out": {"refill_threshold": 4},
}


def _kwargs(setup, case):
    _, jp, _, _, tp, _ = setup
    kw = dict(beam_size=3, max_len=12, slots=4)
    kw.update(CASES[case])
    jkw, tkw = dict(kw), dict(kw)
    if "row_cap" in kw:
        jkw["row_cap"] = jnp.asarray(kw["row_cap"], jnp.int32)
        tkw["row_cap"] = torch.tensor(kw["row_cap"])
    if kw.get("tables"):
        jkw["tables"] = jax_decode_tables(jp["decoder"])
        tkw["tables"] = decode_tables(tp["decoder"])
    return jkw, tkw


def _bit_equal(a, b):
    for x, y in ((a.tokens, b.tokens), (a.lengths, b.lengths),
                 (a.scores, b.scores)):
        assert torch.equal(x, y)
    assert a.steps == b.steps


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_graph_path_matches_jax(setup, case):
    """The graph path's trip and refill (run in place of the replays)
    against the JAX package's streaming loop and the port's eager one."""
    jm, jp, jstate, m, tp, tstate = setup
    jkw, tkw = _kwargs(setup, case)
    want, wsteps, wrefills = jbeam.beam_search_streaming(jp, jm, jstate,
                                                         **jkw)
    g = graphs.LoopGraphs(capture=False)
    got, steps, refills = vt.beam_search_streaming(tp, m, tstate,
                                                   device="cpu", dispatch=g,
                                                   **tkw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=SCORE_ATOL, rtol=0)
    assert (steps, refills) == (int(wsteps), int(wrefills))
    assert got.steps == steps
    assert g.replays == steps + refills and g.refill_replays == refills
    assert len(g.loops) == 1 and g.captures == 0
    eager, e_steps, e_refills = vt.beam_search_streaming(
        tp, m, tstate, device="cpu", dispatch="eager", **tkw)
    _bit_equal(got, eager)
    assert (e_steps, e_refills) == (steps, refills)
    if case == "n_below_slots":
        assert refills == 0
    elif case == "pool_runs_out":
        assert refills == 2         # 4 + 4 + 4 > N_POOL: two sentinels
    else:
        assert refills >= 2


def _stream_loop(setup, kw, row_cap):
    """A _StreamLoop over the setup's pool, loaded, beam 5, slots 4."""
    _, _, _, m, tp, tstate = setup
    make = tbeam._make_stream(tp, m, kw.get("tables"), 12, 1,
                              eos_top=kw.get("eos_top", False),
                              prune_alpha=1.0,
                              block_ngram=kw.get("block_ngram", 0),
                              impl="auto", opts=decode_opts(torch.float32))
    init = tbeam._stream_init(tstate, row_cap, 4, 5, 12)
    loop = graphs._StreamLoop(make, tstate, row_cap, init)
    loop.load(tstate, row_cap, init)
    return loop


# (label, environment, keyword arguments) of the guarded programs
GUARD_CASES = {
    "default": ({}, {}),
    "caps_ngram_eos_top_tables": ({}, dict(row_cap=True, block_ngram=2,
                                           eos_top=True, tables=True)),
    "per_step_recovery": ({"VAG_FRT_SLOTS": "1", "VAG_FRT_DEFER": "0",
                           "VAG_READOUT_TOPK": "fused"}, {}),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_trip_and_refill_make_no_host_read_or_copy(setup, case,
                                                   monkeypatch):
    """Trips until one flags a refill (so the refill moves finished slots
    and pulls pool rows), then that trip and the refill again under the
    guard: none of HOST_OPS."""
    _, _, _, _, tp, _ = setup
    env, kw = GUARD_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if kw.get("tables"):
        kw["tables"] = decode_tables(tp["decoder"])
    loop = _stream_loop(setup, kw, torch.tensor(CAPS) if kw.get("row_cap")
                        else None)
    st, prog = loop.set, loop.prog
    snap = None
    for _ in range(12):
        snap = [None if x is None else x.clone() for x in st]
        prog.trip()
        if int(prog.flag) == graphs.REFILL:
            break
    assert int(prog.flag) == graphs.REFILL
    for dst, src in zip(st, snap):      # back to before that trip
        if dst is not None:
            dst.copy_(src)
    with _Ops() as ops:
        prog.trip()
        prog.refill()
    assert not ops.names & set(HOST_OPS), ops.names & set(HOST_OPS)
    assert int(st.refills) == 1 and int(st.nxt) > 4
    assert bool((st.t == 0).any()) and not bool(st.finished.all(1).all())


def test_stream_graph_dispatch_on_the_cpu_raises(setup):
    _, _, _, m, tp, tstate = setup
    with pytest.raises(ValueError, match="CUDA device"):
        vt.beam_search_streaming(tp, m, tstate, beam_size=3, max_len=6,
                                 slots=4, device="cpu", dispatch="graph")


# ---- capture wiring on stand-ins ------------------------------------------

class _Set(NamedTuple):
    scores: torch.Tensor    # (rows,): the counters' size
    n: torch.Tensor         # () trips run on the "device"
    flag: torch.Tensor      # ()
    log: torch.Tensor       # (trips,) 1 where a refill ran after trip i
    seen: torch.Tensor      # () the pool's first value, read by the trip


class _Graph:
    """A CUDAGraph stand-in: while it captures, a program's host part runs
    (the wrappers' counters move, as in a real capture) and its device
    part is recorded; a replay runs the recorded device parts."""
    capturing = None

    def capture_begin(self, pool=None):
        self.pool, self.work = pool, []
        self.bound = topk._COUNTERS.get((torch.device("cpu"), 4242))
        _Graph.capturing = self

    def capture_end(self):
        _Graph.capturing = None

    def replay(self):
        for w in self.work:
            w()


def _device(fn):
    if _Graph.capturing is not None:
        _Graph.capturing.work.append(fn)
    else:
        fn()


FLAGS = [0, 1, 0, 0, 1, 1, 0, 2]     # the trips' verdicts, in order


def _fake_make_stream(pool, row_cap, st):
    rt = graphs._readout.readout_topk_rows
    script = torch.tensor(FLAGS)

    def trip():
        rt.launches += 1             # the host part: one kernel launch
        rt.grids += 2

        def dev():
            st.seen.copy_(pool.s0[0, 0])
            st.flag.copy_(script[st.n])
            st.n.add_(1)
        _device(dev)

    def refill():
        _device(lambda: st.log.index_fill_(0, (st.n - 1).view(1), 1))

    return graphs.Stream(trip=trip, refill=refill, flag=st.flag)


def test_stream_capture_wiring_on_fakes(monkeypatch):
    """_StreamLoop.capture and run through LoopGraphs on stand-ins: two
    graphs (trip, refill) on one stream and one pool, the warm-ups count
    nothing and their writes are loaded over, the refill replayed after
    exactly the trips that flag it, the trip's counter deltas added once a
    replay and the refill's none; a second pool of the same shape is
    loaded into the same loop, with no new capture."""
    handle = (7, 7)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _NullContext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: handle)
    init = _Set(scores=torch.zeros(6), n=torch.zeros((), dtype=torch.long),
                flag=torch.zeros((), dtype=torch.long),
                log=torch.zeros(len(FLAGS), dtype=torch.long),
                seen=torch.zeros(()))
    pools = [vt.DecodeState(*(torch.full((3, 4), float(v)) for _ in range(4)))
             for v in (5, 9)]
    saved = graphs.read_counts()
    try:
        g = graphs.LoopGraphs()
        outs = [g.run_stream("k", _fake_make_stream, p, None, init)
                for p in pools]
        counts = graphs.read_counts()
    finally:
        graphs.write_counts(saved)
    loop = next(iter(g.loops.values()))
    trip_g, refill_g = loop.graphs
    want_log = [int(FLAGS[i] == graphs.REFILL) for i in range(len(FLAGS))]
    for (st, trips, refills), p in zip(outs, pools):
        assert (trips, refills) == (len(FLAGS), FLAGS.count(graphs.REFILL))
        assert st.log.tolist() == want_log and int(st.n) == len(FLAGS)
        assert float(st.seen) == float(p.s0[0, 0])
    assert len(g.loops) == 1 and g.captures == 2
    assert g.replays == 2 * (len(FLAGS) + 3) and g.refill_replays == 6
    assert trip_g.pool is refill_g.pool is loop.mempool is handle
    assert trip_g.bound is refill_g.bound is loop.counters is not None
    assert loop.counters.numel() >= 6
    assert (torch.device("cpu"), 4242) not in topk._COUNTERS
    assert loop.deltas == ({("readout_topk_rows", "launches"): 1,
                            ("readout_topk_rows", "grids"): 2}, {})
    assert graphs.counter_deltas(saved, counts) == {
        ("readout_topk_rows", "launches"): 2 * len(FLAGS),
        ("readout_topk_rows", "grids"): 4 * len(FLAGS)}
    assert g.capture_s >= 0
