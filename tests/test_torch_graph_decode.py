"""The decode loops' dispatch (``vag_nmt_tpu_torch/decode/graphs.py``) on
the CPU at the toy preset, from the JAX package's parameters through the
weight bridge.

- The device-t loop body (t a 0-dim tensor on the device, the token
  written by a one-hot mask, no host copy) against the JAX package's
  ``beam_search``, ``beam_search_two_phase`` and ``greedy_decode``: tokens,
  lengths and trip counts exactly, scores to 1e-5, with pruning on, an
  n-gram ban, ``eos_top``, row caps and U = 1 and 3.
- The graph path's captured code (``_Loop.advance``: U bodies from static
  buffers back into them, and the exit flag) run eagerly in place of each
  replay (``LoopGraphs(capture=False)``), against the eager loop, bit for
  bit, with its replay count.
- A guard that one body call makes no host read or host copy: no
  ``aten._local_scalar_dense``, ``aten.lift_fresh`` or ``aten.nonzero``
  (a capture would fail on them, or bake in their value).
- The dispatch rule, the arrival counters' keying and the replay
  accounting, through their host functions.

CUDA graphs themselves run only on the card: ``chip_smoke.py`` phase 25
holds graph against eager there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vag_nmt_tpu.core.config import preset as jax_preset
from vag_nmt_tpu.decode import beam as jbeam
from vag_nmt_tpu.decode.greedy import greedy_decode as jax_greedy
from vag_nmt_tpu.models import prepare_decode as jax_prepare_decode
from vag_nmt_tpu.models.decoder import decode_tables as jax_decode_tables

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.data.datasets import make_toy_examples, toy_vocab
from vag_nmt_tpu_torch.decode import beam as tbeam
from vag_nmt_tpu_torch.decode import graphs
from vag_nmt_tpu_torch.decode import greedy as tgreedy
from vag_nmt_tpu_torch.models.decoder import decode_tables
from vag_nmt_tpu_torch.models.model import decode_opts
from vag_nmt_tpu_torch.ops import topk
from vag_nmt_tpu_torch.parallel.sharding import Mesh

from tests.test_models import make_batch
from tests.test_torch_serve import _params

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

SCORE_ATOL = 1e-5
KNOBS = ("VAG_BLOCK_NGRAM", "VAG_BEAM_PRUNE", "VAG_BEAM_UNROLL",
         "VAG_TWO_PHASE", "VAG_FRT_SLOTS", "VAG_FRT_DEFER", "VAG_FRT_NOCOND",
         "VAG_READOUT_TOPK", "VAG_DEC_STEP")
CAPS = [3, 5, 12, 7, 2, 9]
# a host read, a tensor made from host data, a data-dependent shape; and
# an index by a bool mask (nonzero inside the op on the card)
HOST_OPS = ("aten._local_scalar_dense", "aten.lift_fresh", "aten.nonzero",
            "index by a bool mask")


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_preset("toy")
    jp = _params(jcfg.model)
    m = vt.preset("toy").model
    tp = vt.params_from_numpy(jax.device_get(jp), m, device="cpu")
    batch = make_batch(jcfg, B=6, T=8, seed=3)
    jstate = jax_prepare_decode(jp, jcfg.model, batch)
    tstate = vt.prepare_decode(tp, m, {k: np.array(v) for k, v in batch.items()},
                               device="cpu")
    return jcfg.model, jp, jstate, m, tp, tstate


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


# (case: JAX and port keyword arguments); prune is on in every case
CASES = {
    "prune": {},
    "block_ngram": {"block_ngram": 2},
    "eos_top": {"beam_finish": "eos_top"},
    "caps_ngram_tables": {"row_cap": CAPS, "block_ngram": 2, "tables": True},
}


def _kwargs(setup, case):
    _, jp, _, _, tp, _ = setup
    kw = dict(CASES[case])
    jkw, tkw = dict(prune=True), dict(prune=True)
    if "row_cap" in kw:
        jkw["row_cap"] = jnp.asarray(kw["row_cap"], jnp.int32)
        tkw["row_cap"] = torch.tensor(kw.pop("row_cap"))
    if kw.pop("tables", False):
        jkw["tables"] = jax_decode_tables(jp["decoder"])
        tkw["tables"] = decode_tables(tp["decoder"])
    jkw.update(kw)
    tkw.update(kw)
    return jkw, tkw


def _same_as_jax(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=SCORE_ATOL, rtol=0)


def _bit_equal(a, b):
    for x, y in ((a.tokens, b.tokens), (a.lengths, b.lengths),
                 (a.scores, b.scores)):
        assert torch.equal(x, y)
    assert a.steps == b.steps and a.reruns == b.reruns


@pytest.mark.parametrize("unroll", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_loop_matches_jax(setup, case, unroll):
    """beam_search's loop, eager and as the graph path's in-place code,
    against the JAX package's: the hypotheses at any U, the trips a
    multiple of U, one replay a U steps."""
    jm, jp, jstate, m, tp, tstate = setup
    jkw, tkw = _kwargs(setup, case)
    kw = dict(beam_size=3, max_len=12, unroll=unroll)
    want = jbeam.beam_search(jp, jm, jstate, **kw, **jkw)
    eager = vt.beam_search(tp, m, tstate, device="cpu", dispatch="eager",
                           **kw, **tkw)
    _same_as_jax(eager, want)
    g = graphs.LoopGraphs(capture=False)
    inplace = vt.beam_search(tp, m, tstate, device="cpu", dispatch=g, **kw,
                             **tkw)
    _bit_equal(inplace, eager)
    assert eager.steps % unroll == 0 and g.replays == eager.steps // unroll
    assert len(g.loops) == 1 and g.captures == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_phase_loops_match_jax(setup, case):
    """beam_search_two_phase's phase 1 and rungs (one loop of chunk rows
    whatever t_start, each resume copying it into the device t) against
    the JAX package's, its trips exactly; the in-place code as eager."""
    jm, jp, jstate, m, tp, tstate = setup
    jkw, tkw = _kwargs(setup, case)
    kw = dict(beam_size=3, max_len=12, chunk=2, split_len=3)
    want, w1, w2 = jbeam.beam_search_two_phase(jp, jm, jstate, **kw, **jkw)
    eager, s1, s2 = tbeam.beam_search_two_phase(tp, m, tstate, device="cpu",
                                                dispatch="eager", **kw, **tkw)
    _same_as_jax(eager, want)
    assert s1 == np.asarray(w1).tolist() and s2 == int(w2) and s2 > 0
    g = graphs.LoopGraphs(capture=False)
    inplace, g1, g2 = tbeam.beam_search_two_phase(tp, m, tstate, device="cpu",
                                                  dispatch=g, **kw, **tkw)
    _bit_equal(inplace, eager)
    assert (g1, g2) == (s1, s2) and g.replays == sum(s1) + s2
    assert len(g.loops) == 1


def test_deferred_rerun_as_a_second_loop(setup, monkeypatch):
    """The deferred mode (slots 1 on the fused step): the chunk's flag
    fires and the exact rerun is a loop of its own; hypotheses the JAX
    package's, the in-place code bit for bit as eager."""
    jm, jp, jstate, m, tp, tstate = setup
    monkeypatch.setenv("VAG_READOUT_TOPK", "fused")
    monkeypatch.setenv("VAG_FRT_SLOTS", "1")
    kw = dict(beam_size=5, max_len=12)
    want = jbeam.beam_search(jp, jm, jstate, **kw)
    eager = vt.beam_search(tp, m, tstate, device="cpu", dispatch="eager", **kw)
    _same_as_jax(eager, want)
    assert eager.reruns == 1
    g = graphs.LoopGraphs(capture=False)
    _bit_equal(vt.beam_search(tp, m, tstate, device="cpu", dispatch=g, **kw),
               eager)
    assert len(g.loops) == 2 and g.replays == eager.steps


@pytest.mark.parametrize("case", ["plain", "caps_ngram_tables"])
def test_greedy_loop_matches_jax(setup, case):
    """greedy_decode's loop over (t, tok, s, tokens, finished, lengths),
    eager and in place, against the JAX package's."""
    jm, jp, jstate, m, tp, tstate = setup
    jkw, tkw = {}, {}
    if case != "plain":
        jkw = dict(row_cap=jnp.asarray(CAPS, jnp.int32), block_ngram=2,
                   tables=jax_decode_tables(jp["decoder"]))
        tkw = dict(row_cap=torch.tensor(CAPS), block_ngram=2,
                   tables=decode_tables(tp["decoder"]))
    toks, lens = jax_greedy(jp, jm, jstate, 12, **jkw)
    eager = vt.greedy_decode(tp, m, tstate, 12, dispatch="eager", **tkw)
    np.testing.assert_array_equal(eager.tokens.numpy(), np.asarray(toks))
    np.testing.assert_array_equal(eager.lengths.numpy(), np.asarray(lens))
    g = graphs.LoopGraphs(capture=False)
    inplace = vt.greedy_decode(tp, m, tstate, 12, dispatch=g, **tkw)
    assert torch.equal(inplace.tokens, eager.tokens)
    assert torch.equal(inplace.lengths, eager.lengths)
    assert inplace.steps == eager.steps == g.replays and 1 < eager.steps


class _Ops(TorchDispatchMode):
    """Records the name of every aten operation run under it."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.names.add(name)
        if name in ("aten.index", "aten.index_put") and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            self.names.add("index by a bool mask")
        return func(*args, **(kwargs or {}))


def test_guard_sees_host_reads_and_copies():
    """The guard is not vacuous: a host read, a host-made tensor, a
    nonzero and a bool-mask index each show."""
    x = torch.arange(4)
    with _Ops() as ops:
        bool(x.sum())
        torch.tensor([1, 2])
        x.nonzero()
        x[x > 1]
    assert set(HOST_OPS) <= ops.names


# (label, environment, body arguments) of the guarded beam bodies
BODY_CASES = {
    "default": ({}, {}),
    "prune_ngram_caps_eos_top": ({}, dict(row_cap=True, block_ngram=2,
                                          eos_top=True, tables=True)),
    "defer_slots": ({"VAG_FRT_SLOTS": "1", "VAG_READOUT_TOPK": "fused"},
                    dict(mode="defer")),
    "per_step_recovery": ({"VAG_FRT_SLOTS": "1", "VAG_FRT_DEFER": "0",
                           "VAG_READOUT_TOPK": "fused"}, {}),
    "unfused": ({"VAG_READOUT_TOPK": "unfused"}, dict(block_ngram=2)),
}


@pytest.mark.parametrize("case", sorted(BODY_CASES))
def test_beam_body_makes_no_host_read_or_copy(setup, case, monkeypatch):
    """Two steps of the beam body (the second past some finished rows)
    run none of HOST_OPS."""
    jm, jp, jstate, m, tp, tstate = setup
    env, kw = BODY_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    K, L = 5, 12
    mode = kw.get("mode", "plain")
    body = tbeam._make_body_1(
        tp, m, tstate, decode_tables(tp["decoder"]) if kw.get("tables")
        else None, mode, L, eos_top=kw.get("eos_top", False),
        row_cap=torch.tensor(CAPS) if kw.get("row_cap") else None,
        prune_alpha=1.0, block_ngram=kw.get("block_ngram", 0),
        opts=decode_opts(torch.float32))
    carry = tbeam._beam_init(tstate, K, L)
    if mode == "defer":
        carry = carry + (torch.zeros((), dtype=torch.bool),)
    carry = body(carry)
    with _Ops() as ops:
        out = body(carry)
    assert not ops.names & set(HOST_OPS), ops.names & set(HOST_OPS)
    assert int(out[0]) == 2 and out[4].shape == (6, K, L)


def test_greedy_body_makes_no_host_read_or_copy(setup):
    jm, jp, jstate, m, tp, tstate = setup
    body = tgreedy._make_greedy_body(tp, m, tstate, decode_tables(tp["decoder"]),
                                     torch.tensor(CAPS), 2,
                                     decode_opts(torch.float32))
    B = 6
    carry = (tbeam._device_t(0, "cpu"), torch.full((B,), 2),
             tstate.s0[:, None, :], torch.zeros((B, 12), dtype=torch.long),
             torch.zeros((B,), dtype=torch.bool),
             torch.zeros((B,), dtype=torch.long))
    carry = body(carry)
    with _Ops() as ops:
        out = body(carry)
    assert not ops.names & set(HOST_OPS)
    assert int(out[0]) == 2


def _mesh(n_data, n_model):
    return Mesh(n_data=n_data, n_model=n_model, rank=0, data_index=0,
                model_index=0, backend="gloo" if n_data * n_model > 1
                else "none")


def test_dispatch_rule():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert graphs.resolve_dispatch(None, cuda) == "graph"
    assert graphs.resolve_dispatch(None, cuda, _mesh(1, 1)) == "graph"
    assert graphs.resolve_dispatch(None, cpu) == "eager"
    for mesh in (_mesh(2, 1), _mesh(1, 2), _mesh(2, 2)):
        assert graphs.resolve_dispatch(None, cuda, mesh) == "eager"
        assert graphs.resolve_dispatch("eager", cuda, mesh) == "eager"
        with pytest.raises(ValueError, match="several ranks"):
            graphs.resolve_dispatch("graph", cuda, mesh)
    assert graphs.resolve_dispatch("eager", cpu) == "eager"
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.resolve_dispatch("graph", cpu)
    with pytest.raises(ValueError, match="unknown dispatch"):
        graphs.resolve_dispatch("jit", cuda)
    assert graphs.loop_graphs(None, cpu) is None
    g = graphs.LoopGraphs()
    assert graphs.loop_graphs(g, cpu) is g
    assert graphs.dispatch_stats(None)["dispatch"] == "eager"


def test_graph_dispatch_on_the_cpu_raises(setup):
    jm, jp, jstate, m, tp, tstate = setup
    with pytest.raises(ValueError, match="CUDA device"):
        vt.beam_search(tp, m, tstate, beam_size=3, max_len=6, device="cpu",
                       dispatch="graph")
    with pytest.raises(ValueError, match="CUDA device"):
        tbeam.beam_search_two_phase(tp, m, tstate, beam_size=3, max_len=6,
                                    chunk=2, split_len=2, device="cpu",
                                    dispatch="graph")
    with pytest.raises(ValueError, match="CUDA device"):
        vt.greedy_decode(tp, m, tstate, 6, dispatch="graph")


@pytest.mark.parametrize("mode", ["chunked", "two_phase", "greedy",
                                  "bucketed", "streaming"])
def test_translate_corpus_dispatch(mode, monkeypatch):
    """translate_corpus on the CPU: eager by default and under a mesh
    (here 1 x 1), the stats say so; "graph" raises; a caller's LoopGraphs
    runs the graph path's code (streaming: each super-chunk's pool loaded
    into its loop, the refills replayed as flagged)."""
    cfg = vt.preset("toy").replace(decode=dict(max_len=10))
    m = cfg.model
    tp = vt.params_from_numpy(jax.device_get(_params(jax_preset("toy").model)),
                              m, device="cpu")
    exs = make_toy_examples(20, seed=4)
    vocab = toy_vocab()
    kw = dict(batch_size=8, device="cpu")
    if mode == "greedy":
        kw["beam_size"] = 1
    if mode == "bucketed":
        kw["fused"] = False
    if mode == "two_phase":
        monkeypatch.setenv("VAG_TWO_PHASE", "on")
    if mode == "streaming":
        monkeypatch.setenv("VAG_STREAM_DECODE", "on")
    hyps, st = vt.translate_corpus(tp, cfg, exs, vocab, **kw)
    assert (st["dispatch"], st["captures"], st["replays"]) == ("eager", 0, 0)
    if mode != "bucketed":
        _, st1 = vt.translate_corpus(tp, cfg, exs, vocab, mesh=_mesh(1, 1),
                                     **kw)
        assert st1["dispatch"] == "eager"
    with pytest.raises(ValueError, match="graph"):
        vt.translate_corpus(tp, cfg, exs, vocab, dispatch="graph", **kw)
    g = graphs.LoopGraphs(capture=False)
    hyps_g, st_g = vt.translate_corpus(tp, cfg, exs, vocab, dispatch=g, **kw)
    assert hyps_g == hyps and st_g["beam_loop_steps"] == st["beam_loop_steps"]
    assert st_g["dispatch"] == "graph" and st_g["replays"] == g.replays > 0
    if mode == "streaming":
        assert st["streaming"] and st_g["refills"] == st["refills"]
        assert g.refill_replays == sum(st["refills"])
        assert g.replays == st["beam_loop_steps"] + g.refill_replays


def test_arrival_counters_one_buffer_per_key():
    table = {}
    a = topk.counters_for(table, ("dev", 1), 10, torch.zeros)
    assert a.numel() == topk.COUNTER_MIN
    assert topk.counters_for(table, ("dev", 1), 500, torch.zeros) is a
    b = topk.counters_for(table, ("dev", 2), 10, torch.zeros)
    assert b is not a and b.data_ptr() != a.data_ptr()
    big = topk.counters_for(table, ("dev", 1), 5000, torch.zeros)
    assert big.numel() == 5000 and table[("dev", 1)] is big
    assert table[("dev", 2)] is b


def test_a_graphs_counters_are_its_own():
    """stream_counters binds a fresh buffer to the capture's stream for the
    block and gives the stream's earlier buffer back after it."""
    cpu = torch.device("cpu")
    eager = topk.counters_for(topk._COUNTERS, (cpu, 77), 10, topk._zeros(cpu))
    try:
        with topk.stream_counters(cpu, 77, 10) as mine:
            assert topk._COUNTERS[(cpu, 77)] is mine and mine is not eager
            with topk.stream_counters(cpu, 78, 3000) as other:
                assert other is not mine and other.numel() == 3000
            assert (cpu, 78) not in topk._COUNTERS
        assert topk._COUNTERS[(cpu, 77)] is eager
    finally:
        topk._COUNTERS.pop((cpu, 77), None)


def test_replay_accounting():
    before = {("readout_topk_rows", "launches"): 4,
              ("readout_topk_rows", "grids"): 4, ("dec_step", "grids"): 10}
    after = {("readout_topk_rows", "launches"): 7,
             ("readout_topk_rows", "grids"): 7, ("dec_step", "grids"): 25}
    d = graphs.counter_deltas(before, after)
    assert d == {("readout_topk_rows", "launches"): 3,
                 ("readout_topk_rows", "grids"): 3, ("dec_step", "grids"): 15}
    assert graphs.counter_deltas(after, after) == {}
    assert graphs.replayed(before, d, 0) == before
    assert graphs.replayed(before, d, 4) == {
        ("readout_topk_rows", "launches"): 16,
        ("readout_topk_rows", "grids"): 16, ("dec_step", "grids"): 70}


def test_counts_read_and_written_through_the_wrappers():
    saved = graphs.read_counts()
    try:
        assert ("readout_topk_rows", "bf16_launches") in saved
        assert ("dec_step", "beam_groups") in saved
        assert ("legacy_topk_rows", "passes") in saved
        d = {("beam_topk", "launches"): 2, ("dec_step", "grids"): 5}
        graphs.write_counts(graphs.replayed(saved, d, 3))
        assert topk.beam_topk.launches == saved[("beam_topk", "launches")] + 6
        assert graphs.counter_deltas(saved, graphs.read_counts()) == {
            ("beam_topk", "launches"): 6, ("dec_step", "grids"): 15}
    finally:
        graphs.write_counts(saved)
    assert graphs.read_counts() == saved


class _FakeStream:
    cuda_stream = 4242

    def wait_stream(self, other):
        pass


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _FakeGraph:
    """A CUDAGraph stand-in: capture runs the code once (a real capture
    runs nothing), replay runs nothing."""
    replays = 0

    def capture_begin(self):
        self.bound = topk._COUNTERS.get((torch.device("cpu"), 4242))

    def capture_end(self):
        pass

    def replay(self):
        _FakeGraph.replays += 1


def test_capture_wiring_on_fakes(monkeypatch):
    """_Loop.capture and run on stand-ins for the CUDA stream and graph,
    over the deferred mode's carry (a 0-dim flag last): the warm-up counts
    nothing, the capture's counter deltas are kept and added once a
    replay, the capture stream's counters are bound during the capture
    and unbound after it, and the graph keeps them."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _NullContext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    rt = graphs._readout.readout_topk_rows

    def make_body(state, row_cap):
        def body(c):
            rt.launches += 1
            rt.grids += 2
            return (c[0] + 1,) + c[1:]
        return body

    B = 3
    carry = (tbeam._device_t(0, "cpu"), torch.zeros((B, 2)),
             torch.zeros((B, 2), dtype=torch.bool), torch.zeros((), dtype=torch.bool))
    state = vt.DecodeState(*(torch.zeros((B, 4)) for _ in range(4)))
    saved = graphs.read_counts()
    try:
        g = graphs.LoopGraphs()
        out, t = g.run("k", make_body, state, None, carry, 0, 7, 1, 2)
        counts = graphs.read_counts()
    finally:
        graphs.write_counts(saved)
    loop = next(iter(g.loops.values()))
    assert (g.captures, g.replays, t) == (1, 7, 7)
    assert loop.deltas == {("readout_topk_rows", "launches"): 1,
                           ("readout_topk_rows", "grids"): 2}
    assert graphs.counter_deltas(saved, counts) == {
        ("readout_topk_rows", "launches"): 7,
        ("readout_topk_rows", "grids"): 14}
    assert loop.graph.bound is loop.counters is not None
    assert loop.counters.numel() >= B
    assert (torch.device("cpu"), 4242) not in topk._COUNTERS
    assert out[3].dim() == 0 and g.capture_s >= 0

