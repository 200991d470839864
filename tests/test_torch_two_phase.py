"""The fourth slice of the port against the JAX package, on the CPU at the
toy preset, from the same parameters (through the weight bridge): the
two-phase straggler decoder, the readout's shallow slots on the beam loops
(chunk-level deferred rerun, per-step recovery), beam_unroll, and the slice
as a whole through translate_corpus and the Translator at max_len >= 96,
where the two-phase decoder is the default. Tokens, lengths and step
counts exactly; scores to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import preset as jax_preset
from vag_nmt_tpu.data.datasets import make_toy_examples as jax_toy_examples
from vag_nmt_tpu.data.datasets import toy_vocab as jax_toy_vocab
from vag_nmt_tpu.decode import beam as jbeam
from vag_nmt_tpu.decode.serve import Translator as JTranslator
from vag_nmt_tpu.decode.translate import translate_corpus as jax_translate
from vag_nmt_tpu.models import prepare_decode as jax_prepare_decode
from vag_nmt_tpu.models.decoder import decode_tables as jax_decode_tables

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.data.datasets import make_toy_examples, toy_vocab
from vag_nmt_tpu_torch.decode import beam as tbeam
from vag_nmt_tpu_torch.models.decoder import decode_tables
from vag_nmt_tpu_torch.ops import readout_topk as rt

from tests.test_models import make_batch
from tests.test_torch_serve import _params

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

SCORE_ATOL = 1e-5
KNOBS = ("VAG_BLOCK_NGRAM", "VAG_BEAM_PRUNE", "VAG_BEAM_UNROLL",
         "VAG_TWO_PHASE", "VAG_FRT_SLOTS", "VAG_FRT_DEFER", "VAG_FRT_NOCOND",
         "VAG_READOUT_TOPK")
CAPS = [3, 5, 12, 7, 2, 9]


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


def _same(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=SCORE_ATOL, rtol=0)


def _kwargs(setup, case):
    """(JAX kwargs, port kwargs) of a case of tests/test_decode.py."""
    _, jp, _, _, tp, _ = setup
    jkw, tkw = {}, {}
    if case == "tables":
        jkw["tables"] = jax_decode_tables(jp["decoder"])
        tkw["tables"] = decode_tables(tp["decoder"])
    elif case == "eos_top":
        jkw["beam_finish"] = tkw["beam_finish"] = "eos_top"
    elif case == "row_cap":
        jkw["row_cap"] = jnp.asarray(CAPS, jnp.int32)
        tkw["row_cap"] = torch.tensor(CAPS)
    elif case == "block_ngram":
        jkw["block_ngram"] = tkw["block_ngram"] = 2
    return jkw, tkw


@pytest.mark.parametrize("case", ["plain", "tables", "eos_top", "row_cap",
                                  "block_ngram"])
@pytest.mark.parametrize("split_len", [1, 5, 12])
def test_two_phase_matches_jax(setup, split_len, case):
    """beam_search_two_phase against the JAX package's (chunk 2 over six
    sentences): hypotheses, the per-chunk phase-1 trips and the phase-2
    trips; and against the port's single loop, which it must reproduce."""
    jm, jp, jstate, m, tp, tstate = setup
    jkw, tkw = _kwargs(setup, case)
    kw = dict(beam_size=3, max_len=12, chunk=2, split_len=split_len)
    want, w1, w2 = jbeam.beam_search_two_phase(jp, jm, jstate, **kw, **jkw)
    got, s1, s2 = tbeam.beam_search_two_phase(tp, m, tstate, device="cpu",
                                              **kw, **tkw)
    _same(got, want)
    assert s1 == np.asarray(w1).tolist() and s2 == int(w2)
    assert got.steps == sum(s1) + s2
    ref = vt.beam_search(tp, m, tstate, beam_size=3, max_len=12, device="cpu",
                         **tkw)
    assert torch.equal(got.tokens, ref.tokens)
    assert torch.equal(got.scores, ref.scores)
    if split_len < 12:
        assert s2 > 0                       # stragglers resumed


@pytest.mark.parametrize("mode", ["defer", "per_step", "two_phase"])
def test_shallow_slots_beam_matches_jax(setup, mode, monkeypatch):
    """VAG_FRT_SLOTS=1 on the fused step (the JAX kernel in interpret mode,
    the port's plain version under the kernel's lane map, where at V=64 a
    lane holds 4 ids and collisions are frequent): the chunk-level deferred
    rerun, the per-step recovery (VAG_FRT_DEFER=0) and the two-phase
    decoder's per-step recovery all give the JAX package's tokens, and the
    port's recoveries really ran."""
    jm, jp, jstate, m, tp, tstate = setup
    monkeypatch.setenv("VAG_READOUT_TOPK", "fused")
    monkeypatch.setenv("VAG_FRT_SLOTS", "1")
    if mode == "per_step":
        monkeypatch.setenv("VAG_FRT_DEFER", "0")
    kw = dict(beam_size=5, max_len=12)
    rt.readout_topk_rows.recoveries = None
    if mode == "two_phase":
        want, w1, w2 = jbeam.beam_search_two_phase(jp, jm, jstate, chunk=3,
                                                   split_len=4, **kw)
        got, s1, s2 = tbeam.beam_search_two_phase(tp, m, tstate, chunk=3,
                                                  split_len=4, device="cpu",
                                                  **kw)
        assert (s1, s2) == (np.asarray(w1).tolist(), int(w2))
    else:
        want = jbeam.beam_search(jp, jm, jstate, **kw)
        got = vt.beam_search(tp, m, tstate, device="cpu", **kw)
    _same(got, want)
    if mode == "defer":
        assert got.reruns == 1 and rt.readout_topk_rows.recoveries is None
    else:
        assert got.reruns == 0 and int(rt.readout_topk_rows.recoveries[0]) > 0


def test_deferred_rerun_branch_is_exact(setup, monkeypatch):
    """The flag forced on every step (tests/test_decode.py:151): the chunk
    reruns at depth K and returns the per-step path's results, with the
    rerun's steps counted."""
    jm, jp, jstate, m, tp, tstate = setup
    monkeypatch.setenv("VAG_FRT_SLOTS", "3")
    monkeypatch.setenv("VAG_FRT_DEFER", "0")
    kw = dict(beam_size=5, max_len=12)
    ref = vt.beam_search(tp, m, tstate, device="cpu", **kw)
    orig = tbeam.decode_step_topk

    def always_flagged(*a, **k):
        out = orig(*a, **k)
        return out[:3] + (torch.ones((), dtype=torch.bool),) if k.get(
            "defer_exact") else out

    monkeypatch.setattr(tbeam, "decode_step_topk", always_flagged)
    monkeypatch.delenv("VAG_FRT_DEFER")
    got = vt.beam_search(tp, m, tstate, device="cpu", **kw)
    assert got.reruns == 1 and got.steps == 2 * ref.steps
    for a, b in ((got.tokens, ref.tokens), (got.lengths, ref.lengths),
                 (got.scores, ref.scores)):
        assert torch.equal(a, b)
    want = jbeam.beam_search(jp, jm, jstate, **kw)
    _same(got, want)


@pytest.mark.parametrize("unroll", [2, 3, 8])
def test_beam_unroll_invariance(setup, unroll, monkeypatch):
    """U decoder steps per host check: the hypotheses are the JAX package's
    at U=1; only the trips run past the last finish change. The variable
    VAG_BEAM_UNROLL drives the default."""
    jm, jp, jstate, m, tp, tstate = setup
    kw = dict(beam_size=3, max_len=12)
    want = jbeam.beam_search(jp, jm, jstate, unroll=1, **kw)
    ref = vt.beam_search(tp, m, tstate, device="cpu", unroll=1, **kw)
    got = vt.beam_search(tp, m, tstate, device="cpu", unroll=unroll, **kw)
    _same(got, want)
    assert got.steps % unroll == 0 and ref.steps <= got.steps < ref.steps + unroll
    monkeypatch.setenv("VAG_BEAM_UNROLL", str(unroll))
    assert vt.beam_search(tp, m, tstate, device="cpu", **kw).steps == got.steps


def _long_cfgs():
    upd = dict(decode=dict(max_len=96))
    return jax_preset("toy").replace(**upd), vt.preset("toy").replace(**upd)


def test_translate_corpus_two_phase_matches_jax():
    """The slice as a whole: translate_corpus at max_len 96, where
    two_phase="auto" takes the two-phase decoder in both packages; three
    chunks of four, filler rows."""
    jcfg, cfg = _long_cfgs()
    jp = _params(jcfg.model)
    params = vt.params_from_numpy(jax.device_get(jp), cfg.model, device="cpu")
    jexs, exs = jax_toy_examples(11, seed=3), make_toy_examples(11, seed=3)
    want, wst = jax_translate(jp, jcfg, jexs, jax_toy_vocab(), batch_size=4)
    got, st = vt.translate_corpus(params, cfg, exs, toy_vocab(), batch_size=4,
                                  device="cpu")
    assert got == want and any(got)
    assert st["two_phase"] and wst["two_phase"]
    assert st["phase2_steps"] == wst["phase2_steps"]
    assert st["chunk_steps"] == wst["chunk_steps"]
    assert st["beam_loop_steps"] == wst["beam_loop_steps"]
    assert sum(st["phase2_steps"]) > 0


def test_translator_bulk_takes_two_phase():
    """Translator.translate(bulk=True) at max_len 96 decodes through
    translate_corpus's two-phase route; its lines equal the JAX
    Translator's (whose bulk request runs the streaming pool, ROADMAP R2:
    the hypotheses are the same either way)."""
    jcfg, cfg = _long_cfgs()
    jp = _params(jcfg.model)
    params = vt.params_from_numpy(jax.device_get(jp), cfg.model, device="cpu")
    vocab = toy_vocab()
    lines = [" ".join(vocab.itos[t] for t in ex.src)
             for ex in make_toy_examples(10, seed=7)]
    jtr = JTranslator(jcfg, jp, None, jax_toy_vocab(), jax_toy_vocab(),
                      lower=False)
    ttr = vt.Translator(cfg, params, None, vocab, vocab, lower=False,
                        device="cpu")
    got = ttr.translate(lines, batch_size=4, bulk=True)
    assert got == jtr.translate(lines, batch_size=4, bulk=True)
    assert len(ttr.last_stats) == 1 and ttr.last_stats[0]["two_phase"]
