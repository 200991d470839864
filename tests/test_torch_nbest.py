"""n-best output of ``translate_corpus`` against the JAX package on the CPU,
at the toy preset from the same parameters (through the weight bridge):
on the chunked path, the streaming-refill pool and the two-phase decoder,
each example's up to min(N, beam) (text, score) pairs, best first, texts
exactly and scores to 1e-5; and the raises at beam 1 and on the bucketed
(``fused=False``) path."""

import jax
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import preset as jax_preset
from vag_nmt_tpu.data.datasets import make_toy_examples as jax_toy_examples
from vag_nmt_tpu.data.datasets import toy_vocab as jax_toy_vocab
from vag_nmt_tpu.decode.translate import translate_corpus as jax_translate

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.data.datasets import make_toy_examples, toy_vocab

from tests.test_torch_serve import _params

torch.set_num_threads(1)

SCORE_ATOL = 1e-5
KNOBS = ("VAG_STREAM_DECODE", "VAG_TWO_PHASE", "VAG_BEAM_UNROLL",
         "VAG_READOUT_TOPK", "VAG_FRT_SLOTS", "VAG_SUPER_CHUNK")
PATHS = {
    "chunked": dict(decode=dict(streaming="off", two_phase="off")),
    "streaming": dict(decode=dict(streaming="on")),
    "two_phase": dict(decode=dict(streaming="off", two_phase="on",
                                  split_len=4)),
}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("beam,nbest", [(3, 2), (3, 5), (4, 4)])
def test_nbest_matches_jax(path, beam, nbest, monkeypatch):
    upd = PATHS[path]
    jcfg = jax_preset("toy").replace(**upd)
    cfg = vt.preset("toy").replace(**upd)
    jp = _params(jcfg.model)
    params = vt.params_from_numpy(jax.device_get(jp), cfg.model, device="cpu")
    jexs, exs = jax_toy_examples(13, seed=5), make_toy_examples(13, seed=5)
    # 8 rows a super-chunk in both packages: two super-chunks with filler
    monkeypatch.setenv("VAG_SUPER_CHUNK", "8")
    want, wst = jax_translate(jp, jcfg, jexs, jax_toy_vocab(), batch_size=4,
                              beam_size=beam, nbest=nbest)
    got, st = vt.translate_corpus(params, cfg, exs, toy_vocab(), batch_size=4,
                                  beam_size=beam, nbest=nbest, device="cpu")
    assert st.get("streaming", False) == wst.get("streaming", False)
    assert st.get("two_phase", False) == wst.get("two_phase", False)
    assert st.get("streaming", False) == (path == "streaming")
    assert st.get("two_phase", False) == (path == "two_phase")
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        assert len(g) == len(w) == min(nbest, beam)
        assert [t for t, _ in g] == [t for t, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=SCORE_ATOL, rtol=0)
        scores = [s for _, s in g]
        assert scores == sorted(scores, reverse=True)
    # the best of each list is the one-best decode's hypothesis
    one, _ = vt.translate_corpus(params, cfg, exs, toy_vocab(), batch_size=4,
                                 beam_size=beam, device="cpu")
    assert [g[0][0] for g in got] == one


def test_nbest_raises_at_beam_1_and_unfused():
    cfg = vt.preset("toy")
    params = vt.init_params(cfg.model, torch.Generator().manual_seed(0),
                            device="cpu")
    exs = make_toy_examples(3)
    with pytest.raises(ValueError, match="beam_size > 1"):
        vt.translate_corpus(params, cfg, exs, toy_vocab(), beam_size=1,
                            nbest=2, device="cpu")
    with pytest.raises(ValueError, match="fused decode path"):
        vt.translate_corpus(params, cfg, exs, toy_vocab(), nbest=2,
                            fused=False, device="cpu")
    # the JAX package raises the same
    jcfg = jax_preset("toy")
    for kw in (dict(beam_size=1), dict(fused=False)):
        with pytest.raises(ValueError):
            jax_translate(None, jcfg, jax_toy_examples(3), jax_toy_vocab(),
                          nbest=2, **kw)
