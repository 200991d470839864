"""PyTorch port beam search and corpus translation against the JAX package
at the toy preset: the same parameters (through the weight bridge) and the
same inputs give the same tokens and lengths exactly, and scores to 1e-5.
Also the fixed-seed beam golden of the JAX package, reproduced exactly.
All on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import EOS_ID, preset as jax_preset
from vag_nmt_tpu.data.datasets import make_toy_examples as jax_toy_examples
from vag_nmt_tpu.data.datasets import toy_vocab as jax_toy_vocab
from vag_nmt_tpu.decode import beam as jbeam
from vag_nmt_tpu.decode.translate import translate_corpus as jax_translate
from vag_nmt_tpu.models import init_params as jax_init_params
from vag_nmt_tpu.models import prepare_decode as jax_prepare_decode
from vag_nmt_tpu.models.decoder import decode_tables as jax_decode_tables

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.data.batching import Example
from vag_nmt_tpu_torch.data.bpe import remove_bpe
from vag_nmt_tpu_torch.data.datasets import make_toy_examples, toy_vocab
from vag_nmt_tpu_torch.decode import beam
from vag_nmt_tpu_torch.models.decoder import decode_tables

from tests.test_models import make_batch

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "beam_toy.json")
SCORE_ATOL = 1e-5


def _eos_biased(jp):
    """Bias the output layer toward <eos> so hypotheses finish mid-search
    (unbiased random toy params emit no <eos> within a few steps)."""
    jp = jax.tree.map(lambda a: a, jp)
    jp["decoder"]["readout"]["b_out"] = (
        jp["decoder"]["readout"]["b_out"].at[EOS_ID].add(2.5))
    return jp


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_preset("toy")
    jp = _eos_biased(jax_init_params(jax.random.key(0), jcfg.model))
    m = vt.preset("toy").model
    tp = vt.params_from_numpy(jax.device_get(jp), m, device="cpu")
    batch = make_batch(jcfg, B=6, T=8, seed=3)
    jstate = jax_prepare_decode(jp, jcfg.model, batch)
    tstate = vt.prepare_decode(tp, m, {k: np.array(v) for k, v in batch.items()},
                               device="cpu")
    return jcfg.model, jp, jstate, m, tp, tstate


BEAM_CASES = {
    "all_frozen": dict(),
    "no_prune": dict(prune=False),
    "eos_top": dict(beam_finish="eos_top"),
    "row_cap": dict(row_cap=[3, 5, 12, 7, 2, 9]),
    "block_ngram": dict(block_ngram=2, max_len=16),
    "tables_eos_top": dict(tables=True, beam_finish="eos_top"),
}


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_search_matches_jax(setup, case):
    jm, jp, jstate, m, tp, tstate = setup
    kw = dict(beam_size=3, max_len=12)
    kw.update(BEAM_CASES[case])
    jkw, tkw = dict(kw), dict(kw)
    if "row_cap" in kw:
        jkw["row_cap"] = jnp.asarray(kw["row_cap"], jnp.int32)
        tkw["row_cap"] = torch.tensor(kw["row_cap"])
    if kw.pop("tables", False):
        del jkw["tables"], tkw["tables"]
        jkw["tables"] = jax_decode_tables(jp["decoder"])
        tkw["tables"] = decode_tables(tp["decoder"])
    want = jbeam.beam_search(jp, jm, jstate, **jkw)
    got = vt.beam_search(tp, m, tstate, device="cpu", **tkw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(got.best_tokens.numpy(),
                                  np.asarray(want.best_tokens))
    # the search really finished hypotheses (the cases are not vacuous)
    assert bool((got.tokens == EOS_ID).any())
    assert 1 <= got.steps <= kw["max_len"]


@pytest.mark.parametrize("n", [2, 3])
def test_ngram_ban_matches_jax(n):
    rng = np.random.RandomState(n)
    tokens = rng.randint(4, 8, (3, 2, 10)).astype(np.int32)
    for t in range(0, 11):
        want = jbeam.ngram_ban(jnp.asarray(tokens), t, n, 64)
        got = beam.ngram_ban(torch.as_tensor(tokens).long(), t, n, 64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mask_incomplete", [False, True])
def test_finalize_matches_jax(mask_incomplete):
    rng = np.random.RandomState(4)
    B, K, L = 5, 4, 9
    tokens = rng.randint(3, 7, (B, K, L)).astype(np.int32)   # 3 = <eos>
    lengths = rng.randint(0, L + 1, (B, K)).astype(np.int32)
    scores = -rng.randint(1, 4, (B, K)).astype(np.float32)   # with ties
    lengths[0] = 2
    scores[0] = -1.0                                         # all tied
    want = jbeam._finalize(jnp.asarray(tokens), jnp.asarray(lengths),
                           jnp.asarray(scores), L, 1.0,
                           mask_incomplete=mask_incomplete)
    got = beam._finalize(torch.as_tensor(tokens).long(),
                         torch.as_tensor(lengths).long(),
                         torch.as_tensor(scores), L, 1.0,
                         mask_incomplete=mask_incomplete)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


def test_golden_beam_hypotheses():
    """translate_corpus of the port reproduces the JAX package's fixed-seed
    beam-3 golden exactly, from the same JAX init through the bridge."""
    m = vt.preset("toy").model
    jp = jax_init_params(jax.random.key(5), jax_preset("toy").model)
    params = vt.params_from_numpy(jax.device_get(jp), m, device="cpu")
    rng = np.random.RandomState(13)
    exs = [Example(src=list(rng.randint(4, m.src_vocab_size,
                                        rng.randint(3, 14))),
                   img=rng.randn(m.img_feat_dim).astype(np.float32), index=i)
           for i in range(24)]
    hyps, stats = vt.translate_corpus(params, vt.preset("toy"), exs,
                                      toy_vocab(), beam_size=3, de_bpe=False,
                                      device="cpu")
    with open(GOLDEN) as f:
        assert hyps == json.load(f)
    assert stats["beam_loop_steps"] == sum(stats["chunk_steps"])


def test_translate_corpus_matches_jax_with_row_caps():
    """Several chunks of one super-chunk, filler rows, per-row caps, and
    the tabled decode: the port's hypotheses equal the JAX package's."""
    cfg_updates = dict(decode=dict(max_len_factor=1.5, max_len_offset=1))
    jcfg = jax_preset("toy").replace(**cfg_updates)
    cfg = vt.preset("toy").replace(**cfg_updates)
    jp = _eos_biased(jax_init_params(jax.random.key(2), jcfg.model))
    params = vt.params_from_numpy(jax.device_get(jp), cfg.model, device="cpu")
    jexs = jax_toy_examples(11, seed=3)
    exs = make_toy_examples(11, seed=3)
    assert [e.src for e in exs] == [e.src for e in jexs]
    want, _ = jax_translate(jp, jcfg, jexs, jax_toy_vocab(), batch_size=4)
    for tables in (False, True):
        got, st = vt.translate_corpus(params, cfg, exs, toy_vocab(),
                                      batch_size=4, use_tables=tables,
                                      device="cpu")
        assert got == want
    assert (st["n_chunks"], st["rows_per_chunk"], st["t_src"]) == (3, 4, 16)
    assert len(st["chunk_steps"]) == 3
    assert st["sentences_per_sec"] > 0


def test_translate_corpus_unsupported_paths_raise():
    cfg = vt.preset("toy")
    params = vt.init_params(cfg.model, torch.Generator().manual_seed(0),
                            device="cpu")
    exs = make_toy_examples(3)
    vocab = toy_vocab()
    calls = [
        dict(nbest=2),
        dict(fused=False),
        dict(mesh=object()),
        dict(max_len=96),                               # two-phase auto
    ]
    for kw in calls:
        with pytest.raises(NotImplementedError, match="later slice"):
            vt.translate_corpus(params, cfg, exs, vocab, device="cpu", **kw)
    unrolled = cfg.replace(decode=dict(beam_unroll=2))
    with pytest.raises(NotImplementedError, match="later slice"):
        vt.translate_corpus(params, unrolled, exs, vocab, device="cpu")
    short = vt.build_img_table(exs[:2], cfg.model.img_feat_dim, device="cpu")
    with pytest.raises(ValueError, match="img_table"):
        vt.translate_corpus(params, cfg, exs, vocab, img_table=short,
                            device="cpu")
    bad = [Example(src=[4, cfg.model.src_vocab_size], img=exs[0].img)]
    with pytest.raises(ValueError, match="token ids"):
        vt.translate_corpus(params, cfg, bad, vocab, device="cpu")


def test_data_copies_match_jax():
    assert toy_vocab().itos == jax_toy_vocab().itos
    for a, b in zip(make_toy_examples(5, seed=1), jax_toy_examples(5, seed=1)):
        assert (a.src, a.tgt) == (b.src, b.tgt)
        np.testing.assert_array_equal(a.img, b.img)
    assert remove_bpe(["a@@", "b", "c@@", "d@@"]) == ["ab", "cd"]
