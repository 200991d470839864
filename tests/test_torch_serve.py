"""The serving path of the PyTorch port against the JAX package, on the CPU
at the toy preset, from the same parameters (through the weight bridge):
greedy decode, the streaming-refill beam decoder, translate_corpus with
streaming and greedy, and the Translator (raw text through Moses
tokenizer, truecaser and BPE, then decode, then detruecase and Moses
detokenize). Tokens, lengths, loop trips and refills are exact; beam scores
to 1e-6.

The JAX Translator is built with its constructor from the JAX parameters;
no JAX checkpoint is written. The port's Translator comes from from_run on
a run dir holding the port's checkpoint and config.json."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import EOS_ID, preset as jax_preset
from vag_nmt_tpu.data import bpe as jbpe
from vag_nmt_tpu.data.datasets import make_toy_examples as jax_toy_examples
from vag_nmt_tpu.data.datasets import toy_vocab as jax_toy_vocab
from vag_nmt_tpu.data.moses import Truecaser as JTruecaser
from vag_nmt_tpu.data.vocab import Vocab as JVocab
from vag_nmt_tpu.decode import beam as jbeam
from vag_nmt_tpu.decode.greedy import greedy_decode as jax_greedy
from vag_nmt_tpu.decode.serve import Translator as JTranslator
from vag_nmt_tpu.decode.translate import translate_corpus as jax_translate
from vag_nmt_tpu.models import init_params as jax_init_params
from vag_nmt_tpu.models import prepare_decode as jax_prepare_decode
from vag_nmt_tpu.models.decoder import decode_tables as jax_decode_tables

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.data.datasets import make_toy_examples, toy_vocab
from vag_nmt_tpu_torch.decode import serve as tserve
from vag_nmt_tpu_torch.models.decoder import decode_tables
from vag_nmt_tpu_torch.train.checkpoint import save_checkpoint
from vag_nmt_tpu_torch.train.state import state_from_params

from tests.test_models import make_batch

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

SCORE_ATOL = 1e-6


def _params(model_cfg):
    """JAX toy params whose <eos> output column is scaled up 3x, so that
    its logit swings with the readout state: some hypotheses finish after a
    few steps and others run to max_len (a constant <eos> bias ends all of
    them at step 1 or none)."""
    jp = jax_init_params(jax.random.key(0), model_cfg)
    r = jp["decoder"]["readout"]
    r["w_out"] = r["w_out"].at[:, EOS_ID].multiply(3.0)
    return jp


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_preset("toy")
    jp = _params(jcfg.model)
    m = vt.preset("toy").model
    tp = vt.params_from_numpy(jax.device_get(jp), m, device="cpu")
    batch = make_batch(jcfg, B=10, T=8, seed=3)
    jstate = jax_prepare_decode(jp, jcfg.model, batch)
    tstate = vt.prepare_decode(tp, m, {k: np.array(v) for k, v in batch.items()},
                               device="cpu")
    return jcfg.model, jp, jstate, m, tp, tstate


GREEDY_CASES = {
    "plain": dict(),
    "block_ngram": dict(block_ngram=2),
    "row_cap": dict(row_cap=[3, 5, 12, 7, 2, 9, 4, 1, 12, 6]),
    "tables_ngram_cap": dict(tables=True, block_ngram=2,
                             row_cap=[3, 5, 12, 7, 2, 9, 4, 1, 12, 6]),
}


@pytest.mark.parametrize("case", sorted(GREEDY_CASES))
def test_greedy_decode_matches_jax(setup, case):
    jm, jp, jstate, m, tp, tstate = setup
    kw = dict(GREEDY_CASES[case])
    jkw, tkw = {}, {}
    if "row_cap" in kw:
        jkw["row_cap"] = jnp.asarray(kw["row_cap"], jnp.int32)
        tkw["row_cap"] = torch.tensor(kw["row_cap"])
    if kw.get("tables"):
        jkw["tables"] = jax_decode_tables(jp["decoder"])
        tkw["tables"] = decode_tables(tp["decoder"])
    if "block_ngram" in kw:
        jkw["block_ngram"] = tkw["block_ngram"] = kw["block_ngram"]
    toks, lens = jax_greedy(jp, jm, jstate, 12, **jkw)
    got = vt.greedy_decode(tp, m, tstate, 12, **tkw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(toks))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(lens))
    lens = np.asarray(lens)
    # not vacuous: some rows end on <eos>, some run on
    assert 1 < got.steps <= 12 and lens.min() < lens.max()


STREAM_CASES = {
    "default": dict(),
    "threshold_1": dict(refill_threshold=1),
    "eos_top": dict(beam_finish="eos_top"),
    "block_ngram": dict(block_ngram=2),
    "tables_row_cap": dict(tables=True, refill_threshold=1,
                           row_cap=[3, 5, 12, 7, 2, 9, 4, 1, 12, 6]),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_beam_search_streaming_matches_jax(setup, case):
    jm, jp, jstate, m, tp, tstate = setup
    kw = dict(beam_size=3, max_len=12)
    kw.update(STREAM_CASES[case])
    jkw, tkw = dict(kw), dict(kw)
    if "row_cap" in kw:
        jkw["row_cap"] = jnp.asarray(kw["row_cap"], jnp.int32)
        tkw["row_cap"] = torch.tensor(kw["row_cap"])
    if kw.pop("tables", False):
        jkw["tables"] = jax_decode_tables(jp["decoder"])
        tkw["tables"] = decode_tables(tp["decoder"])
    want, wsteps, wrefills = jbeam.beam_search_streaming(
        jp, jm, jstate, slots=4, **jkw)
    got, steps, refills = vt.beam_search_streaming(tp, m, tstate, slots=4,
                                                   device="cpu", **tkw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=SCORE_ATOL, rtol=0)
    assert (steps, refills) == (int(wsteps), int(wrefills))
    assert refills >= 2 and steps == got.steps
    # exact architecture: the pool decodes as the chunked search does
    tkw.pop("refill_threshold", None)
    ref = vt.beam_search(tp, m, tstate, device="cpu", **tkw)
    np.testing.assert_array_equal(got.best_tokens.numpy(),
                                  ref.best_tokens.numpy())
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())


def test_streaming_with_fused_step_matches_chunked(setup, monkeypatch):
    """With the fused decode step selected, the pool still decodes as the
    chunked search does (the step is row-local)."""
    _, _, _, m, tp, tstate = setup
    kw = dict(beam_size=3, max_len=12, tables=decode_tables(tp["decoder"]))
    monkeypatch.setenv("VAG_DEC_STEP", "on")
    ref = vt.beam_search(tp, m, tstate, device="cpu", **kw)
    got, _, _ = vt.beam_search_streaming(tp, m, tstate, slots=3,
                                         refill_threshold=1, device="cpu",
                                         **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths.numpy())


@pytest.mark.parametrize("mode", ["streaming", "greedy"])
def test_translate_corpus_matches_jax(mode, monkeypatch):
    """Several chunks and two super-chunks with filler rows, per-row caps."""
    upd = dict(decode=dict(max_len_factor=1.5, max_len_offset=2,
                           streaming="on" if mode == "streaming" else "auto"))
    jcfg = jax_preset("toy").replace(**upd)
    cfg = vt.preset("toy").replace(**upd)
    jp = _params(jcfg.model)
    params = vt.params_from_numpy(jax.device_get(jp), cfg.model, device="cpu")
    jexs, exs = jax_toy_examples(21, seed=3), make_toy_examples(21, seed=3)
    beam = 1 if mode == "greedy" else None
    # 8 rows per super-chunk in both packages: three pools of two chunks
    monkeypatch.setenv("VAG_SUPER_CHUNK", "8")
    want, wst = jax_translate(jp, jcfg, jexs, jax_toy_vocab(), batch_size=4,
                              beam_size=beam)
    got, st = vt.translate_corpus(params, cfg, exs, toy_vocab(), batch_size=4,
                                  beam_size=beam, device="cpu")
    assert got == want
    assert st["n_chunks"] == wst["n_chunks"] == 6
    if mode == "streaming":
        assert st["streaming"] and wst["streaming"]
        assert st["chunk_steps"] == wst["chunk_steps"]
        assert st["refills"] == wst["refills"]
        assert len(st["refills"]) == 3 and sum(st["refills"]) > 0


# ---- Translator -----------------------------------------------------------

TRAIN_LINES = [
    "A man rides a bicycle down the street.",
    "Two men ride bicycles along the road, slowly.",
    "The woman is riding a horse on the beach!",
    "Riders wear helmets while riding in Paris.",
    "A dog runs after the riders.",
]
REQUEST = [
    "A man rides a horse.",
    "The dog's riders wear helmets in Paris!",
    "",
    "Two women ride along the beach, slowly.",
    "riding riding riding",
    "A zebra rides a bicycle down the road.",
    "The man (with a dog) walks.",
    "Helmets!",
    "Men and women ride horses on the street.",
    "A dog.",
    "The riders ride bicycles.",
]
BS = 4


@pytest.fixture(scope="module")
def translators(tmp_path_factory):
    from vag_nmt_tpu.data.moses import MosesTokenizer as JMoses

    d = tmp_path_factory.mktemp("serve")
    data_dir, run_dir = d / "data", d / "run"
    data_dir.mkdir()
    tok = JMoses("en")
    lines = [tok.tokenize(ln) for ln in TRAIN_LINES]
    tc = JTruecaser.train(lines)
    tc.save(str(data_dir / "truecase.en.json"))
    cased = [tc.truecase(ln) for ln in lines]
    merges = jbpe.learn_bpe_from_lines(cased, 60)
    bpe = jbpe.BPE(merges, use_native=False)
    bpe.save(str(data_dir / "bpe.en.json"))
    units = sorted({u for ln in cased for u in bpe.encode_tokens(ln)})
    src_vocab = JVocab(["<pad>", "<unk>", "<sos>", "<eos>"] + units)
    src_vocab.save(str(data_dir / "vocab.en.json"))
    jax_toy_vocab().save(str(data_dir / "vocab.de.json"))
    (data_dir / "preprocess.json").write_text(json.dumps(
        {"tokenizer": "moses", "lower": False, "truecase": True}))

    upd = dict(model=dict(src_vocab_size=len(src_vocab),
                          tgt_vocab_size=len(jax_toy_vocab())),
               data=dict(data_dir=str(data_dir), src_lang="en",
                         tgt_lang="de"))
    jcfg = jax_preset("toy").replace(**upd)
    cfg = vt.preset("toy").replace(**upd)
    jp = _params(jcfg.model)
    params = vt.params_from_numpy(jax.device_get(jp), cfg.model, device="cpu")
    save_checkpoint(str(run_dir / cfg.train.checkpoint_dir), "best",
                    state_from_params(cfg, params))
    (run_dir / "config.json").write_text(cfg.to_json())

    jtr = JTranslator(jcfg, jp, bpe, src_vocab, jax_toy_vocab(), lower=False,
                      tokenizer="moses", truecaser=tc)
    ttr = vt.Translator.from_run(str(run_dir), device="cpu")
    return jtr, ttr, str(run_dir)


TRANSLATE_MODES = {
    "default": dict(),                         # streaming pool
    "chunked": dict(streaming=False),
    "bulk": dict(bulk=True),
    "greedy": dict(beam_size=1),
    "display": dict(display=True, pool_chunks=2),
}


@pytest.mark.parametrize("mode", sorted(TRANSLATE_MODES))
def test_translator_matches_jax(translators, mode):
    jtr, ttr, _ = translators
    kw = dict(batch_size=BS, **TRANSLATE_MODES[mode])
    want = jtr.translate(REQUEST, **kw)
    got = ttr.translate(REQUEST, **kw)
    assert got == want
    assert len(got) == len(REQUEST) and any(got)


def test_translator_preprocessing_matches_jax(translators):
    jtr, ttr, _ = translators
    assert (ttr.tokenizer, ttr.lower) == ("moses", False)
    for line in REQUEST + TRAIN_LINES:
        assert ttr._encode_line(line) == jtr._encode_line(line)
    imgs = np.random.RandomState(0).randn(
        2, ttr.cfg.model.img_feat_dim).astype(np.float32)
    assert (ttr.translate(REQUEST[:2], images=imgs)
            == jtr.translate(REQUEST[:2], images=imgs))
    with pytest.raises(ValueError, match="images"):
        ttr.translate(REQUEST[:2], images=imgs[:1])


def test_bulk_takes_single_dispatch(translators, monkeypatch):
    """bulk=True decodes the whole request in one translate_corpus call
    with the run's own config, whatever the streaming default."""
    _, ttr, _ = translators
    calls = []
    real = tserve.translate_corpus

    def spy(params, cfg, exs, *a, **kw):
        calls.append((len(exs), cfg.decode.streaming))
        return real(params, cfg, exs, *a, **kw)

    monkeypatch.setattr(tserve, "translate_corpus", spy)
    ttr.translate(REQUEST, batch_size=BS, bulk=True)
    assert calls == [(len(REQUEST), ttr.cfg.decode.streaming)]
    calls.clear()
    ttr.translate(REQUEST, batch_size=BS, streaming=False)
    assert [n for n, _ in calls] == [4, 4, 3]
    calls.clear()
    ttr.translate(REQUEST, batch_size=BS, pool_chunks=2)
    assert calls == [(8, "on"), (3, ttr.cfg.decode.streaming)]


def test_warmup_count_matches_jax(translators):
    jtr, ttr, _ = translators
    for chunks in ((), (2,)):
        assert (ttr.warmup(batch_size=2, streaming_chunks=chunks)
                == jtr.warmup(batch_size=2, streaming_chunks=chunks))


def test_from_run_needs_the_card_by_default(translators, monkeypatch):
    _, _, run_dir = translators
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vt.Translator.from_run(run_dir)


def test_from_run_missing_truecase_model_raises(translators, tmp_path):
    import os
    import shutil

    _, ttr, run_dir = translators
    data_dir = tmp_path / "data"
    shutil.copytree(ttr.cfg.data.data_dir, data_dir)
    os.remove(data_dir / "truecase.en.json")
    with pytest.raises(FileNotFoundError, match="truecase"):
        vt.Translator.from_run(run_dir, data_dir=str(data_dir), device="cpu")
