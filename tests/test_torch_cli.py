"""The port's command line (``python -m vag_nmt_tpu_torch``) on the CPU, on
a synthetic data directory in the real layout (``{split}.{lang}``,
``vocab.{lang}.json``, ``{split}_features.npy`` with its ``.align.json``,
``preprocess.json``): ``train`` for a few steps, then ``translate``,
``translate --nbest 3``, ``score --meteor``, ``retrieval`` and
``translate-text`` on the run it wrote. What the commands print and write
is held against the JAX package's functions called directly on the same
params (never through the JAX command line): ``translate_corpus`` (n-best
texts exactly, scores to 1e-5), ``corpus_bleu`` (equal), ``meteor_score``
(to 1e-6, with nltk and without it) and ``retrieval_recall`` on
``embeddings_for_retrieval`` (to 1e-5). The toy preset; all on the CPU."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import Config as JaxConfig
from vag_nmt_tpu.data.batching import BucketBatcher as JaxBatcher
from vag_nmt_tpu.data.batching import Example as JaxExample
from vag_nmt_tpu.data.vocab import Vocab as JaxVocab
from vag_nmt_tpu.decode.translate import translate_corpus as jax_translate
from vag_nmt_tpu.evaluation.bleu import corpus_bleu as jax_bleu
from vag_nmt_tpu.evaluation.meteor import meteor_score as jax_meteor
from vag_nmt_tpu.evaluation.retrieval import retrieval_recall as jax_recall
from vag_nmt_tpu.models import embeddings_for_retrieval as jax_embeddings

from vag_nmt_tpu_torch import cli
from vag_nmt_tpu_torch.data.datasets import make_toy_examples, toy_vocab
from vag_nmt_tpu_torch.data.features import save_features
from vag_nmt_tpu_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(1)

SPLITS = {"train": (48, 0), "val": (8, 1), "test": (12, 2)}
SCORE_ATOL = 1e-5
METEOR_ATOL = 1e-6
RECALL_ATOL = 1e-5
STEPS = 3
NO_NLTK = ("nltk", "nltk.stem", "nltk.stem.snowball", "nltk.corpus")


def write_data_dir(d, img_dim=64):
    """The toy task as a data directory: text of each split and language
    (vocab units, space-separated), vocab files, features with their
    alignment sidecar, the preprocess manifest."""
    vocab = toy_vocab()
    for lang in ("en", "de"):
        vocab.save(os.path.join(d, f"vocab.{lang}.json"))
    for split, (n, seed) in SPLITS.items():
        exs = make_toy_examples(n, seed=seed, img_dim=img_dim)
        src = [" ".join(vocab.itos[t] for t in ex.src) for ex in exs]
        with open(os.path.join(d, f"{split}.en"), "w") as f:
            f.write("".join(s + "\n" for s in src))
        with open(os.path.join(d, f"{split}.de"), "w") as f:
            f.write("".join(" ".join(vocab.itos[t] for t in ex.tgt) + "\n"
                            for ex in exs))
        save_features(os.path.join(d, f"{split}_features.npy"),
                      np.stack([ex.img for ex in exs]), corpus_lines=src)
    with open(os.path.join(d, "preprocess.json"), "w") as f:
        json.dump({"tokenizer": "simple", "lower": True, "truecase": False}, f)


def _run(capsys, *argv):
    """cli.main on the CPU; the last line it printed, parsed."""
    cli.main([*argv, "--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A data directory and a run the port's ``train`` wrote (STEPS steps),
    with the run's params as a JAX tree and the JAX config and examples."""
    root = tmp_path_factory.mktemp("cli")
    data, run = str(root / "data"), str(root / "run")
    os.makedirs(data)
    write_data_dir(data)
    cli.main(["train", "--preset", "toy", "--data-dir", data, "--out-dir", run,
              "--max-steps", str(STEPS), "--set", "train.eval_every_steps=0",
              "--debug-nans", "--device", "cpu"])
    with open(os.path.join(run, "config.json")) as f:
        jcfg = JaxConfig.from_json(f.read())
    state, meta = load_checkpoint(os.path.join(run, "checkpoints"), "last",
                                  device="cpu")
    assert state.step == STEPS and meta["step"] == STEPS
    jparams = jax.tree.map(lambda x: jnp.asarray(x.numpy()), state.params)
    vocab = JaxVocab.load(os.path.join(data, "vocab.de.json"))
    jexs = [JaxExample(src=ex.src, tgt=ex.tgt, img=ex.img, index=ex.index)
            for ex in make_toy_examples(SPLITS["test"][0], seed=2)]
    return data, run, jcfg, jparams, vocab, jexs


def test_train_writes_a_run(trained):
    data, run, jcfg, _, _, _ = trained
    assert os.path.exists(os.path.join(run, "checkpoints", "state_last.pt"))
    assert jcfg.data.data_dir == data and jcfg.model.src_vocab_size == 64
    with open(os.path.join(run, "metrics.jsonl")) as f:
        tags = [json.loads(ln)["tag"] for ln in f if ln.strip()]
    assert "done" in tags


def test_translate_and_score_match_jax(trained, tmp_path, capsys):
    data, run, jcfg, jparams, vocab, jexs = trained
    hyp = tmp_path / "hyp.txt"
    stats = _run(capsys, "translate", "--data-dir", data, "--checkpoint", run,
                 "--tag", "last", "--split", "test", "--output", str(hyp))
    assert stats["sentences"] == len(jexs) and stats["beam_size"] == 3
    want, _ = jax_translate(jparams, jcfg, jexs, vocab)
    got = hyp.read_text().splitlines()
    assert got == want
    ref = os.path.join(data, "test.de")
    out = _run(capsys, "score", "--hyp", str(hyp), "--ref", ref)
    with open(ref) as f:
        refs = [ln.rstrip("\n") for ln in f]
    jb = jax_bleu(want, refs)
    assert out["bleu"] == jb.bleu and out["precisions"] == jb.precisions
    assert out["brevity_penalty"] == jb.brevity_penalty


@pytest.mark.parametrize("nltk", ["present", "absent"])
def test_score_meteor_matches_jax(trained, tmp_path, capsys, monkeypatch, nltk):
    data, _, _, _, _, _ = trained
    ref = os.path.join(data, "test.de")
    with open(ref) as f:
        refs = [ln.rstrip("\n") for ln in f]
    # hypotheses that share some words with the references, not all
    hyps = [" ".join(w for i, w in enumerate(r.split()) if i % 3) + " w40"
            for r in refs]
    hyp = tmp_path / "hyp.txt"
    hyp.write_text("".join(h + "\n" for h in hyps))
    if nltk == "absent":
        for mod in NO_NLTK:
            monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.delenv("METEOR_JAR", raising=False)
    out = _run(capsys, "score", "--hyp", str(hyp), "--ref", ref, "--meteor",
               "--lang", "de")
    want = jax_meteor(hyps, refs, lang="de")
    assert 0.0 < want < 1.0
    assert abs(out["meteor"] - want) <= METEOR_ATOL


def test_translate_nbest_matches_jax(trained, tmp_path, capsys):
    data, run, jcfg, jparams, vocab, jexs = trained
    out = tmp_path / "nbest.txt"
    _run(capsys, "translate", "--data-dir", data, "--checkpoint", run,
         "--tag", "last", "--split", "test", "--output", str(out),
         "--nbest", "3", "--beam", "3")
    want, _ = jax_translate(jparams, jcfg, jexs, vocab, beam_size=3, nbest=3)
    rows = [ln.split(" ||| ") for ln in out.read_text().splitlines()]
    assert len(rows) == 3 * len(jexs)
    for r, (i, text, score) in enumerate(rows):
        w_text, w_score = want[r // 3][r % 3]
        assert int(i) == r // 3 and text == w_text
        assert abs(float(score) - w_score) <= SCORE_ATOL


def test_retrieval_matches_jax(trained, capsys):
    data, run, jcfg, jparams, vocab, jexs = trained
    got = _run(capsys, "retrieval", "--data-dir", data, "--checkpoint", run,
               "--tag", "last", "--split", "test")
    exs = [JaxExample(src=ex.src, tgt=ex.tgt, img=ex.img, index=i)
           for i, ex in enumerate(jexs)]
    batcher = JaxBatcher(exs, jcfg.decode.decode_batch_size,
                         jcfg.data.length_buckets, include_image=True,
                         img_dim=jcfg.model.img_feat_dim)
    n, D = len(exs), jcfg.model.shared_dim
    img, txt = np.zeros((n, D), np.float32), np.zeros((n, D), np.float32)
    for batch in batcher.epoch(0, shuffle=False):
        feed = {k: v for k, v in batch.items() if k != "index"}
        ie, te = jax.device_get(jax_embeddings(jparams, jcfg.model, feed))
        for r in range(ie.shape[0]):
            if batch["sample_mask"][r] > 0:
                img[batch["index"][r]] = ie[r]
                txt[batch["index"][r]] = te[r]
    want = jax_recall(img, txt)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= RECALL_ATOL, k


def test_translate_text(trained, tmp_path, capsys):
    data, run, jcfg, jparams, vocab, jexs = trained
    lines = [" ".join(vocab.itos[t] for t in ex.src) for ex in jexs]
    inp, out = tmp_path / "in.txt", tmp_path / "out.txt"
    inp.write_text("".join(s + "\n" for s in lines))
    cli.main(["translate-text", "--checkpoint", run, "--tag", "last",
              "--input", str(inp), "--output", str(out), "--device", "cpu"])
    want, _ = jax_translate(jparams, jcfg, [
        JaxExample(src=ex.src, img=np.zeros(jcfg.model.img_feat_dim,
                                            np.float32), index=ex.index)
        for ex in jexs], vocab)
    assert out.read_text().splitlines() == want


@pytest.mark.parametrize("argv", [
    ["score", "--hyp", "h", "--ref", "r"],
    ["translate", "--data-dir", "d", "--checkpoint", "c", "--output", "o"],
    ["train", "--data-dir", "d", "--out-dir", "o"],
    ["retrieval", "--data-dir", "d", "--checkpoint", "c"],
    ["translate-text", "--checkpoint", "c", "--input", "i"],
    ["extract-features", "--image-dir", "d", "--image-list", "l", "--out", "o"],
])
def test_every_command_needs_a_card_or_device_cpu(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_help_lists_the_commands(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    text = capsys.readouterr().out
    for cmd in ("train", "translate", "score", "retrieval", "translate-text",
                "preprocess", "make-toy", "extract-features"):
        assert cmd in text
    assert "Not ported yet" not in text


def test_translate_profile_dir_writes_a_trace(trained, tmp_path, capsys):
    """--profile-dir: a torch.profiler trace (Chrome-trace JSON, which
    TensorBoard and Perfetto open) of the decode, with step_annotation's
    named regions in it."""
    from vag_nmt_tpu_torch.core.profiling import maybe_trace, step_annotation

    data, run, _, _, _, _ = trained
    prof = tmp_path / "prof"
    _run(capsys, "translate", "--data-dir", data, "--checkpoint", run,
         "--tag", "last", "--split", "test", "--output",
         str(tmp_path / "h.txt"), "--profile-dir", str(prof))
    with open(prof / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    with maybe_trace(str(tmp_path / "p2")):
        with step_annotation("annotated_step"):
            torch.ones(3) + 1
    assert "annotated_step" in (tmp_path / "p2" / "trace.json").read_text()
    with maybe_trace(""):           # no directory: nothing traced
        pass
