"""PyTorch port, offline preprocessing against the JAX package, on the
CPU: the BPE learner (hypothesis-drawn word counts), ``preprocess_corpus``
(its artifacts byte for byte under Moses tokenization with lowercasing,
with a truecaser, and under the simple tokenizer), the toy corpus
(``write_toy_corpus`` + ``preprocess_toy`` and the ``make-toy`` command)
and the ``preprocess`` command; and the rule that the new modules import
nothing of JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from vag_nmt_tpu.data import pipeline as jpipe
from vag_nmt_tpu.data.bpe import learn_bpe as jax_learn_bpe
from vag_nmt_tpu.data.datasets import write_toy_corpus as jax_write_toy

from vag_nmt_tpu_torch import cli
from vag_nmt_tpu_torch.data import pipeline
from vag_nmt_tpu_torch.data.bpe import BPE, learn_bpe, learn_bpe_from_lines
from vag_nmt_tpu_torch.data.datasets import write_toy_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(freqs=st.dictionaries(
    st.text(alphabet="abcdeéß-'", min_size=0, max_size=9),
    st.integers(1, 50), max_size=60),
    merges=st.integers(0, 80))
def test_learn_bpe_matches_jax(freqs, merges):
    assert learn_bpe(freqs, merges) == jax_learn_bpe(freqs, merges)


def test_learn_bpe_from_lines_and_save(tmp_path):
    lines = [["low", "lower", "newest"], ["widest", "newest", "low"]] * 3
    merges = learn_bpe_from_lines(lines, 20)
    assert merges == jax_learn_bpe(
        {"low": 6, "lower": 3, "newest": 6, "widest": 3}, 20)
    BPE(merges).save(str(tmp_path / "b.json"))
    from vag_nmt_tpu.data.bpe import BPE as JBPE

    JBPE(merges).save(str(tmp_path / "j.json"))
    assert (tmp_path / "b.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert BPE.load(str(tmp_path / "b.json")).merges == BPE(merges).merges


_EN = ["A man in a blue shirt is standing on a ladder.",
       "Two young, White males are outside near many bushes!",
       "The girl's dog isn't running -- it's jumping over 3.5 hurdles.",
       "Several men in hard-hats are operating a giant pulley system.",
       "A little girl climbing into a wooden playhouse (in the U.S.).",
       "\"Look,\" said the woman, pointing at the $20 bill & the cat's toy."]
_DE = ["Ein Mann in einem blauen Hemd steht auf einer Leiter.",
       "Zwei junge weiße Männer sind im Freien in der Nähe vieler Büsche!",
       "Der Hund des Mädchens läuft nicht -- er springt über 3,5 Hürden.",
       "Mehrere Männer mit Schutzhelmen bedienen ein Antriebsradsystem.",
       "Ein kleines Mädchen klettert in ein Spielhaus aus Holz (in den USA).",
       "„Schau“, sagte die Frau und zeigte auf den 20-€-Schein & das Spielzeug."]
SPLITS = {"train": 60, "val": 9, "test2016": 7}


def _raw_corpus(d):
    """Raw parallel text (casing, punctuation, clitics, numbers, quotes)
    and a feature matrix with its alignment sidecar for the train split."""
    rng = np.random.RandomState(3)
    for split, n in SPLITS.items():
        for lang, pool in (("en", _EN), ("de", _DE)):
            rows = []
            for i in range(n):
                a, b = rng.randint(len(pool), size=2)
                words = pool[a].split()
                rows.append(" ".join(words[: rng.randint(3, len(words) + 1)])
                            + " " + pool[b])
            with open(os.path.join(d, f"{split}.{lang}"), "w",
                      encoding="utf-8") as f:
                f.write("\n".join(rows) + "\n")
    np.save(os.path.join(d, "train_features.npy"),
            rng.randn(SPLITS["train"], 8).astype(np.float32))
    with open(os.path.join(d, "train_features.npy.align.json"), "w") as f:
        f.write('{"rows": 60}')


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return names


MODES = {"moses_lower": dict(), "truecase": dict(lower=False, truecase=True),
         "simple": dict(tokenizer="simple"),
         "moses_cased": dict(lower=False)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_preprocess_corpus_artifacts_match_jax(tmp_path, mode):
    raw = tmp_path / "raw"
    raw.mkdir()
    _raw_corpus(str(raw))
    kw = dict(MODES[mode], bpe_merges=120)
    splits, langs = list(SPLITS), ["en", "de"]
    pipeline.preprocess_corpus(str(raw), str(tmp_path / "port"), splits,
                               langs, **kw)
    jpipe.preprocess_corpus(str(raw), str(tmp_path / "jax"), splits, langs,
                            **kw)
    names = _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert ("truecase.en.json" in names) == (mode == "truecase")
    assert "train_features.npy" in names and "bpe.de.json" in names


def test_preprocess_command_matches_jax(tmp_path, capsys):
    raw = tmp_path / "raw"
    raw.mkdir()
    _raw_corpus(str(raw))
    argv = ["preprocess", "--raw-dir", str(raw), "--splits",
            ",".join(SPLITS), "--bpe-merges", "80", "--vocab-max-size", "40",
            "--vocab-min-freq", "2"]
    cli.main(argv + ["--out-dir", str(tmp_path / "port")])
    assert "preprocessed" in capsys.readouterr().out
    from vag_nmt_tpu import cli as jcli

    jcli.main(argv + ["--out-dir", str(tmp_path / "jax")])
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_write_toy_corpus_and_make_toy_match_jax(tmp_path, capsys):
    write_toy_corpus(str(tmp_path / "port"), n_train=30, n_val=5, n_test=4,
                     seed=2, img_dim=16)
    jax_write_toy(str(tmp_path / "jax"), n_train=30, n_val=5, n_test=4,
                  seed=2, img_dim=16)
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    argv = ["make-toy", "--n-train", "40", "--n-val", "6", "--img-dim", "32"]
    cli.main(argv + ["--out-dir", str(tmp_path / "cli_port")])
    assert "toy corpus" in capsys.readouterr().out
    jax_write_toy(str(tmp_path / "cli_jax"), n_train=40, n_val=6, n_test=50,
                  img_dim=32)
    jpipe.preprocess_toy(str(tmp_path / "cli_jax"))
    names = _same_tree(str(tmp_path / "cli_port"), str(tmp_path / "cli_jax"))
    assert "vocab.en.json" in names and "test_features.npy" in names


def test_postprocess_hypothesis_matches_jax():
    for units in (["a@@", "b", "c"], [], ["x@@"], ["ab@@", "c@@", "d", "e"]):
        assert pipeline.postprocess_hypothesis(units) == \
            jpipe.postprocess_hypothesis(units)


def test_import_guard_covers_parallel_and_pipeline():
    code = (
        "import sys, pkgutil, importlib\n"
        "for blocked in ('jax', 'jaxlib', 'flax', 'optax'):\n"
        "    sys.modules[blocked] = None\n"
        "import vag_nmt_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'vag_nmt_tpu' or m.startswith('vag_nmt_tpu.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(m for m in sys.modules\n"
        "                      if m.startswith('vag_nmt_tpu_torch.'))))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    for name in ("parallel", "parallel.sharding", "data.pipeline",
                 "data.bpe", "data.datasets", "core.flops", "core.metrics"):
        assert f"vag_nmt_tpu_torch.{name}" in loaded, name
