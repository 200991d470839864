"""The port's data-directory readers (``data/datasets.py``,
``data/features.py``) against the JAX package's copies on the CPU: the
same examples from the same files, the same checksum, the same refusals of
a misaligned corpus or feature matrix."""

import json
import os

import numpy as np
import pytest

from vag_nmt_tpu.data import datasets as jds
from vag_nmt_tpu.data import features as jfeat
from vag_nmt_tpu.data.vocab import Vocab as JaxVocab

from vag_nmt_tpu_torch.data import datasets as tds
from vag_nmt_tpu_torch.data import features as tfeat
from vag_nmt_tpu_torch.data.vocab import Vocab

LINES_EN = ["w1 w2 w3", "w4 w5", "w6 w7 w8 w9 w10 w11", "w12 xx w3"]
LINES_DE = ["w31 w32", "w33", "w34 w35 w36 w37", "w38 w39 yy"]


@pytest.fixture
def data_dir(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    (d / "test.en").write_text("".join(s + "\n" for s in LINES_EN))
    (d / "test.de").write_text("".join(s + "\n" for s in LINES_DE))
    feats = np.random.RandomState(0).randn(len(LINES_EN), 6).astype(np.float32)
    tfeat.save_features(str(d / "test_features.npy"), feats,
                        corpus_lines=LINES_EN)
    return d, feats


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.src, a.tgt, a.index) == (b.src, b.tgt, b.index)
        assert (a.img is None) == (b.img is None)
        if a.img is not None:
            assert a.img.dtype == b.img.dtype and np.array_equal(a.img, b.img)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(with_target=False),
    dict(feature_file="test_features.npy"),
    dict(feature_file="test_features.npy", max_src_len=2, max_tgt_len=1),
])
def test_load_parallel_split_matches_jax(data_dir, kw):
    d, _ = data_dir
    itos = tds.toy_vocab().itos
    got = tds.load_parallel_split(str(d), "test", "en", "de", Vocab(itos),
                                  Vocab(itos), **kw)
    want = jds.load_parallel_split(str(d), "test", "en", "de", JaxVocab(itos),
                                   JaxVocab(itos), **kw)
    _same(got, want)
    assert got[3].src[1] == 1            # "xx" is <unk>
    if "feature_file" in kw:
        assert got[0].img.dtype == np.float32


def test_feature_file_by_absolute_path(data_dir):
    d, feats = data_dir
    itos = tds.toy_vocab().itos
    got = tds.load_parallel_split(str(d), "test", "en", "de", Vocab(itos),
                                  Vocab(itos),
                                  feature_file=str(d / "test_features.npy"))
    assert np.array_equal(np.stack([ex.img for ex in got]), feats)


def test_misaligned_target_raises_in_both(data_dir):
    d, _ = data_dir
    (d / "test.de").write_text("".join(s + "\n" for s in LINES_DE[:-1]))
    itos = tds.toy_vocab().itos
    for mod, V in ((tds, Vocab), (jds, JaxVocab)):
        with pytest.raises(ValueError, match="misaligned"):
            mod.load_parallel_split(str(d), "test", "en", "de", V(itos),
                                    V(itos))


def test_features_checksum_and_rows_match_jax(data_dir, tmp_path):
    d, feats = data_dir
    path = str(d / "test_features.npy")
    assert tfeat.corpus_checksum(LINES_EN) == jfeat.corpus_checksum(LINES_EN)
    with open(path + ".align.json") as f:
        side = json.load(f)
    assert side == {"rows": len(LINES_EN),
                    "corpus_sha256": jfeat.corpus_checksum(LINES_EN)}
    # the JAX package's writer, our reader (and the other way), no suffix
    jpath = str(tmp_path / "jfeat")
    jfeat.save_features(jpath, feats, corpus_lines=LINES_EN)
    assert os.path.exists(jpath + ".npy.align.json")
    for load in (tfeat.load_features, jfeat.load_features):
        for p in (path, jpath + ".npy"):
            got = load(p, expected_rows=len(LINES_EN), corpus_lines=LINES_EN)
            assert np.array_equal(np.asarray(got), feats)


@pytest.mark.parametrize("fault", ["rows", "checksum"])
def test_features_refuse_a_misaligned_corpus_as_jax(data_dir, fault):
    d, _ = data_dir
    path = str(d / "test_features.npy")
    if fault == "rows":
        kw = dict(expected_rows=len(LINES_EN) + 1)
        match = "rows"
    else:
        kw = dict(corpus_lines=list(reversed(LINES_EN)))
        match = "checksum"
    for load in (tfeat.load_features, jfeat.load_features):
        with pytest.raises(ValueError, match=match):
            load(path, **kw)


def test_split_names_and_feature_file_match_jax():
    for ds in ("multi30k", "ikea", "toy"):
        assert tds.resolve_splits(ds) == jds.resolve_splits(ds)
    with pytest.raises(ValueError):
        tds.resolve_splits("wmt")
    assert tds.default_feature_file("val") == jds.default_feature_file("val")
