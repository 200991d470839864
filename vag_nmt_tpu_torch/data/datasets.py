"""Dataset readers (own copy of the JAX package's ``data/datasets.py``):
parallel splits of a data directory, and the synthetic toy task.

A data directory holds, per split (Multi30k: train, val, test2016,
test2017; IKEA and toy: train, val, test):

    <data_dir>/<split>.<src_lang>          tokenized + BPE'd source text
    <data_dir>/<split>.<tgt_lang>          tokenized + BPE'd target text
    <data_dir>/<split>_features.npy        (N, 2048) pool5 features (optional)

with ``vocab.<lang>.json`` beside them. In the toy task the target is the
reversed source with a fixed token offset, and the "image" feature is a
fixed random projection of the source bag-of-words."""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from vag_nmt_tpu_torch.data.batching import Example
from vag_nmt_tpu_torch.data.features import load_features
from vag_nmt_tpu_torch.data.vocab import Vocab


def read_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [ln.rstrip("\n") for ln in f]


def load_parallel_split(
    data_dir: str,
    split: str,
    src_lang: str,
    tgt_lang: str,
    src_vocab: Vocab,
    tgt_vocab: Optional[Vocab] = None,
    *,
    with_target: bool = True,
    feature_file: str = "",
    max_src_len: int = 10_000,
    max_tgt_len: int = 10_000,
) -> List[Example]:
    """Numericalize a split whose text files are already tokenized and
    BPE'd (space-separated units). Raises ValueError when the two sides'
    line counts differ or the features do not align (``load_features``)."""
    src_lines = read_lines(os.path.join(data_dir, f"{split}.{src_lang}"))
    tgt_lines = None
    if with_target:
        tgt_lines = read_lines(os.path.join(data_dir, f"{split}.{tgt_lang}"))
        if len(tgt_lines) != len(src_lines):
            raise ValueError(
                f"{split}: source has {len(src_lines)} lines, target "
                f"{len(tgt_lines)}: corpus misaligned")
    feats = None
    if feature_file:
        fpath = (feature_file if os.path.isabs(feature_file)
                 else os.path.join(data_dir, feature_file))
        feats = load_features(fpath, expected_rows=len(src_lines),
                              corpus_lines=src_lines)

    out: List[Example] = []
    for i, s in enumerate(src_lines):
        src_ids = src_vocab.encode(s.split())[:max_src_len]
        tgt_ids = None
        if tgt_lines is not None:
            assert tgt_vocab is not None
            tgt_ids = tgt_vocab.encode(tgt_lines[i].split())[:max_tgt_len]
        img = np.asarray(feats[i], np.float32) if feats is not None else None
        out.append(Example(src=src_ids, tgt=tgt_ids, img=img, index=i))
    return out


def default_feature_file(split: str) -> str:
    return f"{split}_features.npy"


def resolve_splits(dataset: str) -> Tuple[str, str, List[str]]:
    """(train_split, dev_split, test_splits) of a dataset family."""
    if dataset == "multi30k":
        return "train", "val", ["test2016", "test2017"]
    if dataset in ("ikea", "toy"):
        return "train", "val", ["test"]
    raise ValueError(f"unknown dataset {dataset!r}")


TOY_N_SYMBOLS = 30
TOY_OFFSET = TOY_N_SYMBOLS  # tgt symbol = src symbol + offset


def toy_vocab() -> Vocab:
    itos = ["<pad>", "<unk>", "<sos>", "<eos>"]
    itos += [f"w{i}" for i in range(2 * TOY_N_SYMBOLS)]
    return Vocab(itos)


def make_toy_examples(
    n: int,
    seed: int = 0,
    *,
    img_dim: int = 64,
    multimodal: bool = True,
    min_len: int = 3,
    max_len: int = 10,
) -> List[Example]:
    """tgt = reverse(src) + TOY_OFFSET; img = fixed projection of src BoW."""
    rng = np.random.RandomState(seed)
    proj = np.random.RandomState(9999).randn(
        2 * TOY_N_SYMBOLS + 4, img_dim).astype(np.float32)
    out = []
    for i in range(n):
        L = rng.randint(min_len, max_len + 1)
        src = (4 + rng.randint(0, TOY_N_SYMBOLS, L)).tolist()
        tgt = [t + TOY_OFFSET for t in reversed(src)]
        img = None
        if multimodal:
            bow = np.zeros(2 * TOY_N_SYMBOLS + 4, np.float32)
            for t in src:
                bow[t] += 1.0
            img = bow @ proj
        out.append(Example(src=src, tgt=tgt, img=img, index=i))
    return out


def write_toy_corpus(data_dir: str, n_train: int = 400, n_val: int = 50,
                     n_test: int = 50, seed: int = 0,
                     img_dim: int = 64) -> None:
    """The toy task as text files ({split}.en, {split}.de) and feature
    matrices ({split}_features.npy) for train, val and test, so the text
    pipeline and the command line run end to end (``make-toy``)."""
    os.makedirs(data_dir, exist_ok=True)
    vocab = toy_vocab()
    for split, n, s in (("train", n_train, seed), ("val", n_val, seed + 1),
                        ("test", n_test, seed + 2)):
        exs = make_toy_examples(n, seed=s, img_dim=img_dim, multimodal=True)
        with open(os.path.join(data_dir, f"{split}.en"), "w") as f:
            for ex in exs:
                f.write(" ".join(vocab.itos[t] for t in ex.src) + "\n")
        with open(os.path.join(data_dir, f"{split}.de"), "w") as f:
            for ex in exs:
                f.write(" ".join(vocab.itos[t] for t in ex.tgt) + "\n")
        feats = np.stack([ex.img for ex in exs])
        np.save(os.path.join(data_dir, f"{split}_features.npy"), feats)
