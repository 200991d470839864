"""Offline corpus preprocessing (own copy of the JAX package's
``data/pipeline.py``): raw parallel text to a data directory, in pure
Python (tokenize -> lowercase or truecase -> learn BPE on train -> apply
BPE -> vocab):

    <out_dir>/<split>.<lang>        BPE'd text (space-separated units)
    <out_dir>/bpe.<lang>.json       merge table
    <out_dir>/vocab.<lang>.json     vocabulary
    <out_dir>/truecase.<lang>.json  truecase model (when truecase=True)
    <out_dir>/preprocess.json       the options, replayed on raw input by
                                    ``decode/serve.Translator``

Tokenization is Moses-parity by default (``data/moses.py``);
``tokenizer="simple"`` selects the regex tokenizer. Casing: ``lower=True``
(the Multi30k convention) or ``truecase=True`` (a truecaser trained on the
train split, applied to every split). Feature .npy files and their
alignment sidecars are copied through untouched. The artifacts are the
JAX package's, byte for byte."""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Sequence

from vag_nmt_tpu_torch.data.bpe import BPE, learn_bpe_from_lines, remove_bpe
from vag_nmt_tpu_torch.data.moses import MosesTokenizer, Truecaser
from vag_nmt_tpu_torch.data.tokenizer import tokenize as simple_tokenize
from vag_nmt_tpu_torch.data.vocab import Vocab


def preprocess_corpus(
    raw_dir: str,
    out_dir: str,
    splits: Sequence[str],
    langs: Sequence[str],
    *,
    bpe_merges: int = 10000,
    vocab_min_freq: int = 1,
    vocab_max_size: int = 0,
    lower: bool = True,
    truecase: bool = False,
    tokenizer: str = "moses",
) -> None:
    """Raw ``<raw_dir>/<split>.<lang>`` files -> the artifacts above. The
    first split is the training split: the truecaser, the BPE merges and
    the vocab are learned on it alone."""
    if truecase and lower:
        lower = False  # truecasing subsumes lowercasing
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "preprocess.json"), "w") as f:
        json.dump({"tokenizer": tokenizer, "lower": lower,
                   "truecase": truecase, "langs": list(langs),
                   "bpe_merges": bpe_merges}, f)
    for lang in langs:
        mt = MosesTokenizer(lang) if tokenizer == "moses" else None

        def tok_line(ln: str) -> List[str]:
            if mt is not None:
                toks = mt.tokenize(ln)
                return [t.lower() for t in toks] if lower else toks
            return simple_tokenize(ln, lower=lower)

        tokenized = {}
        for split in splits:
            path = os.path.join(raw_dir, f"{split}.{lang}")
            with open(path, encoding="utf-8") as f:
                tokenized[split] = [tok_line(ln.rstrip("\n")) for ln in f]
        if truecase:
            tc = Truecaser.train(tokenized[splits[0]])
            tc.save(os.path.join(out_dir, f"truecase.{lang}.json"))
            for split in splits:
                tokenized[split] = [tc.truecase(toks)
                                    for toks in tokenized[split]]
        bpe = BPE(learn_bpe_from_lines(tokenized[splits[0]], bpe_merges))
        bpe.save(os.path.join(out_dir, f"bpe.{lang}.json"))
        segmented = {}
        for split in splits:
            segmented[split] = [bpe.encode_line(" ".join(toks))
                                for toks in tokenized[split]]
            with open(os.path.join(out_dir, f"{split}.{lang}"), "w",
                      encoding="utf-8") as f:
                for units in segmented[split]:
                    f.write(" ".join(units) + "\n")
        Vocab.build(segmented[splits[0]], min_freq=vocab_min_freq,
                    max_size=vocab_max_size).save(
            os.path.join(out_dir, f"vocab.{lang}.json"))

    for split in splits:
        for name in (f"{split}_features.npy",
                     f"{split}_features.npy.align.json"):
            src = os.path.join(raw_dir, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_dir, name))


def preprocess_toy(data_dir: str, langs: Sequence[str] = ("en", "de"),
                   splits: Sequence[str] = ("train", "val", "test")) -> None:
    """The toy corpus is space-tokenized symbol text already: only its
    vocab files are built, in place, from the train split (no BPE)."""
    for lang in langs:
        with open(os.path.join(data_dir, f"train.{lang}"),
                  encoding="utf-8") as f:
            lines = [ln.split() for ln in f]
        Vocab.build(lines).save(os.path.join(data_dir, f"vocab.{lang}.json"))


def postprocess_hypothesis(units: List[str]) -> str:
    """BPE units -> a plain tokenized line (de-BPE)."""
    return " ".join(remove_bpe(units))
