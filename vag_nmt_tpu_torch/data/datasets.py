"""The synthetic toy task (own copy of the JAX package's ``toy_vocab`` and
``make_toy_examples``): the target is the reversed source with a fixed token
offset, and the "image" feature is a fixed random projection of the source
bag-of-words."""

from __future__ import annotations

from typing import List

import numpy as np

from vag_nmt_tpu_torch.data.batching import Example
from vag_nmt_tpu_torch.data.vocab import Vocab

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
