"""Vocabulary with the special-token layout <pad>=0, <unk>=1, <sos>=2,
<eos>=3 (own copy of the JAX package's ``data/vocab.py``)."""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, Iterable, List, Sequence

from vag_nmt_tpu_torch.core.config import EOS_ID, PAD_ID, SOS_ID, SPECIALS, UNK_ID


class Vocab:
    def __init__(self, itos: List[str]):
        if list(itos[:4]) != list(SPECIALS):
            raise ValueError("specials must lead the vocab")
        self.itos = list(itos)
        self.stoi: Dict[str, int] = {t: i for i, t in enumerate(self.itos)}

    def __len__(self) -> int:
        return len(self.itos)

    @staticmethod
    def build(lines: Iterable[Sequence[str]], min_freq: int = 1,
              max_size: int = 0) -> "Vocab":
        freqs: Counter = Counter()
        for toks in lines:
            freqs.update(toks)
        items = [(t, f) for t, f in freqs.items()
                 if f >= min_freq and t not in SPECIALS]
        items.sort(key=lambda kv: (-kv[1], kv[0]))
        if max_size > 0:
            items = items[: max(0, max_size - len(SPECIALS))]
        return Vocab(list(SPECIALS) + [t for t, _ in items])

    def encode(self, tokens: Sequence[str]) -> List[int]:
        return [self.stoi.get(t, UNK_ID) for t in tokens]

    def decode(self, ids: Sequence[int], strip_special: bool = True) -> List[str]:
        toks = []
        for i in ids:
            i = int(i)
            if strip_special and i in (PAD_ID, SOS_ID, EOS_ID):
                continue
            toks.append(self.itos[i] if 0 <= i < len(self.itos) else "<unk>")
        return toks

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"itos": self.itos}, f, ensure_ascii=False)

    @staticmethod
    def load(path: str) -> "Vocab":
        with open(path) as f:
            return Vocab(json.load(f)["itos"])
