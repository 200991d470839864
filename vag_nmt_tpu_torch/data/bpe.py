"""Byte-pair encoding, subword-nmt semantics (own copy of the pure-Python
path of the JAX package's ``data/bpe.py``, which that package names its
semantics oracle; the native fast path is not loaded here).

- apply: repeatedly merge the LOWEST-RANK pair present in the word (greedy
  by merge priority, subword-nmt's application rule); word symbols are
  characters with '</w>' appended to the last;
- output: '@@'-continuation convention ('foo' -> 'fo@@ o'), reversed by
  ``remove_bpe``."""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

END = "</w>"


def _word_symbols(word: str) -> Tuple[str, ...]:
    if not word:
        return ()
    return tuple(word[:-1]) + (word[-1] + END,)


class BPE:
    """Apply learned merges to tokens/lines, with a per-word cache."""

    def __init__(self, merges: Sequence[Tuple[str, str]]):
        self.merges = [tuple(m) for m in merges]
        self.ranks = {tuple(m): i for i, m in enumerate(self.merges)}
        self._cache: Dict[str, Tuple[str, ...]] = {}

    def encode_line(self, line: str) -> List[str]:
        """Whitespace-tokenized line -> BPE units."""
        return self.encode_tokens(line.split())

    def segment_word(self, word: str) -> Tuple[str, ...]:
        if word in self._cache:
            return self._cache[word]
        syms = list(_word_symbols(word))
        while len(syms) > 1:
            # lowest-rank pair present
            best_rank, best_i = None, -1
            for i in range(len(syms) - 1):
                r = self.ranks.get((syms[i], syms[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            pair = (syms[best_i], syms[best_i + 1])
            merged = pair[0] + pair[1]
            # merge ALL occurrences of this pair (subword-nmt rule)
            out, i = [], 0
            while i < len(syms):
                if (i + 1 < len(syms) and syms[i] == pair[0]
                        and syms[i + 1] == pair[1]):
                    out.append(merged)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            syms = out
        units = []
        for s in syms:
            if s.endswith(END):
                units.append(s[: -len(END)])
            else:
                units.append(s + "@@")
        units = tuple(u for u in units if u)  # drop empty from bare '</w>'
        self._cache[word] = units
        return units

    def encode_tokens(self, tokens: Sequence[str]) -> List[str]:
        out: List[str] = []
        for t in tokens:
            out.extend(self.segment_word(t))
        return out

    @staticmethod
    def load(path: str) -> "BPE":
        with open(path) as f:
            return BPE([tuple(m) for m in json.load(f)["merges"]])


def remove_bpe(tokens: Sequence[str]) -> List[str]:
    """Merge '@@'-continued units back into words."""
    out: List[str] = []
    buf = ""
    for t in tokens:
        if t.endswith("@@"):
            buf += t[:-2]
        else:
            out.append(buf + t)
            buf = ""
    if buf:
        out.append(buf)
    return out
