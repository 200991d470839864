"""Byte-pair encoding, subword-nmt semantics (own copy of the pure-Python
path of the JAX package's ``data/bpe.py``, which that package names its
semantics oracle; the native fast path is not loaded here).

- learn: iteratively merge the most frequent adjacent symbol pair over a
  word frequency dict (ties: the lexicographically largest pair); word
  symbols are characters with '</w>' appended to the last;
- apply: repeatedly merge the LOWEST-RANK pair present in the word (greedy
  by merge priority, subword-nmt's application rule);
- output: '@@'-continuation convention ('foo' -> 'fo@@ o'), reversed by
  ``remove_bpe``."""

from __future__ import annotations

import heapq
import json
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

END = "</w>"


def _word_symbols(word: str) -> Tuple[str, ...]:
    if not word:
        return ()
    return tuple(word[:-1]) + (word[-1] + END,)


class _RevPair:
    """Heap tie-break: orders pairs reverse-lexicographically, so the lazy
    max-heap pops the lexicographically largest of equally frequent
    pairs."""

    __slots__ = ("p",)

    def __init__(self, p):
        self.p = p

    def __lt__(self, other):
        return self.p > other.p


def learn_bpe(word_freqs: Dict[str, int],
              num_merges: int) -> List[Tuple[str, str]]:
    """Merge operations learned from a word frequency dict, at most
    num_merges, stopping at the first pair seen fewer than twice. Pair
    counts are kept incrementally (each merge touches only the word types
    holding the merged pair) under a lazy max-heap whose stale entries are
    skipped, as the JAX package's ``learn_bpe``."""
    words: List[List[str]] = []
    freqs: List[int] = []
    for w, f in word_freqs.items():
        if w:
            words.append(list(_word_symbols(w)))
            freqs.append(f)

    pair_counts: Counter = Counter()
    pair_words = defaultdict(set)            # pair -> word indices (lazy)
    for idx, syms in enumerate(words):
        for a, b in zip(syms, syms[1:]):
            pair_counts[(a, b)] += freqs[idx]
            pair_words[(a, b)].add(idx)

    heap = [(-c, _RevPair(p), p) for p, c in pair_counts.items()]
    heapq.heapify(heap)

    def push(p):
        heapq.heappush(heap, (-pair_counts[p], _RevPair(p), p))

    merges: List[Tuple[str, str]] = []
    while len(merges) < num_merges and heap:
        negc, _, best = heapq.heappop(heap)
        cur = pair_counts.get(best, 0)
        if -negc != cur:                      # stale heap entry
            if cur > 0:
                push(best)
            continue
        if cur < 2:
            break
        merges.append(best)
        merged = best[0] + best[1]
        touched = set()
        for idx in pair_words.pop(best, ()):
            syms = words[idx]
            f = freqs[idx]
            if not any(a == best[0] and b == best[1]
                       for a, b in zip(syms, syms[1:])):
                continue                      # stale index
            for a, b in zip(syms, syms[1:]):
                pair_counts[(a, b)] -= f
            out: List[str] = []
            i = 0
            while i < len(syms):
                if (i + 1 < len(syms) and syms[i] == best[0]
                        and syms[i + 1] == best[1]):
                    out.append(merged)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            words[idx] = out
            for a, b in zip(out, out[1:]):
                pair_counts[(a, b)] += f
                pair_words[(a, b)].add(idx)
                touched.add((a, b))
            for a, b in zip(syms, syms[1:]):
                touched.add((a, b))
        pair_counts.pop(best, None)
        touched.discard(best)
        for p in touched:
            if pair_counts.get(p, 0) <= 0:
                pair_counts.pop(p, None)
                pair_words.pop(p, None)
            else:
                push(p)                        # lazy: stale entries skipped
    return merges


def learn_bpe_from_lines(lines: Iterable[Sequence[str]],
                         num_merges: int) -> List[Tuple[str, str]]:
    """learn_bpe on the word counts of pre-tokenized lines (lists of
    tokens)."""
    freqs: Counter = Counter()
    for toks in lines:
        freqs.update(toks)
    return learn_bpe(dict(freqs), num_merges)


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

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"merges": self.merges}, f)

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
