"""Corpus BLEU with multi-bleu.perl semantics (own copy of the JAX package's
``evaluation/bleu.py``). The details that decide parity with the script:

- tokenization is whatever whitespace split gives — no re-tokenization;
- modified n-gram precision with per-sentence clipping, n = 1..4;
- NO smoothing: any zero n-gram match count gives BLEU = 0 (multi-bleu prints
  0 because exp(log 0) underflows in its formula);
- brevity penalty uses, per sentence, the reference length CLOSEST to the
  hypothesis length (ties -> the shorter one) summed over the corpus —
  multi-bleu's multi-reference rule, degenerating to plain ref length for a
  single reference.
"""

from __future__ import annotations

from collections import Counter
from typing import List, NamedTuple, Sequence, Union

import math

Lines = Sequence[str]


class BleuResult(NamedTuple):
    bleu: float              # percentage, e.g. 31.62
    precisions: List[float]
    brevity_penalty: float
    hyp_len: int
    ref_len: int

    def __str__(self) -> str:
        p = "/".join(f"{100 * x:.1f}" for x in self.precisions)
        return (f"BLEU = {self.bleu:.2f}, {p} "
                f"(BP={self.brevity_penalty:.3f}, hyp_len={self.hyp_len}, "
                f"ref_len={self.ref_len})")


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    hypotheses: Lines,
    references: Union[Lines, Sequence[Lines]],
    max_n: int = 4,
) -> BleuResult:
    """references: one list of lines, or a list of such lists (multi-ref)."""
    if references and isinstance(references[0], str):
        ref_sets = [references]
    else:
        ref_sets = list(references)
    if not ref_sets and hypotheses:
        # an empty reference list would otherwise slip past the per-set
        # length check and crash later in an opaque min() (review finding)
        raise ValueError("hypothesis/reference line-count mismatch")
    for rs in ref_sets:
        if len(rs) != len(hypotheses):
            raise ValueError("hypothesis/reference line-count mismatch")

    correct = [0] * max_n
    total = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for i, hyp in enumerate(hypotheses):
        h = hyp.split()
        refs = [rs[i].split() for rs in ref_sets]
        hyp_len += len(h)
        # closest ref length; ties -> shorter
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hc = _ngrams(h, n)
            if not hc:
                continue
            max_ref: Counter = Counter()
            for r in refs:
                rc = _ngrams(r, n)
                for g, c in rc.items():
                    if c > max_ref[g]:
                        max_ref[g] = c
            total[n - 1] += sum(hc.values())
            correct[n - 1] += sum(min(c, max_ref[g]) for g, c in hc.items())

    precisions = [(correct[k] / total[k]) if total[k] > 0 else 0.0
                  for k in range(max_n)]
    if hyp_len == 0 or any(c == 0 for c in correct):
        bp = (math.exp(1.0 - ref_len / hyp_len)
              if 0 < hyp_len < ref_len else 1.0)
        return BleuResult(0.0, precisions, bp, hyp_len, ref_len)
    log_p = sum(math.log(p) for p in precisions) / max_n
    bp = math.exp(1.0 - ref_len / hyp_len) if hyp_len < ref_len else 1.0
    return BleuResult(100.0 * bp * math.exp(log_p), precisions, bp,
                      hyp_len, ref_len)
