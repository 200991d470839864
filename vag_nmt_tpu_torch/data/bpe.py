"""BPE post-processing (own copy of ``remove_bpe`` from the JAX package's
``data/bpe.py``)."""

from __future__ import annotations

from typing import List, Sequence


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
