"""Host-side tokenization (own copy of the JAX package's
``data/tokenizer.py``): a pure-Python Moses-lite tokenizer that lowercases,
splits words from punctuation and keeps intra-word apostrophes/hyphens
together. Exact Moses parity is not claimed (``data/moses.py`` has that);
what matters is that training and serving text pass through the same
tokenizer."""

from __future__ import annotations

import re
from typing import List

# words (incl. internal ' and -), numbers, or single punctuation marks
_TOKEN_RE = re.compile(r"[\w]+(?:['\-][\w]+)*|[^\w\s]", re.UNICODE)


def tokenize(line: str, lower: bool = True) -> List[str]:
    if lower:
        line = line.lower()
    return _TOKEN_RE.findall(line)


def detokenize(tokens: List[str]) -> str:
    """Inverse-ish of tokenize for display: attach punctuation to the left."""
    out = ""
    for tok in tokens:
        if out and (re.match(r"[^\w]", tok) and tok not in "([{«"):
            out += tok
        else:
            out += (" " if out else "") + tok
    return out
