"""Corpus examples and the source-length bucket rule (own copy of the JAX
package's ``data/batching.py`` pieces that decoding needs)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Example:
    src: List[int]
    tgt: Optional[List[int]] = None         # without sos/eos
    img: Optional[np.ndarray] = None        # (F,) pool5 feature
    index: int = -1                          # corpus line (for output ordering)


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
