"""Precomputed image-feature loading (own copy of the JAX package's
``data/features.py``).

The features' row order must match the corpus line order. The loader
checks it: the row count must equal the corpus line count, and where the
extraction wrote a ``<file>.align.json`` sidecar, the corpus's checksum
must equal the one recorded there."""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np


def corpus_checksum(lines) -> str:
    """sha256 over the lines, each followed by a newline."""
    h = hashlib.sha256()
    for ln in lines:
        h.update(ln.encode("utf-8"))
        h.update(b"\n")
    return h.hexdigest()


def save_features(path: str, feats: np.ndarray,
                  corpus_lines: Optional[list] = None) -> None:
    """np.save the (N, F) features; with ``corpus_lines``, also the
    ``.align.json`` sidecar (row count and corpus checksum) next to the
    file written (np.save appends ".npy" where it is missing)."""
    np.save(path, feats)
    if not path.endswith(".npy"):
        path = path + ".npy"
    if corpus_lines is not None:
        with open(path + ".align.json", "w") as f:
            json.dump({"rows": int(feats.shape[0]),
                       "corpus_sha256": corpus_checksum(corpus_lines)}, f)


def load_features(path: str, expected_rows: Optional[int] = None,
                  corpus_lines: Optional[list] = None) -> np.ndarray:
    """The (N, F) features, memory-mapped; raises ValueError when the row
    count differs from ``expected_rows`` or the sidecar's checksum from
    ``corpus_lines``'."""
    feats = np.load(path, mmap_mode="r")
    if expected_rows is not None and feats.shape[0] != expected_rows:
        raise ValueError(
            f"feature matrix {path} has {feats.shape[0]} rows, corpus has "
            f"{expected_rows} lines: misaligned features corrupt the "
            f"grounding; re-extract.")
    sidecar = path + ".align.json"
    if corpus_lines is not None and os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
        if meta.get("corpus_sha256") not in (None, corpus_checksum(corpus_lines)):
            raise ValueError(
                f"feature alignment checksum mismatch for {path}: features "
                f"were extracted against a different corpus ordering.")
    return feats
