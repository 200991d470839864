"""Image <-> text retrieval R@K on the shared embedding space (own copy of
the JAX package's ``evaluation/retrieval.py``), the evaluation of the
``m30k_scaled`` preset."""

from __future__ import annotations

from typing import Dict

import numpy as np


def retrieval_recall(img_emb: np.ndarray, txt_emb: np.ndarray,
                     ks=(1, 5, 10)) -> Dict[str, float]:
    """img_emb / txt_emb: (N, D), row i a matched pair. Returns R@K in both
    directions (``t2i_r@K``, ``i2t_r@K``) and the median rank (1-based,
    ``*_medr``)."""
    img = np.asarray(img_emb, np.float32)
    txt = np.asarray(txt_emb, np.float32)
    sim = txt @ img.T                     # (N, N): sentence x image
    n = sim.shape[0]
    out: Dict[str, float] = {}
    for name, s in (("t2i", sim), ("i2t", sim.T)):
        order = np.argsort(-s, axis=1)    # the true match's 0-based rank
        ranks = np.argmax(order == np.arange(n)[:, None], axis=1)
        for k in ks:
            out[f"{name}_r@{k}"] = float((ranks < k).mean())
        out[f"{name}_medr"] = float(np.median(ranks) + 1)
    return out
