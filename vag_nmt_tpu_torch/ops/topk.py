"""Beam-search candidate scoring + top-K over materialized logits
(counterpart of the plain ``impl="xla"`` branch of the JAX package's
``ops/pallas_topk.py::beam_topk``; the lane-parallel top-K kernel is a
later slice).

    cand[b, k, v] = (scores[b,k] - lse[b,k]) + logits[b,k,v]   (live beam)
                    scores[b,k] if v == pad_id else
                    scores[b,k] + NEG_INF                       (finished)

followed by top-K over each sentence's K*V candidates. Ties go to the
smaller flat index, as ``lax.top_k`` does: ``torch.topk`` does not promise
that, so the selection is a stable descending sort, sliced."""

from __future__ import annotations

from typing import Tuple

import torch

from vag_nmt_tpu_torch.core.config import PAD_ID

NEG_INF = -1e9          # finished-beam filler, matches decode/beam.py
_FLOOR = -3.0e38        # "smaller than any candidate" for masking


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, ties to the smaller index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_topk(
    logits: torch.Tensor,      # (B, K, V) fp32 raw decoder logits
    scores: torch.Tensor,      # (B, K) fp32 running beam scores
    finished: torch.Tensor,    # (B, K) bool
    *,
    pad_id: int = PAD_ID,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (top_scores (B, K) fp32 descending, flat_idx (B, K) int64
    with flat = beam * V + token)."""
    B, K, V = logits.shape
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    base = scores.to(torch.float32) - torch.where(
        finished, torch.zeros_like(lse), lse)
    # The candidate formula in this order, (scores - lse) + logits, as the
    # JAX package writes it (not scores + (logits - lse)).
    live = base[..., None] + logits
    vr = torch.arange(V, device=logits.device)
    froz = torch.where(vr == pad_id, base[..., None], base[..., None] + NEG_INF)
    cand = torch.where(finished[..., None], froz, live).reshape(B, K * V)
    return stable_topk(cand, K)
