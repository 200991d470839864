"""Masked Bahdanau (MLP) attention over encoder states (counterpart of the
JAX package's ``ops/attention.py``). The context-side projection
``ctx @ wa`` is computed once per sentence (``precompute_ctx_proj``), so
each decode step does only the query projection, the tanh energies and the
(N, T) reduction."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vag_nmt_tpu_torch.models.layers import glorot_uniform, mm

Params = Dict[str, torch.Tensor]

NEG_INF = -1e9


def init_attention_params(gen: torch.Generator, ctx_dim: int, query_dim: int,
                          attn_dim: int) -> Params:
    return {
        "wa": glorot_uniform(gen, (ctx_dim, attn_dim)),
        "ua": glorot_uniform(gen, (query_dim, attn_dim)),
        "ba": torch.zeros((attn_dim,), dtype=torch.float32),
        "va": glorot_uniform(gen, (attn_dim, 1))[:, 0].contiguous(),
    }


def precompute_ctx_proj(params: Params, ctx: torch.Tensor) -> torch.Tensor:
    """(N, T, C) -> (N, T, A), fp32 whatever ctx's dtype."""
    return mm(ctx, params["wa"])


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with a 0/1 mask (pads get exactly 0)."""
    scores = torch.where(mask > 0, scores, torch.full_like(scores, NEG_INF))
    return torch.softmax(scores, dim=-1)


def bahdanau_attend(
    params: Params,
    query: torch.Tensor,      # (N, Q)
    ctx: torch.Tensor,        # (N, T, C)
    ctx_proj: torch.Tensor,   # (N, T, A)
    mask: torch.Tensor,       # (N, T)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (context vector (N, C) in ctx's dtype, weights (N, T))."""
    q = mm(query, params["ua"])
    e = torch.tanh(ctx_proj + q[:, None, :] + params["ba"])
    w = masked_softmax(mm(e, params["va"]), mask)
    c = torch.einsum("nt,ntc->nc", w.to(ctx.dtype), ctx)
    return c, w


def bahdanau_attend_beams(
    params: Params,
    query: torch.Tensor,      # (B, K, Q), K beams per sentence
    ctx: torch.Tensor,        # (B, T, C), not tiled across beams
    ctx_proj: torch.Tensor,   # (B, T, A)
    mask: torch.Tensor,       # (B, T)
    *,
    bf16_energies: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-batched attention sharing the encoder state across beams:
    broadcasting over a beam axis reads ctx/ctx_proj once per sentence.
    Returns ((B, K, C), (B, K, T))."""
    return bahdanau_attend_beams_q(params, mm(query, params["ua"]), ctx,
                                   ctx_proj, mask, bf16_energies=bf16_energies)


def bahdanau_attend_beams_q(
    params: Params,
    q: torch.Tensor,          # (B, K, A) pre-projected query (query @ ua)
    ctx: torch.Tensor,        # (B, T, C)
    ctx_proj: torch.Tensor,   # (B, T, A)
    mask: torch.Tensor,       # (B, T)
    *,
    bf16_energies: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bahdanau_attend_beams`` with the query projection already applied.
    With bf16_energies (None: under a bf16 ``ctx``) the (B, K, T, A)
    energies are bf16 (the sum of ctx_proj, q and ba in bf16, then tanh)
    and the scores their product with va summed in fp32, as the JAX
    package; else fp32. A decode resolves it once a call from the compute
    dtype and ``VAG_ATTN_E_DTYPE`` (``models.model.decode_opts``)."""
    if bf16_energies is None:
        bf16_energies = ctx.dtype == torch.bfloat16
    if bf16_energies:
        bf = torch.bfloat16
        e = torch.tanh(ctx_proj.to(bf)[:, None, :, :] + q.to(bf)[:, :, None, :]
                       + params["ba"].to(bf))
        scores = mm(e, params["va"].to(bf))
    else:
        e = torch.tanh(ctx_proj[:, None, :, :] + q[:, :, None, :]
                       + params["ba"])
        scores = mm(e, params["va"])
    w = masked_softmax(scores, mask[:, None, :])
    c = torch.einsum("bkt,btc->bkc", w.to(ctx.dtype), ctx)
    return c, w
