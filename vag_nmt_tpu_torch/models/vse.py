"""Shared visual-text embedding space (counterpart of the JAX package's
``models/vse.py``, decode side):

- image side: pool5 feature -> tanh dense -> L2 norm into the shared space;
- text side: the image embedding queries a Bahdanau attention over the
  encoder states (visual attention grounding); the weighted sum is
  projected and L2-normalized into the same space;
- loss: bidirectional in-batch max-margin ranking on cosine similarity
  (sum of violations, or the hardest negative behind a flag)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from vag_nmt_tpu_torch.core.config import ModelConfig
from vag_nmt_tpu_torch.models.layers import dense, init_dense, l2_normalize
from vag_nmt_tpu_torch.ops.attention import (
    bahdanau_attend,
    init_attention_params,
    precompute_ctx_proj,
)


def init_vse(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "img_proj": init_dense(gen, cfg.img_feat_dim, cfg.shared_dim),
        "ground": init_attention_params(gen, cfg.ctx_dim, cfg.shared_dim,
                                        cfg.attn_dim),
        "txt_proj": init_dense(gen, cfg.ctx_dim, cfg.shared_dim),
    }


def image_embedding(params: Dict[str, Any],
                    img_feat: torch.Tensor) -> torch.Tensor:
    """(B, F) pool5 features -> (B, D) unit-norm shared-space embedding."""
    return l2_normalize(torch.tanh(dense(params["img_proj"], img_feat)))


def ground(
    params: Dict[str, Any],
    img_emb: torch.Tensor,    # (B, D)
    ctx: torch.Tensor,        # (B, T, C)
    src_mask: torch.Tensor,   # (B, T)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Visual attention grounding. Returns (txt_emb (B, D), t_vec (B, C),
    beta (B, T))."""
    ctx_proj = precompute_ctx_proj(params["ground"], ctx)
    t_vec, beta = bahdanau_attend(params["ground"], img_emb.to(ctx.dtype),
                                  ctx, ctx_proj, src_mask)
    txt_emb = l2_normalize(torch.tanh(dense(params["txt_proj"], t_vec)))
    return txt_emb, t_vec, beta


def max_margin_loss(
    img_emb: torch.Tensor,    # (B, D) unit-norm
    txt_emb: torch.Tensor,    # (B, D) unit-norm
    margin: float,
    hard_negatives: bool = False,
    sample_mask: Optional[torch.Tensor] = None,  # (B,) 1 real, 0 batch pad
) -> torch.Tensor:
    """Bidirectional in-batch pairwise ranking loss on cosine similarity.
    Rows with sample_mask == 0 are neither anchors nor negatives."""
    sim = txt_emb @ img_emb.T
    pos = torch.diagonal(sim)
    b = sim.shape[0]
    valid_pair = 1.0 - torch.eye(b, dtype=sim.dtype, device=sim.device)
    n_valid = torch.tensor(float(b), dtype=sim.dtype, device=sim.device)
    if sample_mask is not None:
        sm = sample_mask.to(sim.dtype)
        valid_pair = valid_pair * sm[:, None] * sm[None, :]
        n_valid = sm.sum().clamp_min(1.0)
    # sentence -> wrong images, and image -> wrong sentences
    cost_s = torch.relu(margin + sim - pos[:, None]) * valid_pair
    cost_i = torch.relu(margin + sim - pos[None, :]) * valid_pair
    if hard_negatives:
        return (cost_s.amax(dim=1) + cost_i.amax(dim=0)).sum() / n_valid
    return (cost_s.sum(dim=1) + cost_i.sum(dim=0)).sum() / n_valid
