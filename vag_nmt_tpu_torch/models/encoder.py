"""Bidirectional GRU text encoder (counterpart of the JAX package's
``models/encoder.py``). Each direction is a masked scan from ``ops/gru.py``;
layers stack on the concatenated (B, T, 2H) outputs, with dropout on the
embeddings and between layers in training."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from vag_nmt_tpu_torch.core.config import ModelConfig
from vag_nmt_tpu_torch.models.layers import (compute_dtype, dropout, embed,
                                             init_embedding)
from vag_nmt_tpu_torch.ops.gru import bidirectional_gru, init_gru_params
from vag_nmt_tpu_torch.parallel.tensor import VocabShard


def init_encoder(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    layers = []
    for i in range(cfg.enc_layers):
        in_dim = cfg.emb_dim if i == 0 else cfg.ctx_dim
        layers.append({
            "fwd": init_gru_params(gen, in_dim, cfg.hidden_dim),
            "bwd": init_gru_params(gen, in_dim, cfg.hidden_dim),
        })
    return {
        "embed": init_embedding(gen, cfg.src_vocab_size, cfg.emb_dim),
        "layers": layers,
    }


def encode(
    params: Dict[str, Any],
    cfg: ModelConfig,
    src: torch.Tensor,        # (B, T) int
    src_mask: torch.Tensor,   # (B, T) float
    *,
    impl: Optional[str] = None,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    vocab: Optional[VocabShard] = None,
) -> torch.Tensor:
    """Returns encoder states ctx (B, T, 2H). impl: the GRU scan's impl
    (None = cfg.gru_impl; see ops/gru.gru_scan). In training (train=True
    with a generator) dropout applies to the embeddings and between
    layers, drawn from ``generator`` in that order. Under
    compute_dtype="bfloat16" the embeddings are cast to bf16 and ctx is
    bf16, as in the JAX package. vocab: the source vocab's slice under
    tensor parallelism (the table is this rank's rows)."""
    impl = cfg.gru_impl if impl is None else impl
    x = embed(params["embed"], src, vocab).to(compute_dtype(cfg))
    x = dropout(generator, x, cfg.dropout, train)
    for i, layer in enumerate(params["layers"]):
        x, _, _ = bidirectional_gru(layer["fwd"], layer["bwd"], x, src_mask,
                                    impl=impl)
        if i + 1 < len(params["layers"]):
            x = dropout(generator, x, cfg.dropout, train)
    return x
