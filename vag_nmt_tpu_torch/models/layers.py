"""Parameter init and small layer helpers (plain functions over dicts of
tensors). Weights keep the JAX layout ``(in, out)`` and are applied as
``x @ W``."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


def glorot_uniform(gen: torch.Generator, shape: Tuple[int, int]) -> torch.Tensor:
    """Glorot/Xavier uniform on an (in, out) matrix, as
    jax.nn.initializers.glorot_uniform: U(-l, l), l = sqrt(6 / (in + out))."""
    lim = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * lim


def orthogonal(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, n) orthogonal matrix: QR of a normal draw with the sign fix that
    makes the distribution uniform (Haar), as jax.nn.initializers.orthogonal."""
    a = torch.randn((n, n), generator=gen, dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))[None, :]


def init_embedding(gen: torch.Generator, vocab: int, dim: int) -> Params:
    return {"table": dim ** -0.5 * torch.randn((vocab, dim), generator=gen,
                                               dtype=torch.float32)}


def init_dense(gen: torch.Generator, in_dim: int, out_dim: int) -> Params:
    return {"w": glorot_uniform(gen, (in_dim, out_dim)),
            "b": torch.zeros((out_dim,), dtype=torch.float32)}


def embed(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def dropout(gen: Optional[torch.Generator], x: torch.Tensor, rate: float,
            train: bool) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). Identity unless training with a
    generator and rate > 0. The draws come from ``gen`` (on x's device), so
    they differ from the JAX package's threefry bits."""
    if not train or rate <= 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # eps inside the rsqrt, as in the JAX package: all-pad filler rows (zero
    # image features) stay finite.
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of (B, T, C) over real tokens per (B, T) mask -> (B, C)."""
    num = torch.einsum("btc,bt->bc", x, mask.to(x.dtype))
    den = mask.sum(-1, keepdim=True).clamp_min(1.0).to(x.dtype)
    return num / den
