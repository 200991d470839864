"""Parameter init and small layer helpers (plain functions over dicts of
tensors). Weights keep the JAX layout ``(in, out)`` and are applied as
``x @ W``."""

from __future__ import annotations

import math
from typing import Dict, Tuple

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


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # eps inside the rsqrt, as in the JAX package: all-pad filler rows (zero
    # image features) stay finite.
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of (B, T, C) over real tokens per (B, T) mask -> (B, C)."""
    num = torch.einsum("btc,bt->bc", x, mask.to(x.dtype))
    den = mask.sum(-1, keepdim=True).clamp_min(1.0).to(x.dtype)
    return num / den
