"""Parameter init and small layer helpers (plain functions over dicts of
tensors). Weights keep the JAX layout ``(in, out)`` and are applied as
``x @ W``. Parameters stay fp32 in bf16 training (a bf16 decode casts
them to bf16 once, ``model.cast_floats``); activations take the dtypes
the JAX package gives them, and its
``jnp.dot(..., preferred_element_type=float32)`` is ``mm``."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from vag_nmt_tpu_torch.parallel.tensor import VocabShard, vocab_embed

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


def embed(params: Params, ids: torch.Tensor,
          vocab: Optional[VocabShard] = None) -> torch.Tensor:
    """The table's rows ``ids``; with a vocab slice (tensor parallelism)
    the table is this rank's slice and the rows come through
    ``parallel/tensor.vocab_embed``."""
    if vocab is not None:
        return vocab_embed(params["table"], ids, vocab)
    return params["table"][ids]


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(x, w, preferred_element_type=float32)``: fp32 out
    whatever the operands' types. A bf16 operand is exact in fp32, so the
    products are those of the bf16 values (fp32 sums); torch.matmul would
    raise on mixed types, and round a bf16 x bf16 result to bf16."""
    return x.to(torch.float32) @ w.to(torch.float32)


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return mm(x, params["w"]) + params["b"]


class RowDraws(NamedTuple):
    """A step's generator under data parallelism: x holds rows [start,
    start + len(x)) of a global batch of ``total`` rows, and each draw is
    made at the global batch's shape, of which x takes its rows. The masks
    are then the single process's, draw for draw."""
    gen: torch.Generator
    start: int
    total: int


def dropout(gen: Union[None, torch.Generator, RowDraws], x: torch.Tensor,
            rate: float, train: bool) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). Identity unless training with a
    generator and rate > 0. The draws come from ``gen`` (on x's device), so
    they differ from the JAX package's threefry bits; a ``RowDraws`` draws
    at the global batch's shape (dim 0 the batch) and takes x's rows."""
    if not train or rate <= 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    if isinstance(gen, RowDraws):
        u = torch.rand((gen.total,) + tuple(x.shape[1:]), generator=gen.gen,
                       device=x.device)[gen.start:gen.start + x.shape[0]]
    else:
        u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # eps inside the rsqrt, as in the JAX package: all-pad filler rows (zero
    # image features) stay finite.
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of (B, T, C) over real tokens per (B, T) mask -> (B, C)."""
    num = torch.einsum("btc,bt->bc", x, mask.to(x.dtype))
    den = mask.sum(-1, keepdim=True).clamp_min(1.0).to(x.dtype)
    return num / den


def compute_dtype(cfg) -> torch.dtype:
    """The activations' dtype of ``ModelConfig.compute_dtype``."""
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: float32 or "
                         "bfloat16")
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
