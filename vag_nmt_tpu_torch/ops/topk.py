"""Beam-search candidate scoring + top-K over materialized logits
(counterpart of the JAX package's ``ops/pallas_topk.py::beam_topk``): the
plain version (its ``impl="xla"`` branch) and the hand-written CUDA
kernel ``csrc/beam_topk.cu`` (for its lane-parallel Pallas kernel,
``impl="pallas_lanes"``).

    cand[b, k, v] = (scores[b,k] - lse[b,k]) + logits[b,k,v]   (live beam)
                    scores[b,k] if v == pad_id else
                    scores[b,k] + NEG_INF                       (finished)

followed by top-K over each sentence's K*V candidates. Ties go to the
smaller flat index, as ``lax.top_k`` does: ``torch.topk`` does not promise
that, so the plain selection is a stable descending sort, sliced.

As in the JAX package, ``lse`` and ``base = scores - lse`` (scores alone
for a finished beam) are computed outside the kernel with the same torch
ops as the plain version, so every candidate is one fp32 add in both and
the kernel's ids and values equal the plain version's exactly."""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vag_nmt_tpu_torch.core.config import PAD_ID
from vag_nmt_tpu_torch.core.device import check_kernel_arg, resolve_impl
from vag_nmt_tpu_torch.core.knobs import decode_knobs
from vag_nmt_tpu_torch.ops import _build

NEG_INF = -1e9          # finished-beam filler, matches decode/beam.py
_FLOOR = -3.0e38        # "smaller than any candidate" for masking
MAX_K = 8               # the kernel's register top-K (csrc/beam_topk.cu)

# VAG_TOPK_IMPL values -> the port's impl names
_KNOB_IMPL = {"auto": "auto", "xla": "plain", "pallas_lanes": "kernel"}


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, ties to the smaller index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _base(logits: torch.Tensor, scores: torch.Tensor,
          finished: torch.Tensor) -> torch.Tensor:
    """(B, K) candidate base: scores - lse for live beams, scores for
    finished ones."""
    lse = torch.logsumexp(logits, dim=-1)
    return scores.to(torch.float32) - torch.where(
        finished, torch.zeros_like(lse), lse)


def candidates(logits: torch.Tensor, scores: torch.Tensor,
               finished: torch.Tensor, *, pad_id: int = PAD_ID) -> torch.Tensor:
    """The (B, K * V) candidate scores of the module docstring."""
    B, K, V = logits.shape
    logits = logits.to(torch.float32)
    base = _base(logits, scores, finished)
    # The candidate formula in this order, (scores - lse) + logits, as the
    # JAX package writes it (not scores + (logits - lse)).
    live = base[..., None] + logits
    vr = torch.arange(V, device=logits.device)
    froz = torch.where(vr == pad_id, base[..., None], base[..., None] + NEG_INF)
    return torch.where(finished[..., None], froz, live).reshape(B, K * V)


def beam_topk_plain(
    logits: torch.Tensor,      # (B, K, V) fp32 raw decoder logits
    scores: torch.Tensor,      # (B, K) fp32 running beam scores
    finished: torch.Tensor,    # (B, K) bool
    *,
    pad_id: int = PAD_ID,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: returns (top_scores (B, K) fp32 descending,
    flat_idx (B, K) int64 with flat = beam * V + token)."""
    cand = candidates(logits, scores, finished, pad_id=pad_id)
    return stable_topk(cand, logits.shape[1])


def beam_topk(
    logits: torch.Tensor,      # (B, K, V) fp32 raw decoder logits
    scores: torch.Tensor,      # (B, K) fp32 running beam scores
    finished: torch.Tensor,    # (B, K) bool
    *,
    pad_id: int = PAD_ID,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``beam_topk_plain``'s contract. impl: "auto" (VAG_TOPK_IMPL, else
    the kernel for CUDA tensors and the plain version for CPU tensors),
    "kernel" or "plain" (or the JAX names "pallas_lanes" / "xla"). Each
    kernel call counts one in ``beam_topk.launches`` and one grid in
    ``beam_topk.grids``."""
    if impl == "auto":
        impl = decode_knobs().topk_impl
    if impl in ("pallas", "pallas_rows"):
        raise NotImplementedError(
            f"VAG_TOPK_IMPL={impl} (the bench-only top-K kernels of "
            "ops/topk_legacy.py) is a later slice of the PyTorch port, with "
            "its bench harness")
    impl = _KNOB_IMPL.get(impl, impl)
    if resolve_impl(impl, logits) == "plain":
        return beam_topk_plain(logits, scores, finished, pad_id=pad_id)
    B, K, V = logits.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"beam_topk kernel: K={K} outside 1..{MAX_K}")
    check_kernel_arg(logits, torch.float32, (B, K, V), "beam_topk: logits")
    base = _base(logits, scores, finished).contiguous()
    fin = finished.to(torch.uint8).contiguous()
    check_kernel_arg(fin, torch.uint8, (B, K), "beam_topk: finished")
    dev = logits.device
    vals = torch.empty((B, K), dtype=torch.float32, device=dev)
    idx = torch.empty((B, K), dtype=torch.int64, device=dev)
    lib = _build.load("beam_topk")
    rc = lib.beam_topk_launch(logits.data_ptr(), base.data_ptr(),
                              fin.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                              B, K, V, pad_id,
                              torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"beam_topk kernel launch failed: CUDA error {rc}")
    beam_topk.launches += 1
    beam_topk.grids += 1
    return vals, idx


beam_topk.launches = 0
beam_topk.grids = 0

_build.declare("beam_topk", "beam_topk_launch",
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
               defines={"VAG_MAX_K": MAX_K})
