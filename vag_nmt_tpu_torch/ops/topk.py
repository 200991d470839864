"""Beam-search candidate scoring + top-K over materialized logits
(counterpart of the JAX package's ``ops/pallas_topk.py::beam_topk`` and
``ops/topk_legacy.py``): the plain version (its ``impl="xla"`` branch), the
hand-written CUDA kernel ``csrc/beam_topk.cu`` (for its lane-parallel
Pallas kernel, ``impl="pallas_lanes"``) and the two legacy kernels of
``csrc/legacy_topk.cu`` (gens 1 and 2, ``impl="pallas"`` /
``"pallas_rows"``), each legacy kernel with its own plain version.

    cand[b, k, v] = (scores[b,k] - lse[b,k]) + logits[b,k,v]   (live beam)
                    scores[b,k] if v == pad_id else
                    scores[b,k] + NEG_INF                       (finished)

followed by top-K over each sentence's K*V candidates. Ties go to the
smaller flat index, as ``lax.top_k`` does: ``torch.topk`` does not promise
that, so the plain selection is a stable descending sort, sliced.

As in the JAX package, ``lse`` and ``base = scores - lse`` (scores alone
for a finished beam) are computed outside the kernel with the same torch
ops as the plain version, so every candidate is one fp32 add in both and
the kernel's ids and values equal the plain version's exactly.

The legacy kernels keep the TPU kernels' tie orders. Gen 1
(``legacy_topk_blocks``) orders equal candidates by (vocab block of 512,
beam, id), not by flat index; gen 2 (``legacy_topk_rows``) takes a per-row
top-K (ties to the smaller id) and combines the K*K per sentence in
PyTorch, beam-major, which is the flat-index order again."""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

import torch.nn.functional as F

from vag_nmt_tpu_torch.core.config import PAD_ID
from vag_nmt_tpu_torch.core.device import check_kernel_arg, resolve_impl
from vag_nmt_tpu_torch.core.knobs import decode_knobs
from vag_nmt_tpu_torch.ops import _build

NEG_INF = -1e9          # finished-beam filler, matches decode/beam.py
_FLOOR = -3.0e38        # "smaller than any candidate" for masking
MAX_K = 8               # the kernel's register top-K (csrc/beam_topk.cu)
LEGACY_BLOCK = 512      # the legacy TPU kernels' vocab block (their tv)

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


def legacy_topk_blocks_plain(
    logits: torch.Tensor,      # (B, K, V) fp32 raw decoder logits
    scores: torch.Tensor,      # (B, K) fp32 running beam scores
    finished: torch.Tensor,    # (B, K) bool
    *,
    pad_id: int = PAD_ID,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gen 1's plain version: beam_topk's candidates, the K best of each
    sentence by (value desc, v // 512, beam, v), the TPU kernel's
    first-occurrence order; columns of the last partial 512-block floored
    to -3e38. Returns (vals (B, K) fp32, flat ids (B, K) int64)."""
    B, K, V = logits.shape
    nb = -(-V // LEGACY_BLOCK)
    cand = F.pad(candidates(logits, scores, finished, pad_id=pad_id)
                 .reshape(B, K, V), (0, nb * LEGACY_BLOCK - V), value=_FLOOR)
    # (B, K, nb, 512) -> (B, nb, K, 512): position order is the tie order
    keyed = cand.reshape(B, K, nb, LEGACY_BLOCK).transpose(1, 2)
    vals, pos = stable_topk(keyed.reshape(B, -1), K)
    blk, rem = pos // (K * LEGACY_BLOCK), pos % (K * LEGACY_BLOCK)
    v = blk * LEGACY_BLOCK + rem % LEGACY_BLOCK
    return vals, (rem // LEGACY_BLOCK) * V + v


def _rows_combine(rvals: torch.Tensor, ridx: torch.Tensor, B: int, K: int,
                  V: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gen 2's K*K -> K combine: (B*K, K) per-row top-K -> beam_topk's
    contract, beam-major so ties go to the smaller beam, then the smaller
    slot (= the smaller id)."""
    beam = torch.arange(K, device=ridx.device)[None, :, None]
    flat = (ridx.long().reshape(B, K, K) + beam * V).reshape(B, K * K)
    top, pos = stable_topk(rvals.reshape(B, K * K), K)
    return top, torch.gather(flat, 1, pos)


def legacy_topk_rows_plain(
    logits: torch.Tensor,      # (B, K, V) fp32 raw decoder logits
    scores: torch.Tensor,      # (B, K) fp32 running beam scores
    finished: torch.Tensor,    # (B, K) bool
    *,
    pad_id: int = PAD_ID,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gen 2's plain version: each row's top-K candidates (ties to the
    smaller id), then the beam-major K*K -> K combine. Returns (vals (B, K)
    fp32, flat ids (B, K) int64)."""
    B, K, V = logits.shape
    cand = candidates(logits, scores, finished, pad_id=pad_id)
    rvals, ridx = stable_topk(cand.reshape(B * K, V), K)
    return _rows_combine(rvals, ridx, B, K, V)


def _legacy_launch(gen: str, logits, scores, finished, pad_id):
    """Shared argument checks and inputs of the two legacy kernels:
    (library, pointer arguments before the outputs, B, K, V)."""
    B, K, V = logits.shape
    if not 1 <= K <= min(MAX_K, V):
        raise ValueError(f"{gen} kernel: K={K} outside 1..{min(MAX_K, V)}")
    check_kernel_arg(logits, torch.float32, (B, K, V), f"{gen}: logits")
    base = _base(logits, scores, finished).contiguous()
    fin = finished.to(torch.uint8).contiguous()
    check_kernel_arg(fin, torch.uint8, (B, K), f"{gen}: finished")
    return _build.load("legacy_topk"), (logits, base, fin), B, K, V


def legacy_topk_blocks(logits, scores, finished, *, pad_id: int = PAD_ID,
                       impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Gen 1: ``legacy_topk_blocks_plain``'s contract. impl: "auto" (the
    kernel for CUDA tensors, the plain version for CPU tensors), "kernel"
    or "plain". Each kernel call counts one in ``.launches`` and one grid in
    ``.grids``."""
    if resolve_impl(impl, logits) == "plain":
        return legacy_topk_blocks_plain(logits, scores, finished, pad_id=pad_id)
    lib, ins, B, K, V = _legacy_launch("legacy_topk_blocks", logits, scores,
                                       finished, pad_id)
    vals = torch.empty((B, K), dtype=torch.float32, device=logits.device)
    idx = torch.empty((B, K), dtype=torch.int64, device=logits.device)
    rc = lib.legacy_topk_blocks_launch(
        *(x.data_ptr() for x in ins), vals.data_ptr(), idx.data_ptr(),
        B, K, V, pad_id, torch.cuda.current_stream(logits.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"legacy_topk_blocks kernel launch failed: CUDA "
                           f"error {rc}")
    legacy_topk_blocks.launches += 1
    legacy_topk_blocks.grids += 1
    return vals, idx


def legacy_topk_rows(logits, scores, finished, *, pad_id: int = PAD_ID,
                     impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Gen 2: ``legacy_topk_rows_plain``'s contract; the kernel takes the
    per-row top-K and ``_rows_combine`` the rest. impl and counters as
    ``legacy_topk_blocks``."""
    if resolve_impl(impl, logits) == "plain":
        return legacy_topk_rows_plain(logits, scores, finished, pad_id=pad_id)
    lib, ins, B, K, V = _legacy_launch("legacy_topk_rows", logits, scores,
                                       finished, pad_id)
    rvals = torch.empty((B * K, K), dtype=torch.float32, device=logits.device)
    ridx = torch.empty((B * K, K), dtype=torch.int32, device=logits.device)
    rc = lib.legacy_topk_rows_launch(
        *(x.data_ptr() for x in ins), rvals.data_ptr(), ridx.data_ptr(),
        B, K, V, pad_id, torch.cuda.current_stream(logits.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"legacy_topk_rows kernel launch failed: CUDA "
                           f"error {rc}")
    legacy_topk_rows.launches += 1
    legacy_topk_rows.grids += 1
    return _rows_combine(rvals, ridx, B, K, V)


legacy_topk_blocks.launches = legacy_topk_blocks.grids = 0
legacy_topk_rows.launches = legacy_topk_rows.grids = 0

_LEGACY_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
for _fn in ("legacy_topk_blocks_launch", "legacy_topk_rows_launch"):
    _build.declare("legacy_topk", _fn, _LEGACY_ARGTYPES,
                   defines={"VAG_MAX_K": MAX_K})


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
    "kernel" or "plain" (or the JAX names "pallas_lanes" / "xla"), or the
    legacy kernels "pallas" (gen 1, ``legacy_topk_blocks``) and
    "pallas_rows" (gen 2, ``legacy_topk_rows``), which, like "kernel",
    raise on CPU tensors. Each kernel call counts one in
    ``beam_topk.launches`` and one grid in ``beam_topk.grids``."""
    if impl == "auto":
        impl = decode_knobs().topk_impl
    if impl == "pallas":
        return legacy_topk_blocks(logits, scores, finished, pad_id=pad_id,
                                  impl="kernel")
    if impl == "pallas_rows":
        return legacy_topk_rows(logits, scores, finished, pad_id=pad_id,
                                impl="kernel")
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
