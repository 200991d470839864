"""Fused readout GEMM + log-softmax + beam top-K (counterpart of the JAX
package's ``ops/pallas_readout_topk.py``).

The unfused beam step materializes the (B*K, V) fp32 logits, reads them
for the log-sum-exp, again to build the candidates and again for the
top-K. The kernel (``csrc/readout_topk.cu``) streams the vocab instead and
returns per row only the top-K raw logits with their ids and the row's
log-sum-exp; the live/frozen candidate rules and the K*K -> K cross-beam
combine (``_combine``) run on those small outputs in PyTorch:

    live row:    cand = (scores - lse) + topk_raw_logits
    frozen row:  [(scores, pad_id), (scores + NEG_INF, next smallest ids)]

Its plain version is the JAX ``impl="xla"`` branch: materialize the
logits, floor the banned ids, then ``beam_topk_plain``. Runs at full slot
depth K; the JAX package's shallow-slot watermark mode is a later slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vag_nmt_tpu_torch.core.config import PAD_ID
from vag_nmt_tpu_torch.core.device import check_kernel_arg, resolve_impl
from vag_nmt_tpu_torch.ops import _build
from vag_nmt_tpu_torch.ops.topk import _FLOOR, NEG_INF, beam_topk_plain, stable_topk

# Tiling of the kernel's first pass; csrc/readout_topk.cu is built with it
# (-D defines, see the declare() below), so the split plan cannot disagree.
_ROW_TILE = 32
_COL_TILE = 64
_MAX_K = 8
_TARGET_BLOCKS = 264        # two blocks per SM on the H100's 132 SMs


def ban_mask(ban: torch.Tensor, V: int) -> torch.Tensor:
    """(R, M) banned ids (V = the "no ban" sentinel) -> dense (R, V) uint8
    mask. The sentinel lands in an extra column that is cut off, which is
    how the JAX scatter drops it."""
    R = ban.shape[0]
    mask = torch.zeros((R, V + 1), dtype=torch.uint8, device=ban.device)
    mask.scatter_(1, ban.long(), 1)
    return mask[:, :V].contiguous()


def readout_topk_rows_plain(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            k: int, mask: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the kernel: per-row top-k (values, int32 ids,
    ties to the smaller id) and log-sum-exp of ``t @ w + b`` with banned ids
    floored to -3e38."""
    logits = t @ w + b
    if mask is not None:
        logits = torch.where(mask.bool(), torch.full_like(logits, _FLOOR),
                             logits)
    vals, idx = stable_topk(logits, k)
    return vals, idx.to(torch.int32), torch.logsumexp(logits, dim=-1)


def _split_plan(R: int, V: int) -> Tuple[int, int]:
    """(n_split, split_cols) of the first pass: enough vocab splits to give
    about _TARGET_BLOCKS blocks, each split a whole number of column tiles."""
    n_tiles = -(-V // _COL_TILE)
    row_tiles = -(-R // _ROW_TILE)
    want = min(max(1, -(-_TARGET_BLOCKS // row_tiles)), n_tiles)
    per_split = -(-n_tiles // want)
    return -(-n_tiles // per_split), per_split * _COL_TILE


def readout_topk_rows(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      k: int, mask: Optional[torch.Tensor] = None, *,
                      impl: str = "auto"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(vals (R, k) f32, idx (R, k) int32, lse (R,) f32) of the rows of
    ``t @ w + b``. impl: "auto" (kernel for CUDA tensors, plain for CPU
    tensors), "kernel" or "plain". Each kernel call counts one in
    ``readout_topk_rows.launches`` and its two grids (the vocab splits, then
    their merge) in ``readout_topk_rows.grids``."""
    if resolve_impl(impl, t) == "plain":
        return readout_topk_rows_plain(t, w, b, k, mask)
    R, E = t.shape
    V = w.shape[1]
    if not 1 <= k <= _MAX_K or k > V:
        raise ValueError(f"readout_topk: k={k} outside 1..{min(_MAX_K, V)}")
    check_kernel_arg(t, torch.float32, (R, E), "readout_topk: t")
    check_kernel_arg(w, torch.float32, (E, V), "readout_topk: w")
    check_kernel_arg(b, torch.float32, (V,), "readout_topk: b")
    if mask is not None:
        check_kernel_arg(mask, torch.uint8, (R, V), "readout_topk: mask")
    n_split, split_cols = _split_plan(R, V)
    dev = t.device
    part_v = torch.empty((n_split, R, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_split, R, k), dtype=torch.int32, device=dev)
    part_m = torch.empty((n_split, R), dtype=torch.float32, device=dev)
    part_s = torch.empty((n_split, R), dtype=torch.float32, device=dev)
    vals = torch.empty((R, k), dtype=torch.float32, device=dev)
    idx = torch.empty((R, k), dtype=torch.int32, device=dev)
    lse = torch.empty((R,), dtype=torch.float32, device=dev)
    lib = _build.load("readout_topk")
    rc = lib.readout_topk_launch(
        t.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if mask is None else mask.data_ptr(),
        part_v.data_ptr(), part_i.data_ptr(), part_m.data_ptr(),
        part_s.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr(),
        R, E, V, k, n_split, split_cols,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"readout_topk kernel launch failed: CUDA error {rc}")
    readout_topk_rows.launches += 1
    readout_topk_rows.grids += 2
    return vals, idx, lse


readout_topk_rows.launches = 0
readout_topk_rows.grids = 0

_build.declare("readout_topk", "readout_topk_launch",
               [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
               defines={"VAG_RT": _ROW_TILE, "VAG_CT": _COL_TILE,
                        "VAG_MAX_K": _MAX_K})


def _combine(rvals, ridx, lse, scores, finished, V: int, pad_id: int):
    """Live/frozen candidate rules on the per-row (R, K) raw-logit top-K and
    the K*K -> K cross-beam combine (beam_topk's contract)."""
    B, K = scores.shape
    dev = scores.device
    rvals = rvals.reshape(B, K, K)
    ridx = ridx.reshape(B, K, K).long()
    lse = lse.reshape(B, K)
    base = scores - torch.where(finished, torch.zeros_like(lse), lse)

    live_vals = base[..., None] + rvals
    slot = torch.arange(K, device=dev)
    froz_vals = torch.where(slot == 0, base[..., None], base[..., None] + NEG_INF)
    # Frozen-row candidates as beam_topk sees them: base at pad_id, then
    # base + NEG_INF at the smallest vocab ids != pad_id (tie-break order).
    rest = slot[:-1] + (slot[:-1] >= pad_id).long()
    froz_idx = torch.cat([torch.tensor([pad_id], device=dev), rest])

    fin3 = finished[..., None]
    vals = torch.where(fin3, froz_vals, live_vals)
    idx = torch.where(fin3, froz_idx[None, None, :], ridx)
    flat = (idx + slot[None, :, None] * V).reshape(B, K * K)
    top, pos = stable_topk(vals.reshape(B, K * K), K)
    return top, torch.gather(flat, 1, pos)


def fused_readout_topk(
    t: torch.Tensor,           # (B*K, E) readout activations (beam-major rows)
    w: torch.Tensor,           # (E, V) output matrix
    b: torch.Tensor,           # (V,) fp32 output bias
    scores: torch.Tensor,      # (B, K) fp32 running beam scores
    finished: torch.Tensor,    # (B, K) bool
    ban: Optional[torch.Tensor] = None,  # (B*K, M) banned ids (V = none)
    *,
    pad_id: int = PAD_ID,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K next-beam candidates straight from the readout activations:
    (top_scores (B, K) fp32 descending, flat_idx (B, K) int64, flat =
    beam * V + token), the contract of ``beam_topk`` applied to
    ``t @ w + b``. impl: "auto" (kernel for CUDA tensors, plain for CPU
    tensors), "kernel", "plain", or the JAX names "pallas" / "xla"."""
    B, K = scores.shape
    E, V = w.shape
    R = t.shape[0]
    if R != B * K:
        raise ValueError(f"t rows {R} != B*K = {B * K}")
    scores = scores.to(torch.float32)
    if resolve_impl(impl, t) == "plain":
        logits = t @ w + b
        if ban is not None:
            logits = torch.where(ban_mask(ban, V).bool(),
                                 logits.clamp_max(_FLOOR), logits)
        return beam_topk_plain(logits.reshape(B, K, V), scores, finished,
                               pad_id=pad_id)
    mask = None if ban is None else ban_mask(ban, V)
    rvals, ridx, lse = readout_topk_rows(t.contiguous(), w.contiguous(),
                                         b.contiguous(), K, mask,
                                         impl="kernel")
    return _combine(rvals, ridx, lse, scores, finished, V, pad_id)
