"""Fused readout GEMM + log-softmax + beam top-K (counterpart of the JAX
package's ``ops/pallas_readout_topk.py``).

The unfused beam step materializes the (B*K, V) fp32 logits, reads them
for the log-sum-exp, again to build the candidates and again for the
top-K. The kernel (``csrc/readout_topk.cu``; on bf16 operands
``csrc/readout_topk_bf16.cu``) streams the vocab instead and
returns per row only the top-K raw logits with their ids and the row's
log-sum-exp; the live/frozen candidate rules and the K*K -> K cross-beam
combine (``_combine``) run on those small outputs in PyTorch:

    live row:    cand = (scores - lse) + topk_raw_logits
    frozen row:  [(scores, pad_id), (scores + NEG_INF, next smallest ids)]

Its plain version at full slot depth K is the JAX ``impl="xla"`` branch:
materialize the logits, floor the banned ids, then ``beam_topk_plain``.

Shallow slots (``slots`` / ``VAG_FRT_SLOTS`` below K), the JAX package's
watermark mode: each lane of the kernel keeps only ``sk`` slots and a
watermark, the largest value it pushed out of them; a row is flagged
(``viol``) when some lane's watermark reaches the row's provisional K-th
value, and only a flagged row may differ from depth K. A lane is the
kernel's own partition (``kernel_lanes``: a thread's 4 columns of every
64 columns of its vocab split), not the TPU's ``id % 128``; the plain
version takes the lane map as an argument, so it models either. Recovery,
as in the JAX package: per step (flagged live rows recomputed at depth K
on the device, no host read), or deferred (the live-row flag returned for
the beam loop to OR over a chunk and rerun the chunk at depth K), or none
(``VAG_FRT_NOCOND=1``, not exact).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vag_nmt_tpu_torch.core.config import PAD_ID
from vag_nmt_tpu_torch.core.device import check_kernel_arg, resolve_impl
from vag_nmt_tpu_torch.core.knobs import decode_knobs, over
from vag_nmt_tpu_torch.models.layers import mm
from vag_nmt_tpu_torch.ops import _build
from vag_nmt_tpu_torch.ops.topk import (_FLOOR, MAX_K, NEG_INF,
                                        _arrival_counters, beam_topk_plain,
                                        declare_instances, instance, k_plan,
                                        stable_topk)
from vag_nmt_tpu_torch.parallel.tensor import VocabShard

# Tiling of the kernel; csrc/readout_topk.cu is built with it (-D defines,
# see the declare() below), so the split plan and the lane map cannot
# disagree with it. 64-row tiles read W from L2 ten times at R=640 (32-row
# tiles: twenty); 128-row tiles would hold twice the lane states and
# accumulators a thread, past the 128 registers of 512 threads.
_ROW_TILE = 64
_COL_TILE = 128             # columns of an output tile; splits are whole tiles
_DEPTH_CHUNK = 64           # depth of a staged chunk of t and W
_LANE_PERIOD = 64           # a lane holds _LANE_COLS columns of every 64
_LANE_COLS = 4
_TARGET_BLOCKS = 132        # one block per SM on the H100's 132 SMs
# Kernel 1b (csrc/readout_topk_bf16.cu) keeps the grid, the tiles and the
# lane map above. Its own: 64-deep TMA boxes of bf16 (one 128-byte row), a
# ring of _BF16_STAGES stages of one 64-column W box each (a column tile's
# two halves in turn; each stage with a box of t where t's row tile is too
# deep to stay resident), two logits buffers of _ROW_TILE x (_COL_TILE + 4)
# floats.
_BF16_BOX = 64
_BF16_STAGES = 8
_SMEM_LIMIT = 232448        # bytes of shared memory a block may use


def _bf16_block_bytes(kc: int, resident: bool) -> int:
    """Shared memory of kernel 1b's CTA at kc boxes of depth: its layout
    (t's row tile if resident, the ring, the logits buffers, 2 * stages + 5
    barriers and a flag) with the 1024 bytes of slack its alignment
    takes."""
    box = _BF16_BOX * _BF16_BOX * 2                   # 64 x 64 bf16
    stage = box + (0 if resident else box)
    logits = (kc * box if resident else 0) + _BF16_STAGES * stage
    bars = logits + 2 * _ROW_TILE * (_COL_TILE + 4) * 4
    return bars + (2 * _BF16_STAGES + 5) * 8 + 16 + 1024


# The deepest row tile of t (in boxes) that stays resident: passed to the
# build (VAG_RESIDENT_KC), whose static_asserts hold it to the kernel's own
# layout, so the decision is made here alone.
_BF16_RESIDENT_BOXES = max(kc for kc in range(1, 64)
                           if _bf16_block_bytes(kc, True) <= _SMEM_LIMIT)


def bf16_smem(E: int) -> Tuple[bool, int]:
    """(t resident, bytes of shared memory) of kernel 1b's CTA at depth E."""
    kc = -(-E // _BF16_BOX)
    resident = kc <= _BF16_RESIDENT_BOXES
    return resident, _bf16_block_bytes(kc, resident)


def ban_mask(ban: torch.Tensor, V: int) -> torch.Tensor:
    """(R, M) banned ids (V = the "no ban" sentinel) -> dense (R, V) uint8
    mask. The sentinel lands in an extra column that is cut off, which is
    how the JAX scatter drops it. A negative id (ngram_ban's window past
    the token buffer, which only a frozen row riding past max_len reaches)
    is dropped too: a frozen row's logits are not used."""
    R = ban.shape[0]
    mask = torch.zeros((R, V + 1), dtype=torch.uint8, device=ban.device)
    mask.scatter_(1, torch.where(ban < 0, V, ban.long()), 1)
    return mask[:, :V].contiguous()


def _split_plan(R: int, V: int) -> Tuple[int, int]:
    """(n_split, split_cols): enough vocab splits to give at most
    _TARGET_BLOCKS blocks (one wave), each split a whole number of column
    tiles and none empty."""
    n_tiles = -(-V // _COL_TILE)
    row_tiles = -(-R // _ROW_TILE)
    want = min(max(1, _TARGET_BLOCKS // row_tiles), n_tiles)
    per_split = -(-n_tiles // want)
    return -(-n_tiles // per_split), per_split * _COL_TILE


def kernel_lanes(R: int, V: int) -> torch.Tensor:
    """(V,) int64: the lane of each vocab id in the CUDA kernel at R rows,
    (its vocab split, its column group of 4 within each 64 columns)."""
    _, split_cols = _split_plan(R, V)
    col = torch.arange(V)
    per_split = _LANE_PERIOD // _LANE_COLS
    return (col // split_cols) * per_split + (col % _LANE_PERIOD) // _LANE_COLS


def _shallow(logits: torch.Tensor, k: int, sk: int, lanes: torch.Tensor):
    """The watermark mode on materialized (R, V) logits: each lane keeps its
    top-sk by (value desc, smaller id); returns the union's top-k (vals,
    ids) and viol (R,) int32 = (max over lanes of the (sk+1)-th best value,
    -3e38 where no lane has one) >= the union's k-th value."""
    R, V = logits.shape
    lanes = lanes.to(logits.device)
    order = stable_topk(logits, V)[1]                      # value desc, id asc
    by_lane = torch.sort(lanes[order], dim=1, stable=True)
    pos = torch.gather(order, 1, by_lane.indices)          # lane-major order
    starts = torch.cumsum(torch.bincount(lanes), 0) - torch.bincount(lanes)
    rank = torch.arange(V, device=logits.device) - starts[by_lane.values]
    vals = torch.gather(logits, 1, pos)
    neg_inf = torch.full_like(vals, float("-inf"))
    kept = torch.zeros_like(logits).scatter_(1, pos, torch.where(
        rank < sk, vals, neg_inf))
    uvals, uidx = stable_topk(kept, k)
    mark = torch.where(rank == sk, vals, neg_inf).amax(1).clamp_min(_FLOOR)
    return uvals, uidx, (mark >= uvals[:, k - 1]).to(torch.int32)


def readout_topk_rows_plain(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            k: int, mask: Optional[torch.Tensor] = None, *,
                            slots: int = 0,
                            lanes: Optional[torch.Tensor] = None,
                            recover_live: Optional[torch.Tensor] = None,
                            lse_parts: bool = False):
    """The plain version of the kernel: per-row top-k (values, int32 ids,
    ties to the smaller id) and log-sum-exp of ``t @ w + b`` (fp32 sums of
    the products, bf16 ``t`` and ``w`` included) with banned ids floored
    to -3e38. With ``slots`` > 0 (sk = min(slots, k)) also the
    watermark mode's per-row viol (int32) as a fourth output, under the
    lane map ``lanes`` ((V,) lane ids; None: ``kernel_lanes``), with the
    shallow union's top-k in place of the exact one unless sk == k; rows
    flagged and True in ``recover_live`` (R,) get the depth-k result.
    lse_parts: the third output is (R, 2), the terms of lse = M + log(S),
    the row's max M and S = sum of exp(logit - M), in place of lse."""
    logits = mm(t, w) + b
    if mask is not None:
        logits = torch.where(mask.bool(), torch.full_like(logits, _FLOOR),
                             logits)
    vals, idx = stable_topk(logits, k)
    if lse_parts:
        top = logits.amax(-1)
        lse = torch.stack([top, torch.exp(logits - top[:, None]).sum(-1)], 1)
    else:
        lse = torch.logsumexp(logits, dim=-1)
    if not slots:
        return vals, idx.to(torch.int32), lse
    R, V = logits.shape
    if min(slots, k) >= k:
        return (vals, idx.to(torch.int32), lse,
                torch.zeros((R,), dtype=torch.int32, device=logits.device))
    lanes = kernel_lanes(R, V) if lanes is None else lanes
    svals, sidx, viol = _shallow(logits, k, slots, lanes)
    if recover_live is not None:
        fix = ((viol > 0) & recover_live)[:, None]
        svals, sidx = torch.where(fix, vals, svals), torch.where(fix, idx, sidx)
    return svals, sidx.to(torch.int32), lse, viol


def readout_topk_rows(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      k: int, mask: Optional[torch.Tensor] = None, *,
                      slots: int = 0,
                      recover_live: Optional[torch.Tensor] = None,
                      impl: str = "auto", id_base: int = 0,
                      lse_parts: bool = False):
    """(vals (R, k) f32, idx (R, k) int32, lse (R,) f32) of the rows of
    ``t @ w + b`` (t and w both fp32, or both bf16 with fp32 sums: the
    kernel's bf16 instances, counted in ``readout_topk_rows.bf16_launches``;
    b fp32); with ``slots`` > 0 the watermark mode at slot depth
    min(slots, k) and a fourth output, viol (R,) int32, as
    ``readout_topk_rows_plain``. recover_live ((R,) bool): recover the
    flagged live rows at depth k within the call (the per-step recovery);
    each such row and each call that recovers any counts in
    ``readout_topk_rows.recoveries``, a (2,) int64 tensor on the rows'
    device (None until the first recovery). impl: "auto" (kernel for CUDA
    tensors, plain for CPU tensors), "kernel" or "plain". Each kernel call
    counts one in ``readout_topk_rows.launches`` and its grids in
    ``readout_topk_rows.grids``: one (the vocab splits, merged by the last
    block of each row tile), and with the per-step recovery a second, the
    depth-k rerun of the marked row tiles (after a memset of the marks).
    The kernel has an instance for k <= 8 and one for k > 8
    (``ops/topk.K_INSTANCES``); above 16 that one runs ``k_plan``'s
    passes, a grid each (each rerun a grid a pass too), counted in
    ``readout_topk_rows.passes``; there a slot depth above 16 below k has
    no instance (ValueError). id_base: added to every id the call
    returns (w holds columns id_base.. of a larger vocab: a vocab slice
    under tensor parallelism); the kernel writes the ids so. lse_parts:
    the third output is (R, 2), lse's terms M and S (lse = M + log(S)),
    as ``readout_topk_rows_plain``'s."""
    sk = min(slots, k) if slots else k
    recover = recover_live if sk < k else None
    if resolve_impl(impl, t) == "plain":
        out = readout_topk_rows_plain(t, w, b, k, mask, slots=slots,
                                      recover_live=recover,
                                      lse_parts=lse_parts)
        if id_base:
            out = (out[0], out[1] + id_base) + tuple(out[2:])
        if recover is not None:
            fix = (out[3] > 0) & recover
            _recoveries(t.device).add_(torch.stack([fix.sum(), fix.any().long()]))
        return out
    R, E = t.shape
    V = w.shape[1]
    if not 1 <= k <= V:
        raise ValueError(f"readout_topk kernel: k={k} outside 1..{V}")
    passes = k_plan(k)[1]
    if passes > 1 and MAX_K < sk < k:
        raise ValueError(f"readout_topk kernel: slot depth {sk} of k={k}: "
                         f"above {MAX_K} beams the passes keep at most "
                         f"{MAX_K} slots a lane")
    width = MAX_K if passes > 1 else k   # the partial lists' width
    bf = t.dtype == torch.bfloat16
    op = torch.bfloat16 if bf else torch.float32
    check_kernel_arg(t, op, (R, E), "readout_topk: t")
    check_kernel_arg(w, op, (E, V), "readout_topk: w (t's dtype)")
    check_kernel_arg(b, torch.float32, (V,), "readout_topk: b")
    if mask is not None:
        check_kernel_arg(mask, torch.uint8, (R, V), "readout_topk: mask")
    n_split, split_cols = _split_plan(R, V)
    row_tiles = -(-R // _ROW_TILE)
    dev = t.device
    part_v = torch.empty((n_split, R, width), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_split, R, width), dtype=torch.int32, device=dev)
    part_m = torch.empty((n_split, R), dtype=torch.float32, device=dev)
    part_s = torch.empty((n_split, R), dtype=torch.float32, device=dev)
    vals = torch.empty((R, k), dtype=torch.float32, device=dev)
    idx = torch.empty((R, k), dtype=torch.int32, device=dev)
    lse = torch.empty((R,), dtype=torch.float32, device=dev)
    parts = (torch.empty((R, 2), dtype=torch.float32, device=dev)
             if lse_parts else None)
    # shallow slots: (part_w, viol); per-step recovery: (live, tile marks,
    # the recovery counter)
    shallow, recovery = (None, None), (None, None, None)
    if sk < k:
        shallow = (torch.empty((n_split, R), dtype=torch.float32, device=dev),
                   torch.empty((R,), dtype=torch.int32, device=dev))
    if recover is not None:
        live = recover.to(torch.uint8).contiguous()
        check_kernel_arg(live, torch.uint8, (R,), "readout_topk: recover_live")
        recovery = (live, torch.empty((row_tiles,), dtype=torch.uint8,
                                      device=dev), _recoveries(dev))
    part_w, viol = (None if x is None else x.data_ptr() for x in shallow)
    lib = _build.load(instance("readout_topk", k, bf16=bf))
    rc = lib.readout_topk_launch(
        t.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if mask is None else mask.data_ptr(),
        part_v.data_ptr(), part_i.data_ptr(), part_m.data_ptr(),
        part_s.data_ptr(), part_w,
        _arrival_counters(dev, row_tiles).data_ptr(),
        vals.data_ptr(), idx.data_ptr(),
        lse.data_ptr(), None if parts is None else parts.data_ptr(), viol,
        *(None if x is None else x.data_ptr() for x in recovery),
        R, E, V, k, sk, n_split, split_cols, id_base,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"readout_topk kernel launch failed: CUDA error {rc}")
    readout_topk_rows.launches += 1
    readout_topk_rows.bf16_launches += bf
    readout_topk_rows.grids += passes * (1 if recover is None else 2)
    if passes > 1:
        readout_topk_rows.passes += passes
    if lse_parts:
        lse = parts
    if not slots:
        return vals, idx, lse
    if shallow[1] is None:                     # depth k: nothing flagged
        return vals, idx, lse, torch.zeros((R,), dtype=torch.int32, device=dev)
    return vals, idx, lse, shallow[1]


readout_topk_rows.launches = 0
readout_topk_rows.bf16_launches = 0
readout_topk_rows.grids = 0
readout_topk_rows.passes = 0
readout_topk_rows.recoveries = None


def _recoveries(dev: torch.device) -> torch.Tensor:
    """The recovery counter on ``dev`` (made, at zero, on first use there)."""
    c = readout_topk_rows.recoveries
    if c is None or c.device != dev:
        c = readout_topk_rows.recoveries = torch.zeros(2, dtype=torch.int64,
                                                       device=dev)
    return c


# One tiling for both instances (K <= 8 and K > 8): at MAX_K = 16 the
# lane merge's BM x 16 lanes of 2 * 16 + 3 floats (35840) still fit the
# 39552 floats of the ring (tests/test_torch_readout_plan.py). The bf16
# instances are csrc/readout_topk_bf16.cu's, with the same grid, tiles
# and lane map (tests/test_torch_readout_bf16_plan.py).
declare_instances("readout_topk", "readout_topk_launch",
                  [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
                  {"VAG_BM": _ROW_TILE, "VAG_BN": _COL_TILE,
                   "VAG_BK": _DEPTH_CHUNK, "VAG_LANE_PERIOD": _LANE_PERIOD,
                   "VAG_CPT": _LANE_COLS},
                  bf16_defines={"VAG_BM": _ROW_TILE, "VAG_BN": _COL_TILE,
                                "VAG_LANE_PERIOD": _LANE_PERIOD,
                                "VAG_CPT": _LANE_COLS,
                                "VAG_STAGES": _BF16_STAGES,
                                "VAG_RESIDENT_KC": _BF16_RESIDENT_BOXES})


def deferred_exactness_active(K: int) -> bool:
    """Whether beam_search carries the live-row watermark flag over a chunk
    and reruns the chunk at depth K when it fired (the JAX package's
    chunk-level deferred recovery): the fused step (``VAG_READOUT_TOPK``,
    default "fused" on every device, where the JAX package takes "unfused"
    off the TPU) at a slot depth below K, ``VAG_FRT_DEFER`` not "0" and
    ``VAG_FRT_NOCOND`` not "1"."""
    kn = decode_knobs()
    if not kn.frt_defer or kn.frt_nocond or kn.readout_topk != "fused":
        return False
    return min(max(1, over(kn.frt_slots, K)), K) < K


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
    # torch.full, not torch.tensor: no host copy, so a graph can capture it
    froz_idx = torch.cat([torch.full((1,), pad_id, dtype=torch.long,
                                     device=dev), rest])

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
    slots: int = 0,
    defer_exact: bool = False,
    vocab: Optional[VocabShard] = None,
):
    """Top-K next-beam candidates straight from the readout activations:
    (top_scores (B, K) fp32 descending, flat_idx (B, K) int64, flat =
    beam * V + token), the contract of ``beam_topk`` applied to
    ``t @ w + b``. impl: "auto" (kernel for CUDA tensors, plain for CPU
    tensors), "kernel", "plain", or the JAX names "pallas" / "xla". A bf16
    ``w`` (a bf16 decode's, or with ``VAG_FRT_GEMM_DTYPE=bf16`` an fp32
    one cast once by ``decoder.decode_tables``) takes ``t`` in bf16 too:
    the products bf16 x bf16 with fp32 sums, kernel 1's bf16 instance on
    the card.

    slots: the per-lane slot depth (0: ``VAG_FRT_SLOTS``, else K). Below K
    the result stays exact: flagged live rows are recovered at depth K in
    the step, unless defer_exact, where a third output is appended instead,
    a 0-dim bool tensor on the device (no sync) that is True iff a LIVE row
    was flagged (frozen rows' outputs are discarded by ``_combine``), or
    ``VAG_FRT_NOCOND=1``, where nothing is recovered (not exact). At depth
    K the appended flag is always False.

    vocab (tensor parallelism): w and b are this rank's columns [v0, v1)
    of a vocab of ``vocab.total``, ban holds global ids; each rank runs
    the rows' top-K on its slice and the slices are merged
    (``_merge_slices``), the result the same on every rank of the model
    group."""
    B, K = scores.shape
    E, V = w.shape
    R = t.shape[0]
    if R != B * K:
        raise ValueError(f"t rows {R} != B*K = {B * K}")
    scores = scores.to(torch.float32)
    kn = decode_knobs()
    if w.dtype == torch.bfloat16:
        t = t.to(torch.bfloat16)
    sk = min(max(1, slots if slots > 0 else over(kn.frt_slots, K)), K)
    route = resolve_impl(impl, t)
    if vocab is not None:
        return _merge_slices(t, w, b, scores, finished, ban, sk=sk,
                             route=route, pad_id=pad_id,
                             recover=not defer_exact and not kn.frt_nocond,
                             defer_exact=defer_exact, vocab=vocab)
    mask = None if ban is None else ban_mask(ban, V)
    if sk >= K:
        if route == "plain":
            logits = mm(t, w) + b
            if mask is not None:
                logits = torch.where(mask.bool(), logits.clamp_max(_FLOOR),
                                     logits)
            out = beam_topk_plain(logits.reshape(B, K, V), scores, finished,
                                  pad_id=pad_id)
        else:
            rows = readout_topk_rows(t.contiguous(), w.contiguous(),
                                     b.contiguous(), K, mask, impl="kernel")
            out = _combine(*rows, scores, finished, V, pad_id)
        if defer_exact:
            out = out + (torch.zeros((), dtype=torch.bool, device=t.device),)
        return out
    live = ~finished.reshape(-1)
    recover = not defer_exact and not kn.frt_nocond
    rvals, ridx, lse, viol = readout_topk_rows(
        t.contiguous(), w.contiguous(), b.contiguous(), K, mask, slots=sk,
        recover_live=live if recover else None, impl=route)
    out = _combine(rvals, ridx, lse, scores, finished, V, pad_id)
    if defer_exact:
        out = out + (((viol > 0) & live).any(),)
    return out


def _merge_slices(t, w, b, scores, finished, ban, *, sk: int, route: str,
                  pad_id: int, recover: bool, defer_exact: bool,
                  vocab: VocabShard):
    """fused_readout_topk on a vocab slice: the rows' top-K, lse and
    watermark flags of this rank's slice (kernel 1 writing global ids
    through id_base, or its plain version, at depth min(K, v1 - v0); a
    narrower slice pads its rows with -inf entries, below every logit
    and floored ban, whose ids sort last), one exact gather of them over
    the model group, then in model_index order: the K largest of the
    n_model * K values, ties to the smaller id (a slice's list holds its
    ids in order, and slices hold increasing ids, so the position breaks
    ties as the id does); the row's lse from each slice's terms (M_j,
    S_j), lse_j = M_j + log(S_j), as the kernel's last CTA merges its
    vocab splits: M = max_j M_j, lse = M + log(sum_j S_j exp(M_j - M))
    (a merge of the lse_j themselves, m + log sum_j exp(lse_j - m), would
    round each slice's lse through log and exp, ~1e-6 on a row's lse of
    ~9: enough to flip an untrained model's near ties between beams); the
    flags OR'ed (a slice's own K-th value is at most the
    row's, so the OR is conservative and the recovery stays exact).
    Every rank holds the same bits; then ``_combine`` with the global V."""
    B, K = scores.shape
    R, Vj = t.shape[0], w.shape[1]
    mask = None
    if ban is not None:
        local, inside = vocab.local(ban.long())
        mask = ban_mask(torch.where(inside, local, Vj), Vj)
    k = min(K, Vj)
    live = ~finished.reshape(-1)
    vals, idx, ms, viol = readout_topk_rows(
        t.contiguous(), w.contiguous(), b.contiguous(), k, mask,
        slots=min(sk, k), recover_live=live if recover else None,
        impl=route, id_base=vocab.v0, lse_parts=True)
    if k < K:
        vals = torch.cat([vals, vals.new_full((R, K - k), float("-inf"))], 1)
        idx = torch.cat([idx, idx.new_full((R, K - k), 2 ** 31 - 1)], 1)
    packed = torch.cat([vals.view(torch.int32), idx, ms.view(torch.int32),
                        viol.to(torch.int32)[:, None]], 1)
    g = vocab.mesh.model_all_gather(packed[None])      # (n, R, 2K + 3)
    n = g.shape[0]
    allv = g[..., :K].contiguous().view(torch.float32)
    alli = g[..., K:2 * K]
    ms = g[..., 2 * K:2 * K + 2].contiguous().view(torch.float32)
    top, pos = stable_topk(allv.permute(1, 0, 2).reshape(R, n * K), K)
    ids = torch.gather(alli.permute(1, 0, 2).reshape(R, n * K), 1, pos)
    m = ms[..., 0].amax(0)
    s = ms[0, :, 1] * torch.exp(ms[0, :, 0] - m)
    for j in range(1, n):
        s = s + ms[j, :, 1] * torch.exp(ms[j, :, 0] - m)
    lse = m + torch.log(s)
    flag = (g[..., 2 * K + 2] > 0).any(0)
    out = _combine(top, ids, lse, scores, finished, vocab.total, pad_id)
    if defer_exact:
        out = out + ((flag & live).any(),)
    return out
