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
top-K (ties to the smaller id) and combines the K*K per sentence
beam-major, which is the flat-index order again.

Kernel 6 and both gens share one split design (``csrc/topk_split.cuh``):
a grid over (row, vocab slice) with ``split_plan``'s S slices per row,
each CTA writing its slice's K best, and the last CTA of each sentence
merging them (gen 1: by its rank, then back to flat ids; gen 2: per row,
then the combine) in the same launch."""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List, Optional, Tuple

import torch

import torch.nn.functional as F

from vag_nmt_tpu_torch.core.config import PAD_ID
from vag_nmt_tpu_torch.core.device import check_kernel_arg, resolve_impl
from vag_nmt_tpu_torch.core.knobs import decode_knobs
from vag_nmt_tpu_torch.ops import _build

NEG_INF = -1e9          # finished-beam filler, matches decode/beam.py
_FLOOR = -3.0e38        # "smaller than any candidate" for masking
# Kernels 1 (readout_topk) and 7 (dec_step) size register arrays by
# VAG_MAX_K, so each is built twice from one source: VAG_MAX_K = 8 for
# K <= 8 (the beam-5 path's build, defines and tiling) and 16 for K > 8.
# Kernels 6, 8 and 9 (here) are built once with a K switch over 1..MAX_K.
# Above MAX_K every kernel runs passes (``k_plan``): the candidates being
# ordered strictly and totally by (value desc, id asc), the top-K is
# ceil(K / 16) top-16s, each of the candidates strictly after the last
# entry the pass before wrote (csrc/topk_split.cuh); kernel 7 loops over
# groups of 16 beams in its attention instead.
K_INSTANCES = (8, 16)
MAX_K = K_INSTANCES[-1]
LEGACY_BLOCK = 512      # the legacy TPU kernels' vocab block (their tv)
SPLIT_THREADS = 128     # threads of a split CTA (csrc/topk_split.cuh)
SPLIT_MIN_COLS = 4 * SPLIT_THREADS   # one float4 per thread at least
SPLIT_TARGET_CTAS = 4 * 132          # four CTAs on each of the H100's SMs

# VAG_TOPK_IMPL values -> the port's impl names
_KNOB_IMPL = {"auto": "auto", "xla": "plain", "pallas_lanes": "kernel"}


def k_instance(K: int) -> int:
    """VAG_MAX_K of the kernel instance that takes K beams (or K slots):
    8 for K <= 8, else 16 (above 16 in passes, ``k_plan``)."""
    return next((m for m in K_INSTANCES if K <= m), MAX_K)


def k_plan(K: int) -> Tuple[int, int]:
    """(VAG_MAX_K of the instance, passes) for K beams: one pass up to
    MAX_K, ceil(K / MAX_K) passes of MAX_K above."""
    return k_instance(K), (1 if K <= MAX_K else -(-K // MAX_K))


def instance(base: str, K: int, bf16: bool = False) -> str:
    """The build name of kernel ``base``'s instance for K: ``base`` itself
    for K <= 8, ``base_k16`` above; with ``bf16`` its bf16 build
    (``base_bf16``, ``base_k16_bf16``)."""
    m = k_instance(K)
    name = base if m == K_INSTANCES[0] else f"{base}_k{m}"
    return f"{name}_bf16" if bf16 else name


def declare_instances(base: str, fn: str, argtypes: list,
                      defines: Dict[str, int],
                      bf16_defines: Optional[Dict[str, int]] = None) -> None:
    """Declare C entry ``fn`` of csrc/<base>.cu in every instance, each
    with ``defines`` and its own VAG_MAX_K; with ``bf16_defines`` also
    each one's bf16 build, of its own source csrc/<base>_bf16.cu
    (``-DVAG_BF16=1``, ``bf16_defines`` and VAG_MAX_K), with the same
    entry point."""
    for m in K_INSTANCES:
        _build.declare(instance(base, m), fn, argtypes,
                       {**defines, "VAG_MAX_K": m}, src=base)
        if bf16_defines is not None:
            _build.declare(instance(base, m, bf16=True), fn, argtypes,
                           {**bf16_defines, "VAG_MAX_K": m, "VAG_BF16": 1},
                           src=f"{base}_bf16")


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, ties to the smaller index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def split_plan(B: int, K: int, V: int) -> int:
    """Slices per row S of the split kernels: the fewest that give the
    B*K rows SPLIT_TARGET_CTAS CTAs, but no slice under SPLIT_MIN_COLS
    columns (at least 1)."""
    want = -(-SPLIT_TARGET_CTAS // (B * K))
    return max(1, min(want, V // SPLIT_MIN_COLS))


def split_bounds(V: int, S: int) -> List[Tuple[int, int]]:
    """Column bounds [c0, c1) of a row's S slices, as the kernel cuts them
    (``slice_len``: ceil(V / S) rounded up to 4); trailing slices may be
    empty."""
    L = (-(-V // S) + 3) // 4 * 4
    return [(min(V, s * L), min(V, s * L + L)) for s in range(S)]


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


def legacy_topk_blocks(logits, scores, finished, *, pad_id: int = PAD_ID,
                       impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Gen 1: ``legacy_topk_blocks_plain``'s contract. impl: "auto" (the
    kernel for CUDA tensors, the plain version for CPU tensors), "kernel"
    or "plain". Each kernel call counts one in ``.launches`` and its grids
    in ``.grids``: one, or above MAX_K beams one a pass, also counted in
    ``.passes``. K > MAX_K needs K <= V (ValueError else)."""
    if resolve_impl(impl, logits) == "plain":
        return legacy_topk_blocks_plain(logits, scores, finished, pad_id=pad_id)
    return _launch("legacy_topk_blocks", legacy_topk_blocks, logits, scores,
                   finished, pad_id)


def legacy_topk_rows(logits, scores, finished, *, pad_id: int = PAD_ID,
                     impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Gen 2: ``legacy_topk_rows_plain``'s contract; one launch takes the
    per-row top-K and the K*K -> K combine. impl and counters as
    ``legacy_topk_blocks``."""
    if resolve_impl(impl, logits) == "plain":
        return legacy_topk_rows_plain(logits, scores, finished, pad_id=pad_id)
    return _launch("legacy_topk_rows", legacy_topk_rows, logits, scores,
                   finished, pad_id)


legacy_topk_blocks.launches = legacy_topk_blocks.grids = 0
legacy_topk_rows.launches = legacy_topk_rows.grids = 0
legacy_topk_blocks.passes = legacy_topk_rows.passes = 0

_DEFINES = {"VAG_SPLIT_THREADS": SPLIT_THREADS}
_build.declare("legacy_topk", "legacy_topk_blocks_launch",
               [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
               defines=_DEFINES)
_build.declare("legacy_topk", "legacy_topk_rows_launch",
               [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
               defines=_DEFINES)
_build.declare("legacy_topk", "legacy_topk_blocks_passes_launch",
               [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
               defines=_DEFINES)
_build.declare("legacy_topk", "legacy_topk_rows_passes_launch",
               [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
               defines=_DEFINES)


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
    ``beam_topk.launches`` and its grids in ``beam_topk.grids``: one, or
    above MAX_K beams one a pass (``k_plan``), also counted in
    ``beam_topk.passes``. K > MAX_K needs K <= V (ValueError else)."""
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
    return _launch("beam_topk", beam_topk, logits, scores, finished, pad_id)


# The split kernels' arrival counters (kernel 1's row-tile tickets too),
# zero between launches (the last CTA of each sentence or row tile sets
# its counter back to 0). Launches on one stream run in order and may
# share a buffer; launches on two streams may not. So there is one buffer
# per (device, stream): an eager launch takes its stream's, and a CUDA
# graph is captured on a stream of its own whose buffer ``stream_counters``
# binds before the capture and the graph keeps (decode/graphs.py), so two
# graphs, or a graph and an eager launch, never share a ticket.
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}
COUNTER_MIN = 1024       # a new buffer's least length


def counters_for(table: Dict, key, n: int, make) -> torch.Tensor:
    """``table[key]``, replaced by ``make(max(n, COUNTER_MIN))`` where it is
    missing or shorter than ``n``: one buffer per key, grown, never
    shared between keys."""
    c = table.get(key)
    if c is None or c.numel() < n:
        c = table[key] = make(max(n, COUNTER_MIN))
    return c


def _zeros(dev: torch.device):
    return lambda n: torch.zeros(n, dtype=torch.int32, device=dev)


def _arrival_counters(dev: torch.device, n: int) -> torch.Tensor:
    """The counters of the current stream on ``dev``, at least ``n``. Under
    a capture the stream's buffer must have been bound before it
    (``stream_counters``): an allocation there would belong to the graph's
    pool, so a missing or short one raises."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    if torch.cuda.is_current_stream_capturing():
        c = _COUNTERS.get(key)
        if c is None or c.numel() < n:
            raise RuntimeError(f"no arrival counters of {n} bound to the "
                               "capturing stream (ops/topk.stream_counters)")
        return c
    return counters_for(_COUNTERS, key, n, _zeros(dev))


@contextlib.contextmanager
def stream_counters(dev: torch.device, stream_id: int, n: int):
    """Bind a fresh buffer of at least ``n`` counters to the stream
    ``stream_id`` on ``dev`` for the block (a graph's warm-up and capture
    on its own stream); yields it for the graph to keep. The stream's
    earlier binding, if any, comes back after the block."""
    key = (dev, stream_id)
    old = _COUNTERS.pop(key, None)
    buf = counters_for(_COUNTERS, key, n, _zeros(dev))
    try:
        yield buf
    finally:
        if old is None:
            _COUNTERS.pop(key, None)
        else:
            _COUNTERS[key] = old


def grid_call(name: str, logits, scores, finished, *, pad_id: int = PAD_ID):
    """One launch of kernel ``name`` ("beam_topk", "legacy_topk_blocks" or
    "legacy_topk_rows") made ready: (C function, its arguments, its
    outputs, the tensors its pointers hold). The outputs end with (vals,
    idx); gen 2's begin with its per-row top-K (rvals, ridx). Above MAX_K
    beams ``fn`` is the entry that enqueues one grid a pass. The wrapper
    calls ``fn(*args)`` once; chip_smoke.py times that call alone, with
    ``base``, scratch and outputs made beforehand. Counts nothing."""
    B, K, V = logits.shape
    kmax = V if name != "beam_topk" or K > MAX_K else MAX_K
    if not 1 <= K <= kmax:
        raise ValueError(f"{name} kernel: K={K} outside 1..{kmax} (above "
                         f"{MAX_K} beams the passes need K <= V)")
    passes = k_plan(K)[1] > 1
    check_kernel_arg(logits, torch.float32, (B, K, V), f"{name}: logits")
    base = _base(logits, scores, finished).contiguous()
    fin = finished.to(torch.uint8).contiguous()
    check_kernel_arg(fin, torch.uint8, (B, K), f"{name}: finished")
    dev = logits.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = (torch.empty((B, K), dtype=torch.float32, device=dev),
            torch.empty((B, K), dtype=torch.int64, device=dev))
    keep = (logits, base, fin)
    S = split_plan(B, K, V)
    width = MAX_K if passes else K       # the partial lists' width
    scratch = (torch.empty(B * K * S * width, dtype=torch.float32, device=dev),
               torch.empty(B * K * S * width, dtype=torch.int32, device=dev),
               _arrival_counters(dev, B))
    entry = f"{name}_passes_launch" if passes else f"{name}_launch"
    if name == "legacy_topk_rows":
        outs = (torch.empty((B * K, K), dtype=torch.float32, device=dev),
                torch.empty((B * K, K), dtype=torch.int32, device=dev)) + outs
    lib = _build.load("beam_topk" if name == "beam_topk" else "legacy_topk")
    fn = getattr(lib, entry)
    args = (logits.data_ptr(), base.data_ptr(), fin.data_ptr(),
            *(x.data_ptr() for x in scratch + outs), B, K, V, S, pad_id,
            stream)
    return fn, args, outs, keep + scratch


def _launch(name: str, wrapper, logits, scores, finished, pad_id: int):
    """Launch kernel ``name`` (one call: a grid, or a grid a pass) and
    count it on ``wrapper``; its (vals, idx)."""
    fn, args, outs, _ = grid_call(name, logits, scores, finished,
                                  pad_id=pad_id)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    passes = k_plan(logits.shape[1])[1]
    wrapper.launches += 1
    wrapper.grids += passes
    if passes > 1:
        wrapper.passes += passes
    return outs[-2:]


beam_topk.launches = 0
beam_topk.grids = 0
beam_topk.passes = 0

for _entry in ("beam_topk_launch", "beam_topk_passes_launch"):
    _build.declare("beam_topk", _entry,
                   [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
                   defines=_DEFINES)
