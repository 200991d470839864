"""Teacher-forced decoder scan, forward and backward: the hand-written CUDA
kernels (``csrc/dec_scan_fwd.cu``, ``csrc/dec_scan_bwd.cu``), their tiling
(``dec_scan_plan``), their plain PyTorch versions, the wrappers that pick
between them by the tensors' device, ``DecoderScan`` (the
``torch.autograd.Function`` that joins them) and ``decoder_scan``, the
counterpart of the JAX package's ``ops/pallas_dec_scan.py::
pallas_decoder_scan``.

Per target step: GRU1 on the precomputed input gates, the query
``q = s~ @ ua``, masked Bahdanau attention over ctx / ctx_proj (with ``ba``
folded into ctx_proj), GRU2 on the context, and the readout
``t = tanh(ty + s @ ws + c @ wc)`` (with ``b`` folded into ty). The bias
folding happens outside the Function, so the grads of ``b`` and ``ba`` fall
out of dty / dctx_proj through ordinary autograd.

Tensors are time-major for the per-step streams: ty_t (Tt, B, R), xg_t
(Tt, B, 3H); ctx (B, T, C), ctxp (B, T, A), mask (B, T), s0 (B, H). The
weights travel as one tuple in ``WEIGHTS`` order. The forward returns the
readout and its residuals (``RESIDUALS``), which the backward consumes, so
the backward recomputes only the attention energies.

Each kernel runs its recurrence as one persistent cooperative grid (one
CTA per SM): the recurrent weights stay resident in shared memory, split
over the CTAs by output column (where a phase's slices do not fit, in a
buffer read through L2), and a step is four phases between grid syncs;
the time-parallel work (the readout, the weight grads) runs in grids of
its own (see the sources). ``dec_scan_plan`` owns the tiling: its
constants are the build's -D defines, the tiles of each product and the
memory layout the launch's arguments, so the CPU tests of the plan cover
what is launched.

Under ``compute_dtype="bfloat16"`` (``ctx`` in bf16) the scan follows
``pallas_decoder_scan``'s bf16 path unless ``VAG_GRU_STREAM=fp32``: xg_t
and the six weight matrices (uh1, ua, wi2, uh2, ws, wc) go to bf16, ctx
stays bf16, ty_t, ctxp, s0, the biases and va stay fp32, every matrix
product is bf16 x bf16 -> fp32 (``rbf``), and the backward returns dxg_t
and dctx in bf16 and the matrices' grads summed in fp32, rounded to bf16
once. The kernels run in their bf16 instances (builds
``dec_scan_fwd_bf16`` / ``dec_scan_bwd_bf16``). As the JAX kernel, the
bf16 scan keeps only its states s' for the backward, rounded to bf16, and
the backward recomputes the residuals from them: ``dec_scan_fwd(...,
states=)`` replays the steps from the saved states (each step from s[t],
not from the fp32 carry), then ``dec_scan_bwd`` runs on that replay's
residuals. Step t of the replay reads only states[t], so its steps are
independent: the replay runs no recurrence but time-parallel grids over
all Tt * B rows at once (``dec_scan_replay_launch`` of the bf16 build;
``dec_scan_replay_plain`` is its plain version).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from vag_nmt_tpu_torch.core.device import check_kernel_arg, resolve_impl
from vag_nmt_tpu_torch.core.knobs import gru_stream_fp32
from vag_nmt_tpu_torch.ops import _build
from vag_nmt_tpu_torch.ops.gru_kernel import (_device_limits,
                                              gru_cell_bwd_plain,
                                              gru_gate_algebra, rbf)
from vag_nmt_tpu_torch.ops.scan_tiles import (  # noqa: F401 (re-exported)
    _DEFINES, BK, GM, GN, GSTAGES, NI_MAX, TILE_ROWS, WARPS, ScanProduct,
    _phase_options, _up)

NEG_INF = -1e9          # as ops/attention.masked_softmax

WEIGHTS = ("uh1", "bh1", "ua", "va", "wi2", "bi2", "uh2", "bh2", "ws", "wc")
MATRICES = ("uh1", "ua", "wi2", "uh2", "ws", "wc")   # bf16 under bf16 streams
# t (Tt, B, R); s (Tt + 1, B, H) with s[0] = s0; st = s~ (Tt, B, H);
# c (Tt, B, C); w (Tt, B, T); q (Tt, B, A); hg1, xg2, hg2 (Tt, B, 3H)
RESIDUALS = ("t", "s", "st", "c", "w", "q", "hg1", "xg2", "hg2")
# bf16 streams' copies of the residuals the bf16 products read: s (Tt + 1,
# B, H), st (Tt, B, H), c (Tt, B, C) in bf16. dec_scan_bwd takes the
# residuals of either forward path (the forward's, as fp32 streams do, or
# the replay's, as DecoderScan gives it), so both write all three; the
# forward's st copy costs it one bf16 store a state unit a step (32 KiB a
# step at B = 64, H = 256) beside its fp32 st.
BF16_COPIES = ("sb", "stb", "cb")

# The plan's choices beside the products' (ops/scan_tiles.py): CTAs sharing
# an attention row and rows of a column-sum block (the bias grads).
MAX_ATT_PARTS = 4
COLSUM_ROWS = 128
FWD_GRIDS, BWD_GRIDS = 2, 6   # grids a call of each kernel enqueues
BWD_GRIDS_BF16 = 7            # the bf16 backward's (dctx a grid of its own)
REPLAY_GRIDS = 4              # and the backward's replay (bf16 streams)


@dataclass(frozen=True)
class ScanPlan:
    """One kernel's recurrence, one cooperative grid: ``ctas`` CTAs (one
    per SM), its four products in launch order, grouped into the phases of
    ``phases`` (a phase's products on disjoint CTAs), each phase's weight
    slices at one offset of the shared memory or (where they do not fit)
    of the weight buffer of ``l2_floats`` floats, the scratch region (the
    k-slices' accumulators and the attention's shared row) at float
    ``scratch_off``, ``smem_bytes`` of dynamic shared memory, ``att_parts``
    CTAs a sentence in the attention, and (backward) the rows of a
    column-sum block. The streamed products' grids take fixed GM x GN
    tiles."""
    kernel: str
    ctas: int
    products: Tuple[ScanProduct, ...]
    phases: Tuple[Tuple[str, ...], ...]
    att_parts: int
    scratch_off: int
    smem_bytes: int
    l2_floats: int
    colsum_rows: int

    def product(self, name: str) -> ScanProduct:
        return next(p for p in self.products if p.name == name)

    def launch_args(self) -> Tuple[int, ...]:
        head = (self.ctas, self.att_parts, self.scratch_off, self.smem_bytes,
                self.l2_floats)
        if self.kernel == "dec_scan_bwd":
            head += (self.colsum_rows,)
        return head + tuple(x for p in self.products for x in p.launch_args())


@dataclass(frozen=True)
class DecScanPlan:
    fwd: ScanPlan
    bwd: ScanPlan


# Each kernel's products (name, depth, output columns, gate tiles?) in
# launch order, by phase. Forward: (a) hg1 = s @ uh1 with GRU1, (b) q =
# s~ @ ua and hg2 = s~ @ uh2, (d) xg2 = c @ wi2 with GRU2 (the attention
# is phase (c)). Backward: (A) dc = dxg2 @ wi2^T and ds~ = dhg2 @ uh2^T,
# (C) dq @ ua^T with GRU1's cell backward, (D) dhg1 @ uh1^T with GRU2's
# (the attention is phase (B)).
def _specs(kernel: str, H: int, A: int, C: int):
    if kernel == "dec_scan_fwd":
        return ((("hg1", H, 3 * H, True),),
                (("q", H, A, False), ("hg2", H, 3 * H, False)),
                (("xg2", C, 3 * H, True),))
    return ((("dc", 3 * H, C, False), ("dst", 3 * H, H, False)),
            (("dstq", A, H, False),),
            (("ds", 3 * H, H, False),))


def _att_parts(B: int, n_sms: int) -> int:
    return max(1, min(MAX_ATT_PARTS, n_sms // B))


def _att_floats(kernel: str, T: int, A: int, C: int, parts: int) -> int:
    """Shared floats of an attention row (csrc/dec_scan.cuh's att_floats_*):
    forward q, va, the mask, the scores and two halves of the part's
    columns; backward dc, w, dscore, q, va, the mask; each padded to a
    multiple of 4."""
    if kernel == "dec_scan_fwd":
        return 2 * _up(A, 4) + 2 * _up(T, 4) + 2 * _up(-(-C // parts), 4)
    return _up(C, 4) + 3 * _up(T, 4) + 2 * _up(A, 4)


def _kernel_plan(kernel: str, B: int, T: int, H: int, A: int, C: int,
                 n_sms: int, max_smem: int, bf16: bool = False) -> ScanPlan:
    phases = _specs(kernel, H, A, C)
    fronts = [_phase_options(ph, B, H, n_sms, bf16) for ph in phases]
    if not all(fronts):
        raise ValueError(f"{kernel}: no tiling of B={B}, H={H}, A={A}, "
                         f"C={C} on {n_sms} SMs")
    # Each phase: its Pareto front with the slices resident, or its least
    # cost with the slices in L2 (every CTA's slices, in L2 floats).
    options = [[(cost, region, combo, 0) for cost, region, combo in front]
               + [(front[0][0], 0, front[0][2],
                   sum(p.ctas * p.region_floats for p in front[0][2]))]
               for front in fronts]
    parts = _att_parts(B, n_sms)
    att = _att_floats(kernel, T, A, C, parts)
    best, best_key = None, None
    for choice in itertools.product(*options):
        prods = [p for _, _, combo, _ in choice for p in combo]
        scratch = _up(max([att] + [p.part_floats for p in prods]), 32)
        region = sum(r for _, r, _, _ in choice)
        smem = 4 * (region + scratch)
        if smem > max_smem:
            continue
        # the fewest floats in L2, then the least cost, then shared memory
        key = (sum(x for *_, x in choice), sum(c for c, *_ in choice), smem)
        if best_key is None or key < best_key:
            best, best_key = (choice, region, smem), key
    if best is None:
        raise ValueError(f"{kernel}: the attention row and the products' "
                         f"accumulators of T={T}, A={A}, C={C} do not fit "
                         f"{max_smem} bytes of shared memory")
    choice, scratch_off, smem = best
    placed, woff, l2off = [], 0, 0
    for _, region, combo, in_l2 in choice:
        cta0 = 0
        for p in combo:
            if in_l2:
                placed.append(replace(p, cta0=cta0, l2off=l2off))
                l2off += p.ctas * p.region_floats
            else:
                placed.append(replace(p, cta0=cta0, woff=woff))
            cta0 += p.ctas
        woff += region
    return ScanPlan(kernel, n_sms, tuple(placed),
                    tuple(tuple(s[0] for s in ph) for ph in phases),
                    parts, scratch_off, smem, l2off,
                    COLSUM_ROWS if kernel == "dec_scan_bwd" else 0)


@functools.lru_cache(maxsize=None)   # one shape a batch bucket
def dec_scan_plan(B: int, T: int, H: int, A: int, C: int, R: int,
                  n_sms: int, max_smem: int, bf16: bool = False) -> DecScanPlan:
    """The tiling of both kernels for B rows, T source positions and widths
    H, A, C, R on a card of ``n_sms`` SMs with ``max_smem`` bytes of shared
    memory a block: one CTA per SM; for each phase the products' tiles
    (each CTA one or more column tiles of a phase, their weight slices
    resident in shared memory or, for a phase whose slices do not fit, in
    L2) with the fewest floats in L2, then the least multiply-adds of the
    busiest CTA summed over the phases, then the least shared memory; the
    resident slices, the scratch and the attention's shared row within
    ``max_smem``. R shapes only the streamed products, whose tiles are
    fixed (GM x GN). ``bf16``: the bf16 instances' plan, whose weight
    slices take half the floats. Raises ValueError where nothing fits:
    fewer SMs than a phase has products, or an attention row or the
    accumulators beyond ``max_smem``."""
    if min(B, T, H, A, C, R, n_sms) < 1:
        raise ValueError(f"dec_scan_plan: B={B}, T={T}, H={H}, A={A}, "
                         f"C={C}, R={R}, n_sms={n_sms} must be positive")
    return DecScanPlan(
        _kernel_plan("dec_scan_fwd", B, T, H, A, C, n_sms, max_smem, bf16),
        _kernel_plan("dec_scan_bwd", B, T, H, A, C, n_sms, max_smem, bf16))


def _timer_ptr(timers: Optional[torch.Tensor], n: int) -> Optional[int]:
    if timers is None:
        return None
    check_kernel_arg(timers, torch.int64, (n,), "dec_scan timers")
    return timers.data_ptr()


def _plan_args(plan: ScanPlan):
    args = plan.launch_args()
    return (ctypes.c_int * len(args))(*args), len(args)


def _l2_buffer(plan: ScanPlan, dev: torch.device) -> Optional[torch.Tensor]:
    """The weight slices the plan puts in L2 (written by the launch), or
    None."""
    if not plan.l2_floats:
        return None
    return torch.empty(plan.l2_floats, dtype=torch.float32, device=dev)


def scan_weights(params: Dict[str, Any]) -> Tuple[torch.Tensor, ...]:
    """The decoder's scan weights in ``WEIGHTS`` order."""
    g1, at, g2, r = (params["gru1"], params["attn"], params["gru2"],
                     params["readout"])
    return (g1["uh"], g1["bh"], at["ua"], at["va"], g2["wi"], g2["bi"],
            g2["uh"], g2["bh"], r["ws"], r["wc"])


def _attend(q, ctxp, ctx, mask, va):
    """One step of masked Bahdanau attention: (c (B, C), w (B, T)); a bf16
    ctx enters the fp32 sum exactly (w fp32)."""
    e = torch.tanh(ctxp + q[:, None, :])
    scores = torch.where(mask > 0, e @ va, torch.full_like(mask, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return torch.bmm(w[:, None, :], ctx.to(torch.float32))[:, 0], w


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w, with a bf16 weight matrix the bf16 x bf16 -> fp32 product
    of the bf16 instances (a rounded to bf16)."""
    if w.dtype == torch.bfloat16:
        return rbf(a) @ w.to(torch.float32)
    return a @ w


def dec_scan_fwd_plain(ty_t, xg_t, s0, ctx, ctxp, mask,
                       weights: Sequence[torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of the forward kernel: one step per loop
    turn, then the readout over all steps at once, as the kernel. bf16
    streams: ``_dot``'s products, xg_t and ctx read as fp32."""
    uh1, bh1, ua, va, wi2, bi2, uh2, bh2, ws, wc = weights
    out = {k: [] for k in RESIDUALS if k != "t"}
    s = s0
    out["s"].append(s0)
    for t in range(xg_t.shape[0]):
        hg1 = _dot(s, uh1) + bh1
        st = gru_gate_algebra(xg_t[t].to(torch.float32), hg1, s)
        q = _dot(st, ua)
        hg2 = _dot(st, uh2) + bh2
        c, w = _attend(q, ctxp, ctx, mask, va)
        xg2 = _dot(c, wi2) + bi2
        s = gru_gate_algebra(xg2, hg2, st)
        for k, v in (("s", s), ("st", st), ("c", c), ("w", w), ("q", q),
                     ("hg1", hg1), ("xg2", xg2), ("hg2", hg2)):
            out[k].append(v)
    res = {k: torch.stack(v) for k, v in out.items()}
    pre = _dot(res["c"], wc)
    pre = pre + _dot(res["s"][1:], ws)
    res["t"] = torch.tanh(ty_t + pre)
    return _with_copies(res, xg_t)


def _with_copies(res, xg_t):
    """res with ``BF16_COPIES`` (s, s~, c rounded to bf16) for bf16
    streams, as the kernels write them."""
    if xg_t.dtype == torch.bfloat16:
        res.update({k: res[k[:-1]].to(torch.bfloat16) for k in BF16_COPIES})
    return res


def dec_scan_replay_plain(ty_t, xg_t, ctx, ctxp, mask,
                          weights: Sequence[torch.Tensor],
                          states: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The plain version of the backward's replay as its kernel runs it
    (``dec_scan_replay_launch``): no step reads another (step t starts
    from states[t], not from the carry), so each product runs once over
    all Tt * B rows, and the attention over every (t, b) row at once;
    res["s"] = states, the readout on states[1:]."""
    uh1, bh1, ua, va, wi2, bi2, uh2, bh2, ws, wc = weights
    Tt, B, H3 = xg_t.shape
    H = H3 // 3
    s = states[:-1].reshape(Tt * B, H)
    hg1 = _dot(s, uh1) + bh1
    st = gru_gate_algebra(xg_t.reshape(Tt * B, H3).to(torch.float32), hg1, s)
    q = _dot(st, ua)
    hg2 = _dot(st, uh2) + bh2
    # row t * B + b attends over sentence b
    c, w = _attend(q, ctxp.repeat(Tt, 1, 1), ctx.repeat(Tt, 1, 1),
                   mask.repeat(Tt, 1), va)
    xg2 = _dot(c, wi2) + bi2
    pre = _dot(c, wc) + _dot(states[1:].reshape(Tt * B, H), ws)
    res = {"s": states, "st": st, "c": c, "w": w, "q": q, "hg1": hg1,
           "xg2": xg2, "hg2": hg2}
    res = {k: v if k == "s" else v.reshape(Tt, B, -1) for k, v in res.items()}
    res["t"] = torch.tanh(ty_t + pre.reshape(Tt, B, -1))
    return _with_copies(res, xg_t)


def _kernel_plan_for(dev: torch.device, B: int, T: int, H: int, A: int,
                     C: int, R: int, bf16: bool = False) -> DecScanPlan:
    return dec_scan_plan(B, T, H, A, C, R, *_device_limits(dev), bf16=bf16)


def dec_scan_fwd(ty_t, xg_t, s0, ctx, ctxp, mask,
                 weights: Sequence[torch.Tensor], *, impl: str = "auto",
                 timers: Optional[torch.Tensor] = None,
                 states: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """The readout t and the residuals of the decoder scan (``RESIDUALS``).
    impl: "auto" (kernel for CUDA tensors, plain for CPU tensors), "kernel"
    or "plain". One call of the kernel path enqueues FWD_GRIDS grids (the
    recurrence, one cooperative grid, and the readout; see
    csrc/dec_scan_fwd.cu): it counts one in ``dec_scan_fwd.launches`` and
    those in ``dec_scan_fwd.grids``. Raises when the plan or the launch
    fails (no fallback). ``timers``, a CUDA int64 tensor of 4 Tt + 2
    elements, receives the recurrence's barrier stamps (ns; see the
    source). bf16 streams (xg_t, ctx and the matrices in bf16) run the
    bf16 instance (also counted in ``dec_scan_fwd.bf16_launches``).

    ``states`` (bf16 streams only): (Tt + 1, B, H) fp32, states[0] = s0 and
    states[t + 1] the bf16 state the forward saved at step t. The replay
    that the JAX kernel's backward runs: each step from states[t] (not from
    the carry), the readout on states[1:]; returns the residuals with
    res["s"] = states and their bf16 copies ``BF16_COPIES``. Its steps are
    independent, so it runs no recurrence: REPLAY_GRIDS time-parallel
    grids over all Tt * B rows (csrc/dec_scan_fwd.cu's
    dec_scan_replay_launch; plain version ``dec_scan_replay_plain``),
    counted in ``dec_scan_fwd.replays`` (and in launches, grids and
    bf16_launches); it takes no ``timers``."""
    if resolve_impl(impl, xg_t) == "plain":
        if states is not None:
            return dec_scan_replay_plain(ty_t, xg_t, ctx, ctxp, mask, weights,
                                         states)
        return dec_scan_fwd_plain(ty_t, xg_t, s0, ctx, ctxp, mask, weights)
    Tt, B, R = ty_t.shape
    _, T, C = ctx.shape
    H = s0.shape[1]
    A = ctxp.shape[2]
    bf = _check_inputs("dec_scan_fwd", ty_t, xg_t, s0, ctx, ctxp, mask,
                       weights, Tt, B, T, H, A, C, R)
    if states is not None:
        if not bf:
            raise ValueError("dec_scan_fwd: states= replays bf16 streams only")
        if timers is not None:
            raise ValueError("dec_scan_fwd: the replay runs no recurrence to "
                             "stamp (timers=)")
        check_kernel_arg(states, torch.float32, (Tt + 1, B, H),
                         "dec_scan_fwd: states")
        return _replay(ty_t, xg_t, ctx, ctxp, mask, weights, states)
    dev = xg_t.device
    res = _residual_buffers(dev, Tt, B, T, H, A, C, R, bf)
    kp = _kernel_plan_for(dev, B, T, H, A, C, R, bf).fwd
    plan, n_plan = _plan_args(kp)
    wl2 = _l2_buffer(kp, dev)
    lib = _build.load("dec_scan_fwd_bf16" if bf else "dec_scan_fwd")
    rc = lib.dec_scan_fwd_launch(
        ty_t.data_ptr(), xg_t.data_ptr(), s0.data_ptr(), ctx.data_ptr(),
        ctxp.data_ptr(), mask.data_ptr(), *(w.data_ptr() for w in weights),
        *(res[k].data_ptr() for k in ("s", "st", "c", "w", "q", "hg1", "xg2",
                                      "hg2", "t") + (BF16_COPIES if bf else ())),
        Tt, B, T, H, A, C, R, plan, n_plan, None if wl2 is None else wl2.data_ptr(),
        _timer_ptr(timers, 4 * Tt + 2), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dec_scan_fwd kernel launch failed: CUDA error {rc}")
    dec_scan_fwd.launches += 1
    dec_scan_fwd.grids += FWD_GRIDS
    dec_scan_fwd.bf16_launches += bf
    return res


def _residual_buffers(dev, Tt, B, T, H, A, C, R, bf16: bool):
    """Empty ``RESIDUALS`` (fp32) and, for bf16 streams, ``BF16_COPIES``."""
    shapes = {"t": (Tt, B, R), "s": (Tt + 1, B, H), "st": (Tt, B, H),
              "c": (Tt, B, C), "w": (Tt, B, T), "q": (Tt, B, A),
              "hg1": (Tt, B, 3 * H), "xg2": (Tt, B, 3 * H),
              "hg2": (Tt, B, 3 * H)}
    res = {k: torch.empty(v, dtype=torch.float32, device=dev)
           for k, v in shapes.items()}
    if bf16:
        res.update({k: torch.empty(shapes[k[:-1]], dtype=torch.bfloat16,
                                   device=dev) for k in BF16_COPIES})
    return res


def _replay(ty_t, xg_t, ctx, ctxp, mask, weights, states):
    """dec_scan_fwd(..., states=)'s kernel path (inputs checked): the
    states are res["s"], their bf16 copy a cast (s0 rounded)."""
    Tt, B, R = ty_t.shape
    _, T, C = ctx.shape
    H, A = states.shape[2], ctxp.shape[2]
    dev = xg_t.device
    res = _residual_buffers(dev, Tt, B, T, H, A, C, R, True)
    res["s"], res["sb"] = states, states.to(torch.bfloat16)
    rc = _build.load("dec_scan_fwd_bf16").dec_scan_replay_launch(
        ty_t.data_ptr(), xg_t.data_ptr(), states.data_ptr(),
        res["sb"].data_ptr(), ctx.data_ptr(), ctxp.data_ptr(), mask.data_ptr(),
        *(w.data_ptr() for w in weights),
        *(res[k].data_ptr() for k in ("st", "stb", "c", "cb", "w", "q", "hg1",
                                      "xg2", "hg2", "t")),
        Tt, B, T, H, A, C, R, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dec_scan_fwd replay launch failed: CUDA error {rc}")
    dec_scan_fwd.launches += 1
    dec_scan_fwd.grids += REPLAY_GRIDS
    dec_scan_fwd.bf16_launches += 1
    dec_scan_fwd.replays += 1
    return res


dec_scan_fwd.launches = 0
dec_scan_fwd.grids = 0
dec_scan_fwd.bf16_launches = 0
dec_scan_fwd.replays = 0

_BF16_DEFINES = {**_DEFINES, "VAG_BF16": 1}
for _name, _defines, _copies in (("dec_scan_fwd", _DEFINES, 0),
                                 ("dec_scan_fwd_bf16", _BF16_DEFINES, 3)):
    _build.declare(_name, "dec_scan_fwd_launch",
                   [ctypes.c_void_p] * (25 + _copies) + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
                   + [ctypes.c_void_p] * 3,
                   defines=_defines, src="dec_scan_fwd")
_build.declare("dec_scan_fwd_bf16", "dec_scan_replay_launch",
               [ctypes.c_void_p] * 27 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
               defines=_BF16_DEFINES, src="dec_scan_fwd")


def tanh_fast_probe(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tanh_fast(x), tanhf(x)) on the card: the attention energies' tanh
    (csrc/common.cuh) beside the accurate one, for chip_smoke.py's
    measurement of its error."""
    check_kernel_arg(x, torch.float32, tuple(x.shape), "tanh_fast_probe: x")
    fast, ref = torch.empty_like(x), torch.empty_like(x)
    rc = _build.load("dec_scan_fwd").dec_scan_tanh_probe(
        x.data_ptr(), fast.data_ptr(), ref.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tanh_fast_probe launch failed: CUDA error {rc}")
    return fast, ref


_build.declare("dec_scan_fwd", "dec_scan_tanh_probe",
               [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p],
               defines=_DEFINES)


def dec_scan_bwd_plain(res: Dict[str, torch.Tensor], xg_t, ctx, ctxp, mask,
                       weights: Sequence[torch.Tensor], g_t):
    """The plain PyTorch version of the backward kernel: the readout terms
    over all steps at once, then the reverse loop with the phases of the
    JAX package's ``pallas_dec_scan._bwd_kernel`` (readout, GRU2,
    attention, GRU1), then the weight grads as sums over all rows. Returns
    (dty, dxg1, ds0, dctx, dctxp, duh1, dbh1, dua, dva, dwi2, dbi2, duh2,
    dbh2, dws, dwc). bf16 streams: ``_dot``'s products (both operands of
    the weight grads rounded), dxg1 and dctx in bf16 and the matrices'
    grads rounded to bf16 once, after the fp32 sums."""
    uh1, bh1, ua, va, wi2, bi2, uh2, bh2, ws, wc = weights
    Tt, B, _ = xg_t.shape
    H = uh1.shape[0]
    f32 = torch.float32
    bf = xg_t.dtype == torch.bfloat16
    r = rbf if bf else (lambda x: x)
    ctx32 = ctx.to(f32)
    dpre = g_t * (1.0 - res["t"] * res["t"])
    ds_ro = _dot(dpre, ws.T)
    dc_all = _dot(dpre, wc.T)
    dxg1 = torch.empty_like(xg_t)
    dxg2 = torch.empty(xg_t.shape, dtype=f32, device=xg_t.device)
    dhg1 = torch.empty_like(dxg2)
    dhg2 = torch.empty_like(dxg2)
    dq = torch.empty_like(res["q"])
    dva_rows = torch.empty_like(res["q"])
    dctx = torch.zeros_like(ctx32)
    dctxp = torch.zeros_like(ctxp)
    ds = torch.zeros((B, H), dtype=torch.float32, device=xg_t.device)
    for t in range(Tt - 1, -1, -1):
        st, w, q = res["st"][t], res["w"][t], res["q"][t]
        # GRU2 (s~ -> s')
        dxg2[t], dhg2[t], dst = gru_cell_bwd_plain(res["xg2"][t], res["hg2"][t],
                                                   st, ds + ds_ro[t])
        dc = dc_all[t] + _dot(dxg2[t], wi2.T)
        dst = dst + _dot(dhg2[t], uh2.T)
        # attention
        dw = torch.bmm(ctx32, dc[:, :, None])[:, :, 0]          # (B, T)
        dctx += w[:, :, None] * dc[:, None, :]
        dsc = w * (dw - (w * dw).sum(-1, keepdim=True))
        dsc = torch.where(mask > 0, dsc, torch.zeros_like(dsc))
        e = torch.tanh(ctxp + q[:, None, :])
        da = (dsc[:, :, None] * va) * (1.0 - e * e)
        dctxp += da
        dq[t] = da.sum(1)
        dva_rows[t] = (e * dsc[:, :, None]).sum(1)
        dst = dst + _dot(dq[t], ua.T)
        # GRU1 (s -> s~)
        dxg1[t], dhg1[t], ds = gru_cell_bwd_plain(xg_t[t].to(f32),
                                                  res["hg1"][t], res["s"][t],
                                                  dst)
        ds = ds + _dot(dhg1[t], uh1.T)

    def rows(x):
        return x.reshape(Tt * B, -1)

    def atb(a, b, w):        # the grad of matrix w, in w's dtype
        return (r(rows(a)).T @ r(rows(b))).to(w.dtype)

    return (dpre, dxg1, ds, dctx.to(ctx.dtype), dctxp,
            atb(res["s"][:-1], dhg1, uh1), rows(dhg1).sum(0),
            atb(res["st"], dq, ua), rows(dva_rows).sum(0),
            atb(res["c"], dxg2, wi2), rows(dxg2).sum(0),
            atb(res["st"], dhg2, uh2), rows(dhg2).sum(0),
            atb(res["s"][1:], dpre, ws), atb(res["c"], dpre, wc))


def dec_scan_bwd(res: Dict[str, torch.Tensor], xg_t, ctx, ctxp, mask,
                 weights: Sequence[torch.Tensor], g_t, *, impl: str = "auto",
                 timers: Optional[torch.Tensor] = None):
    """Gradients of the decoder scan given the forward's residuals and the
    cotangent g_t (Tt, B, R) of the readout; returns what
    ``dec_scan_bwd_plain`` returns. One call of the kernel path enqueues
    BWD_GRIDS grids (the recurrence is one cooperative grid; see
    csrc/dec_scan_bwd.cu), which write every output: it counts one in
    ``dec_scan_bwd.launches`` and those in ``dec_scan_bwd.grids``. Raises
    when the plan or the launch fails. ``timers``: as dec_scan_fwd's.
    bf16 streams run the bf16 instance (``dec_scan_bwd.bf16_launches``;
    BWD_GRIDS_BF16 grids), which also reads the residuals' bf16 copies
    ``BF16_COPIES`` (every forward path returns them for bf16 streams) and
    raises without them."""
    if resolve_impl(impl, xg_t) == "plain":
        return dec_scan_bwd_plain(res, xg_t, ctx, ctxp, mask, weights, g_t)
    Tt, B, R = g_t.shape
    _, T, C = ctx.shape
    H = weights[0].shape[0]
    A = ctxp.shape[2]
    bf = _check_inputs("dec_scan_bwd", g_t, xg_t, res["s"][0], ctx, ctxp,
                       mask, weights, Tt, B, T, H, A, C, R)
    for k, shape in (("t", (Tt, B, R)), ("s", (Tt + 1, B, H)),
                     ("st", (Tt, B, H)), ("c", (Tt, B, C)), ("w", (Tt, B, T)),
                     ("q", (Tt, B, A)), ("hg1", (Tt, B, 3 * H)),
                     ("xg2", (Tt, B, 3 * H)), ("hg2", (Tt, B, 3 * H))):
        check_kernel_arg(res[k], torch.float32, shape, f"dec_scan_bwd: {k}")
        if bf and k + "b" in BF16_COPIES:
            if k + "b" not in res:
                raise ValueError(f"dec_scan_bwd: bf16 streams need the "
                                 f"residuals' bf16 copies ({k}b)")
            check_kernel_arg(res[k + "b"], torch.bfloat16, shape,
                             f"dec_scan_bwd: {k}b")
    dev = xg_t.device

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    plan = _kernel_plan_for(dev, B, T, H, A, C, R, bf).bwd
    uh1, _, ua, va, wi2, _, uh2, _, ws, wc = weights
    dty, ds0 = new(Tt, B, R), new(B, H)
    dxg1, dctx = torch.empty_like(xg_t), torch.empty_like(ctx)
    dctxp = new(B, T, A)
    dw = [torch.empty_like(w) for w in weights]
    duh1, dbh1, dua, dva, dwi2, dbi2, duh2, dbh2, dws, dwc = dw
    # ds_ro, dc, dxg2, dhg2, dhg1, dq, dva_rows, dscore, dstp, dst, dsp,
    # the column sums' row blocks
    scratch = (new(Tt, B, H), new(Tt, B, C), new(Tt, B, 3 * H),
               new(Tt, B, 3 * H), new(Tt, B, 3 * H), new(Tt, B, A),
               new(Tt, B, A), new(Tt, B, T), new(B, H), new(B, H), new(B, H),
               new(-(-Tt * B // plan.colsum_rows), 9 * H + A))
    if bf:   # the bf16 copies: the forward's, then dpre, dxg2, dhg2, dhg1, dq
        scratch += tuple(res[k] for k in BF16_COPIES) + tuple(
            torch.empty(shape, dtype=torch.bfloat16, device=dev) for shape in (
                (Tt, B, R), (Tt, B, 3 * H), (Tt, B, 3 * H), (Tt, B, 3 * H),
                (Tt, B, A)))
    args, n_plan = _plan_args(plan)
    wl2 = _l2_buffer(plan, dev)
    lib = _build.load("dec_scan_bwd_bf16" if bf else "dec_scan_bwd")
    ptrs = [g_t, res["t"], res["s"], res["st"], res["c"], res["w"], res["q"],
            res["hg1"], res["xg2"], res["hg2"], xg_t, ctx, ctxp, mask,
            uh1, ua, va, wi2, uh2, ws, wc,
            dty, dxg1, ds0, dctx, dctxp,
            duh1, dbh1, dua, dva, dwi2, dbi2, duh2, dbh2, dws, dwc, *scratch]
    rc = lib.dec_scan_bwd_launch(*(p.data_ptr() for p in ptrs),
                                 Tt, B, T, H, A, C, R, args, n_plan,
                                 None if wl2 is None else wl2.data_ptr(),
                                 _timer_ptr(timers, 4 * Tt + 2),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dec_scan_bwd kernel launch failed: CUDA error {rc}")
    dec_scan_bwd.launches += 1
    dec_scan_bwd.grids += BWD_GRIDS_BF16 if bf else BWD_GRIDS
    dec_scan_bwd.bf16_launches += bf
    return (dty, dxg1, ds0, dctx, dctxp, *dw)


dec_scan_bwd.launches = 0
dec_scan_bwd.grids = 0
dec_scan_bwd.bf16_launches = 0

for _name, _defines, _copies in (("dec_scan_bwd", _DEFINES, 0),
                                 ("dec_scan_bwd_bf16", _BF16_DEFINES, 8)):
    _build.declare(_name, "dec_scan_bwd_launch",
                   [ctypes.c_void_p] * (48 + _copies) + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
                   + [ctypes.c_void_p] * 3,
                   defines=_defines, src="dec_scan_bwd")


def _check_inputs(what, first, xg_t, s0, ctx, ctxp, mask, weights,
                  Tt, B, T, H, A, C, R) -> bool:
    """The kernels' argument checks; returns whether the streams are bf16
    (xg_t, ctx and the matrices all bf16; every other input fp32)."""
    shapes = {"uh1": (H, 3 * H), "bh1": (3 * H,), "ua": (H, A), "va": (A,),
              "wi2": (C, 3 * H), "bi2": (3 * H,), "uh2": (H, 3 * H),
              "bh2": (3 * H,), "ws": (H, R), "wc": (C, R)}
    bf = xg_t.dtype == torch.bfloat16
    sdt = torch.bfloat16 if bf else torch.float32
    check_kernel_arg(first, torch.float32, (Tt, B, R), f"{what}: ty/g")
    check_kernel_arg(xg_t, sdt, (Tt, B, 3 * H), f"{what}: xg_t")
    check_kernel_arg(s0, torch.float32, (B, H), f"{what}: s0")
    check_kernel_arg(ctx, sdt, (B, T, C), f"{what}: ctx")
    check_kernel_arg(ctxp, torch.float32, (B, T, A), f"{what}: ctxp")
    check_kernel_arg(mask, torch.float32, (B, T), f"{what}: mask")
    for name, w in zip(WEIGHTS, weights):
        check_kernel_arg(w, sdt if name in MATRICES else torch.float32,
                         shapes[name], f"{what}: {name}")
    return bf


class DecoderScan(torch.autograd.Function):
    """The decoder scan with its gradient: forward through ``dec_scan_fwd``,
    backward through ``dec_scan_bwd`` (counterpart of
    ``pallas_dec_scan._scan`` and its custom VJP). fp32 streams save the
    forward's residuals; bf16 streams save the states s' in bf16 alone, as
    the JAX kernel does, and the backward replays the steps from them
    (``dec_scan_fwd(..., states=)``) for the residuals it reads: each step
    from its saved state, none from another, so the replay runs as
    time-parallel grids over all Tt * B rows (no recurrence), counted in
    ``dec_scan_fwd.replays``."""

    @staticmethod
    def forward(ctx_, impl, ty_t, xg_t, s0, ctx, ctxp, mask, *weights):
        res = dec_scan_fwd(ty_t, xg_t, s0, ctx, ctxp, mask, weights,
                           impl=impl)
        ctx_.impl = impl
        kept = ((ty_t, s0, res["sb"][1:])
                if xg_t.dtype == torch.bfloat16 else
                tuple(res[k] for k in RESIDUALS))
        ctx_.save_for_backward(xg_t, ctx, ctxp, mask, *weights, *kept)
        return res["t"]

    @staticmethod
    def backward(ctx_, g_t):
        saved = ctx_.saved_tensors
        xg_t, ctx, ctxp, mask = saved[:4]
        weights = saved[4:4 + len(WEIGHTS)]
        kept = saved[4 + len(WEIGHTS):]
        if xg_t.dtype == torch.bfloat16:
            ty_t, s0, s_bf = kept
            states = torch.cat([s0[None], s_bf.to(torch.float32)])
            res = dec_scan_fwd(ty_t, xg_t, s0, ctx, ctxp, mask, weights,
                               impl=ctx_.impl, states=states)
        else:
            res = dict(zip(RESIDUALS, kept))
        dty, dxg1, ds0, dctx, dctxp, *dw = dec_scan_bwd(
            res, xg_t, ctx, ctxp, mask, weights, g_t.contiguous(),
            impl=ctx_.impl)
        return (None, dty, dxg1, ds0, dctx, dctxp, None, *dw)


def decoder_scan(params: Dict[str, Any], ty: torch.Tensor, xg1: torch.Tensor,
                 s0: torch.Tensor, ctx: torch.Tensor, ctx_proj: torch.Tensor,
                 src_mask: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """The teacher-forced GRU1 -> attention -> GRU2 -> readout recurrence
    over all Tt steps: ty (B, Tt, R) = y @ wy, xg1 (B, Tt, 3H) = y @ wi1 +
    bi1, s0 (B, H), ctx (B, T, C), ctx_proj (B, T, A) = ctx @ wa, src_mask
    (B, T). Returns the readout activations t_all (B, Tt, R), pre-dropout
    and before the vocab GEMM. With grad enabled it goes through
    ``DecoderScan``. No batch padding: the JAX package pads B to a multiple
    of 8 for the TPU's tile rules, which the CUDA kernels do not have.

    Under bf16 (ctx bf16) the streams follow ``pallas_decoder_scan``: xg
    and the six matrices cast to bf16 (with grad, the casts carry the
    grads back to the fp32 params), ctx kept bf16, ty_t, ctxpb and s0 in
    fp32; ``VAG_GRU_STREAM=fp32`` runs the fp32 streams (ctx cast up)."""
    r, at = params["readout"], params["attn"]
    f32 = torch.float32
    stream = (torch.bfloat16 if ctx.dtype == torch.bfloat16
              and not gru_stream_fp32() else f32)
    ty_t = (ty.transpose(0, 1) + r["b"]).to(f32).contiguous()
    ctxpb = (ctx_proj + at["ba"]).to(f32).contiguous()
    args = (ty_t, xg1.transpose(0, 1).to(stream).contiguous(),
            s0.to(f32).contiguous(), ctx.to(stream).contiguous(), ctxpb,
            src_mask.to(f32).contiguous())
    weights = tuple((w.to(stream) if name in MATRICES else w).contiguous()
                    for name, w in zip(WEIGHTS, scan_weights(params)))
    if torch.is_grad_enabled():
        t_t = DecoderScan.apply(impl, *args, *weights)
    else:
        t_t = dec_scan_fwd(*args, weights, impl=impl)["t"]
    return t_t.transpose(0, 1)
