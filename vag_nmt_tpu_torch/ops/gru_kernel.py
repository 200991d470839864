"""Masked GRU recurrence, forward and backward: the hand-written CUDA
kernels (``csrc/gru_fwd.cu``, ``csrc/gru_bwd.cu``), their plain PyTorch
versions, the wrappers that pick between them by the tensors' device, and
``GRUScan``, the ``torch.autograd.Function`` that joins the two.

Counterpart of the JAX package's ``ops/pallas_gru.py`` (``_fwd_kernel`` and
``_bwd_kernel`` via ``pallas_gru_scan`` and its custom VJP). As there, the
time-parallel input projection ``xg = x @ Wi + bi`` is one matmul outside
the kernels; the forward owns the sequential part: per step
``hg = h @ Uh + bh``, the gate algebra, and the carry-through mask (at a
masked step the state is held and written out unchanged). Tensors are
time-major: ``xg_t`` (T, B, 3H), ``mask_t`` (T, B), output ``hs_t``
(T, B, H). Gate math and the carry are fp32; the backward kernel's
products run as three TF32 products on the tensor cores (3xTF32).

The streams' dtype picks the numerics, as in ``pallas_gru.py`` (whose
stream dtype is the compute dtype unless ``VAG_GRU_STREAM=fp32``): with
``xg_t`` in bf16 the states leave in bf16 (``hs_t``), the cotangents
arrive and ``dxg_t`` leaves in bf16, and every product is bf16 x bf16 ->
fp32 (``h.astype(bf16) @ uh.astype(bf16)``), through the kernels' bf16
instances (builds ``gru_fwd_bf16``, ``gru_bwd_bf16``); the carry, the gate
math, dUh, dbh and dh0 stay fp32.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch

from vag_nmt_tpu_torch.core.device import check_kernel_arg, resolve_impl
from vag_nmt_tpu_torch.ops import _build
from vag_nmt_tpu_torch.ops.scan_tiles import _DEFINES as _SCAN_DEFINES
from vag_nmt_tpu_torch.ops.scan_tiles import ScanProduct, _product_options, _up


def gru_gate_algebra(xg: torch.Tensor, hg: torch.Tensor,
                     h: torch.Tensor) -> torch.Tensor:
    """GRU gates on precomputed pre-activations (reset gate after the hidden
    matmul, as cuDNN and the JAX package): xg/hg (N, 3H), h (N, H)."""
    H = h.shape[-1]
    r = torch.sigmoid(xg[:, :H] + hg[:, :H])
    z = torch.sigmoid(xg[:, H:2 * H] + hg[:, H:2 * H])
    n = torch.tanh(xg[:, 2 * H:] + r * hg[:, 2 * H:])
    return (1.0 - z) * n + z * h


def rbf(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even, as JAX's astype), in fp32: a
    product of two such values is exact in fp32, so ``rbf(a) @ rbf(b)``
    is the bf16 x bf16 -> fp32 product of the bf16 instances."""
    return x.to(torch.bfloat16).to(torch.float32)


def gru_fwd_plain(xg_t: torch.Tensor, mask_t: torch.Tensor, uh: torch.Tensor,
                  bh: torch.Tensor, h0: torch.Tensor, *,
                  reverse: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel: one step per loop turn.
    bf16 ``xg_t``: hg = rbf(h) @ rbf(uh) + bh, the carry fp32, hs_t in
    bf16."""
    T = xg_t.shape[0]
    bf = xg_t.dtype == torch.bfloat16
    out = torch.empty(xg_t.shape[:2] + (uh.shape[0],), dtype=xg_t.dtype,
                      device=xg_t.device)
    w = rbf(uh) if bf else uh
    h = h0.to(torch.float32)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hg = (rbf(h) if bf else h) @ w + bh
        h_new = gru_gate_algebra(xg_t[t].to(torch.float32), hg, h)
        h = torch.where(mask_t[t][:, None] > 0, h_new, h)
        out[t] = h
    return out


# The kernel's ring of state chunks and the padding after each staged row
# (floats), passed to csrc/gru_fwd.cu as -D defines so the plan below and
# the kernel agree on its shared memory.
GRU_STAGES = 3
GRU_PAD = 4
# The kernel's instantiations (rows a thread; each also holds 2 units),
# block sizes and state chunk depths the plan chooses from.
_ROWS_PER_THREAD = (8, 4, 2, 1)
_THREADS = (256, 128)
_CHUNKS = (128, 64, 32, 16)


@dataclass(frozen=True)
class GruFwdPlan:
    """Tiling of one persistent ``gru_fwd`` launch: a grid of
    (row_slots, unit_tiles) CTAs. CTA (x, y) owns the ``unit_block``
    hidden units y*unit_block.. (all three gate columns
    ``uh[:, g*H + unit]``) and, each step, the row blocks x, x + row_slots,
    ... of the ``row_blocks`` blocks of ``row_block`` rows; a thread holds
    ``rows_per_thread`` rows x 2 units. The state streams through shared
    memory in ``chunk``-deep slices. The CTA's Uh slice sits in shared
    memory, or with ``l2`` in a device buffer of 3 H^2 floats (one slice a
    unit tile), its chunks staged through the ring with the state."""

    rows_per_thread: int
    row_block: int
    unit_block: int
    chunk: int
    row_blocks: int
    row_slots: int
    unit_tiles: int
    l2: bool = False

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.row_slots, self.unit_tiles)

    @property
    def threads(self) -> int:
        return (self.row_block // self.rows_per_thread) * (self.unit_block // 2)

    @property
    def smem_bytes(self) -> int:
        return gru_fwd_smem_bytes(self.unit_block * self.unit_tiles,
                                  self.row_block, self.unit_block, self.chunk,
                                  l2=self.l2)

    @property
    def passes(self) -> int:
        """Row blocks a CTA walks per step."""
        return -(-self.row_blocks // self.row_slots)


def gru_fwd_smem_bytes(H: int, row_block: int, unit_block: int,
                       chunk: int, *, l2: bool = False) -> int:
    """Dynamic shared memory of one CTA: its Uh slice (H x 3*unit_block)
    and GRU_STAGES staged chunks of row_block state rows; with ``l2`` no
    slice, and each stage also holds the slice's chunk (chunk x
    3*unit_block). The layout of csrc/gru_fwd.cu, whose launcher sizes it
    the same way."""
    ring = row_block * (chunk + GRU_PAD)
    if l2:
        return 4 * GRU_STAGES * (ring + chunk * 3 * unit_block)
    return 4 * (H * 3 * unit_block + GRU_STAGES * ring)


def padded_width(H: int) -> int:
    """The width the kernel runs a scan of width H at: H rounded up to a
    multiple of 16 (``gru_fwd`` zero-pads the units in between)."""
    return -(-H // 16) * 16


def pad_units(xg_t: torch.Tensor, uh: torch.Tensor, bh: torch.Tensor,
              h0: torch.Tensor, Hp: int):
    """The scan's inputs at width Hp >= H, each gate's block of units
    zero-padded: xg_t (T, B, 3Hp), uh (Hp, 3Hp), bh (3Hp,), h0 (B, Hp).
    Exact: a padded unit's gates see r = z = 1/2 and n = tanh(0) = 0, so it
    stays 0 from h0 = 0 on, and its zero rows of uh add nothing to a real
    unit's sum."""
    H = h0.shape[-1]

    def gates(x, rows_too=False):
        x = x.reshape(*x.shape[:-1], 3, H)
        x = torch.nn.functional.pad(x, (0, Hp - H))
        x = x.reshape(*x.shape[:-2], 3 * Hp)
        if rows_too:
            x = torch.nn.functional.pad(x, (0, 0, 0, Hp - H))
        return x.contiguous()

    return (gates(xg_t), gates(uh, rows_too=True), gates(bh),
            torch.nn.functional.pad(h0, (0, Hp - H)).contiguous())


@functools.lru_cache(maxsize=256)
def gru_fwd_plan(B: int, H: int, n_sms: int, max_smem: int) -> GruFwdPlan:
    """The co-resident tiling (one CTA per SM at most) of a (B, H) scan
    with the least work per CTA and step (passes x rows x units), ties
    going to fewer passes (more rows a thread), then more threads, then
    fewer L2 reads of the state (fewer unit tiles), then deeper chunks. On
    the H100 this spreads the rows over every CTA the unit tiles leave room
    for; at the decode shape it gives up about 2% against twice the unit
    tiles of half the width to halve the L2 reads of the state (PERF.md).
    Where no tiling holds its Uh slice in shared memory (every H >= 1280
    on the H100), the tilings whose slices sit in L2 (``l2``: their
    chunks staged through the ring), the fewest clocks of the busiest
    CTA a step first (its multiply-adds against its L2 reads, which a
    small row block makes the larger), then as above. Raises ValueError
    when no tiling fits ``n_sms`` SMs and ``max_smem`` bytes of shared
    memory a block, or H is not a multiple of 16 (``gru_fwd`` pads it)."""
    if B < 1 or H < 16 or H % 16:
        raise ValueError(f"gru_fwd: H={H} must be a positive multiple of 16 "
                         f"(and B={B} positive)")
    for l2 in (False, True):
        best = _best_fwd_tiling(B, H, n_sms, max_smem, l2)
        if best is not None:
            return best
    raise ValueError(f"gru_fwd: no co-resident tiling of B={B}, H={H} "
                     f"on {n_sms} SMs with {max_smem} bytes of shared "
                     "memory a block")


def _best_fwd_tiling(B: int, H: int, n_sms: int, max_smem: int,
                     l2: bool) -> Optional[GruFwdPlan]:
    """gru_fwd_plan's search with Uh's slices resident or (``l2``) in L2."""
    best, best_key = None, None
    for R in _ROWS_PER_THREAD:
        for threads in _THREADS:
            for ug in (32, 16, 8, 4, 2, 1):
                rg = threads // ug
                ub, rb = 2 * ug, R * rg
                if H % ub or H // ub > n_sms:
                    continue
                # The deepest chunk that fits, leaving at least 4 a step for
                # the ring to overlap (bar the shallowest); whole chunk rows
                # per pass of the block's threads.
                chunk = next((c for c in _CHUNKS if H % c == 0
                              and (H // c >= 4 or c == 16)
                              and threads % (c // 4) == 0
                              and gru_fwd_smem_bytes(H, rb, ub, c, l2=l2)
                              <= max_smem),
                             None)
                if chunk is None:
                    continue
                row_blocks, unit_tiles = -(-B // rb), H // ub
                plan = GruFwdPlan(R, rb, ub, chunk, row_blocks,
                                  min(row_blocks, n_sms // unit_tiles),
                                  unit_tiles, l2)
                key = (plan.passes * rb * ub, plan.passes, -threads,
                       unit_tiles, -chunk)
                if l2:
                    # each pass reads the CTA's slice (3 ub H floats) and
                    # its rows' state (rb H) through L2: the busiest CTA's
                    # step in SM clocks, at 128 FMA and ~64 L2 bytes a clock
                    clocks = plan.passes * max(
                        rb * 3 * ub * H / 128, 4 * (3 * ub + rb) * H / 64)
                    key = (clocks,) + key
                if best_key is None or key < best_key:
                    best, best_key = plan, key
    return best


_LIMITS: Dict[int, Tuple[int, int]] = {}


def _device_limits(device: torch.device) -> Tuple[int, int]:
    """(SM count, opt-in shared memory of a block) of a CUDA device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _LIMITS:
        n, smem = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(idx):
            rc = _build.load("gru_fwd").gru_fwd_limits(ctypes.byref(n),
                                                       ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"gru_fwd: reading the device limits failed: "
                               f"CUDA error {rc}")
        _LIMITS[idx] = (n.value, smem.value)
    return _LIMITS[idx]


def _launch(fn, plan: GruFwdPlan, xg_t: torch.Tensor, mask_t: torch.Tensor,
            uh: torch.Tensor, bh: torch.Tensor, h0: torch.Tensor,
            reverse: bool) -> torch.Tensor:
    """Enqueue one scan through C entry ``fn`` (csrc/gru_fwd.cu's
    gru_fwd_launch) tiled by ``plan`` (with ``plan.l2``, a scratch buffer
    of 3 H^2 floats for Uh's slices); returns hs_t. A bf16 ``xg_t`` goes
    to the bf16 instance's entry with its carry buffers and h0 rounded
    (``uh`` already rounded by the caller). Raises when the launcher
    refuses the plan (not co-resident, malformed) or the launch fails."""
    T, B, H3 = xg_t.shape
    dev = xg_t.device
    out = torch.empty((T, B, H3 // 3), dtype=xg_t.dtype, device=dev)
    wl2 = (torch.empty(uh.numel(), dtype=torch.float32, device=dev)
           if plan.l2 else None)
    extra = ()
    if xg_t.dtype == torch.bfloat16:   # hc, ps (the carry, its rounding), h0r
        carry = torch.empty((2, 2, B, H3 // 3), dtype=torch.float32, device=dev)
        h0r = rbf(h0).contiguous()
        extra = (carry[0].data_ptr(), carry[1].data_ptr(), h0r.data_ptr())
    rc = fn(xg_t.data_ptr(), mask_t.data_ptr(), uh.data_ptr(), bh.data_ptr(),
            h0.data_ptr(), out.data_ptr(),
            None if wl2 is None else wl2.data_ptr(), T, B, H3 // 3,
            int(reverse), plan.rows_per_thread, plan.row_block,
            plan.unit_block, plan.chunk, plan.row_slots, int(plan.l2),
            torch.cuda.current_stream(dev).cuda_stream, *extra)
    if rc != 0:
        raise RuntimeError(f"gru_fwd kernel launch failed: CUDA error {rc} "
                           f"(plan {plan})")
    return out


def gru_fwd(xg_t: torch.Tensor, mask_t: torch.Tensor, uh: torch.Tensor,
            bh: torch.Tensor, h0: torch.Tensor, *, reverse: bool = False,
            impl: str = "auto") -> torch.Tensor:
    """hs_t (T, B, H) of the masked GRU recurrence. impl: "auto" (kernel for
    CUDA tensors, plain for CPU tensors), "kernel" or "plain".

    One call of the kernel path enqueues the whole scan as one persistent
    cooperative grid (see csrc/gru_fwd.cu) tiled by ``gru_fwd_plan`` for
    this card: it counts one in ``gru_fwd.launches`` and one in
    ``gru_fwd.grids``. A width that is no multiple of 16 runs zero-padded
    to ``padded_width(H)`` (``pad_units``, exact), the output cut back. A
    plan the card cannot hold co-resident raises. A bf16 ``xg_t`` runs the
    bf16-stream instance (``gru_fwd.bf16_launches`` counts those calls)
    and returns hs_t in bf16."""
    if resolve_impl(impl, xg_t) == "plain":
        return gru_fwd_plain(xg_t, mask_t, uh, bh, h0, reverse=reverse)
    T, B, H3 = xg_t.shape
    H = H3 // 3
    if H3 != 3 * H:
        raise ValueError(f"gru_fwd: gate width {H3} must be 3*H")
    bf = xg_t.dtype == torch.bfloat16
    check_kernel_arg(xg_t, torch.bfloat16 if bf else torch.float32,
                     (T, B, 3 * H), "gru_fwd: xg_t")
    check_kernel_arg(mask_t, torch.float32, (T, B), "gru_fwd: mask_t")
    check_kernel_arg(uh, torch.float32, (H, 3 * H), "gru_fwd: uh")
    check_kernel_arg(bh, torch.float32, (3 * H,), "gru_fwd: bh")
    check_kernel_arg(h0, torch.float32, (B, H), "gru_fwd: h0")
    Hp = padded_width(H)
    if Hp != H:
        xg_t, uh, bh, h0 = pad_units(xg_t, uh, bh, h0, Hp)
    if bf:
        uh = rbf(uh).contiguous()   # the product's operand, exact in fp32
    plan = gru_fwd_plan(B, Hp, *_device_limits(xg_t.device))
    lib = _build.load("gru_fwd_bf16" if bf else "gru_fwd")
    out = _launch(lib.gru_fwd_launch, plan, xg_t, mask_t, uh, bh, h0, reverse)
    gru_fwd.launches += 1
    gru_fwd.grids += 1
    gru_fwd.bf16_launches += bf
    return out if Hp == H else out[..., :H].contiguous()


gru_fwd.launches = 0
gru_fwd.grids = 0
gru_fwd.bf16_launches = 0

_GRU_DEFINES = {"VAG_GRU_STAGES": GRU_STAGES, "VAG_GRU_PAD": GRU_PAD}
_GRU_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_build.declare("gru_fwd", "gru_fwd_launch", _GRU_FWD_ARGS, _GRU_DEFINES)
# the bf16-stream instance: the same source, its entry takes the carry
# buffers hc, ps and the rounded h0 after the stream
_build.declare("gru_fwd_bf16", "gru_fwd_launch",
               _GRU_FWD_ARGS + [ctypes.c_void_p] * 3,
               {**_GRU_DEFINES, "VAG_BF16": 1}, src="gru_fwd")
_build.declare("gru_fwd", "gru_fwd_limits",
               [ctypes.POINTER(ctypes.c_int)] * 2, _GRU_DEFINES)


def gru_cell_bwd_plain(xg: torch.Tensor, hg: torch.Tensor, h: torch.Tensor,
                       dh: torch.Tensor, m: Optional[torch.Tensor] = None):
    """Backward through one GRU cell, term for term as the JAX package's
    ``pallas_gru._bwd_kernel``: dh is the gradient of the new state (the
    carry plus this step's cotangent), m an optional (N, 1) 0/1 mask.
    Returns (dxg, dhg, dh_base) with dh_base = dh_cell*z + dh*(1-m); the
    caller adds ``dhg @ Uh^T``. A masked step sends all of dh to the carry
    and has dxg = 0."""
    H = h.shape[-1]
    r = torch.sigmoid(xg[:, :H] + hg[:, :H])
    z = torch.sigmoid(xg[:, H:2 * H] + hg[:, H:2 * H])
    hn = hg[:, 2 * H:]
    n = torch.tanh(xg[:, 2 * H:] + r * hn)
    dh_cell = dh if m is None else dh * m
    dn = dh_cell * (1.0 - z)
    dz = dh_cell * (h - n)
    da_n = dn * (1.0 - n * n)
    dr = da_n * hn
    da_r = dr * r * (1.0 - r)
    da_z = dz * z * (1.0 - z)
    dxg = torch.cat([da_r, da_z, da_n], dim=-1)
    dhg = torch.cat([da_r, da_z, da_n * r], dim=-1)
    base = dh_cell * z if m is None else dh_cell * z + dh * (1.0 - m)
    return dxg, dhg, base


def _prev_states(hs_t: torch.Tensor, h0: torch.Tensor,
                 reverse: bool) -> torch.Tensor:
    """(T, B, H): the state each step of the forward scan started from."""
    if reverse:
        return torch.cat([hs_t[1:], h0[None]], dim=0)
    return torch.cat([h0[None], hs_t[:-1]], dim=0)


def gru_bwd_plain(xg_t: torch.Tensor, mask_t: torch.Tensor, uh: torch.Tensor,
                  bh: torch.Tensor, h0: torch.Tensor, hs_t: torch.Tensor,
                  g_t: torch.Tensor, *, reverse: bool = False):
    """The plain PyTorch version of the backward kernel: an explicit loop
    against the scan order that recomputes each step's gates from the saved
    states. Returns (dxg_t (T, B, 3H), duh (H, 3H), dbh (3H,), dh0 (B, H)).
    bf16 streams (``pallas_gru._bwd_kernel`` at cdt = bf16): each product
    on operands rounded to bf16 (``rbf``), the cell backward, the carry and
    the sums in fp32, dxg_t in bf16."""
    T = xg_t.shape[0]
    bf = xg_t.dtype == torch.bfloat16
    f32 = torch.float32
    r = rbf if bf else (lambda x: x)
    hprev = _prev_states(hs_t.to(f32), h0.to(f32), reverse)
    w = r(uh)
    dxg = torch.empty_like(xg_t)
    duh = torch.zeros_like(uh)
    dbh = torch.zeros_like(bh)
    dh = torch.zeros(h0.shape, dtype=f32, device=h0.device)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        hg = r(hprev[t]) @ w + bh
        dh = dh + g_t[t].to(f32)
        dxg[t], dhg, base = gru_cell_bwd_plain(xg_t[t].to(f32), hg, hprev[t],
                                               dh, mask_t[t][:, None])
        dh = base + r(dhg) @ w.T
        duh += r(hprev[t]).T @ r(dhg)
        dbh += dhg.sum(0)
    return dxg, duh, dbh, dh


@dataclass(frozen=True)
class GruBwdPlan:
    """Tiling of the carry grid of one ``gru_bwd`` call (csrc/gru_bwd.cu):
    ``ctas`` CTAs (one a SM) and the per-step product dh += dhg @ Uh^T as
    ``product`` tiles it (Uh^T sliced by output unit, read transposed from
    the row-major uh: resident in shared memory from float 0 or, when
    ``l2_floats`` > 0, in a buffer of that many floats read through L2),
    the k-slices' accumulators at float ``scratch_off``, ``smem_bytes`` of
    dynamic shared memory."""

    ctas: int
    product: ScanProduct
    scratch_off: int
    smem_bytes: int
    l2_floats: int

    def launch_args(self) -> Tuple[int, ...]:
        return (self.ctas, self.scratch_off, self.smem_bytes, self.l2_floats,
                *self.product.launch_args())


@functools.lru_cache(maxsize=256)
def gru_bwd_plan(B: int, H: int, n_sms: int, max_smem: int,
                 bf16: bool = False) -> GruBwdPlan:
    """The carry's tiling of a (B, H) scan on a card of ``n_sms`` SMs with
    ``max_smem`` bytes of shared memory a block, among the product's
    tilings (``scan_tiles._product_options``: column tiles of Uh^T's output
    units, row parts, column slots): the slices resident where they and the
    accumulators fit, else in L2; then the least multiply-adds of the
    busiest CTA a step; then the fewest activation floats it reads from L2
    a step (tiles x rows x 3H: a CTA that owns all B rows reads all of
    dhg[t], so the row split is the same trade ``gru_fwd_plan`` makes);
    then fewer CTAs, then less shared memory. ``bf16``: the bf16-stream
    instance's plan (Uh^T's slices in bf16, half the floats). Raises
    ValueError where nothing fits (the accumulators alone beyond
    ``max_smem``) or a size is not positive."""
    if min(B, H, n_sms) < 1:
        raise ValueError(f"gru_bwd_plan: B={B}, H={H}, n_sms={n_sms} must be "
                         "positive")
    best, best_key = None, None
    for p in _product_options(("dh", 3 * H, H, False), B, H, n_sms, bf16):
        scratch = _up(p.part_floats, 32)
        region = _up(p.region_floats, 32)
        resident = 4 * (region + scratch) <= max_smem
        if not resident and 4 * scratch > max_smem:
            continue
        smem = 4 * (region + scratch) if resident else 4 * scratch
        key = (not resident, p.work, p.passes * p.tile_rows * p.depth,
               p.ctas, smem)
        if best_key is None or key < best_key:
            best_key = key
            best = (GruBwdPlan(n_sms, replace(p, woff=0), region, smem, 0)
                    if resident else
                    GruBwdPlan(n_sms, replace(p, l2off=0), 0, smem,
                               p.ctas * p.region_floats))
    if best is None:
        raise ValueError(f"gru_bwd_plan: the accumulators of B={B}, H={H} do "
                         f"not fit {max_smem} bytes of shared memory")
    return best


GRU_BWD_GRIDS = 3   # grids a call of the kernel enqueues


def gru_bwd(xg_t: torch.Tensor, mask_t: torch.Tensor, uh: torch.Tensor,
            bh: torch.Tensor, h0: torch.Tensor, hs_t: torch.Tensor,
            g_t: torch.Tensor, *, reverse: bool = False, impl: str = "auto"):
    """Gradients of the masked GRU scan: (dxg_t, duh, dbh, dh0) given the
    forward's inputs, its states hs_t and their cotangent g_t (T, B, H).
    impl as gru_fwd. One call of the kernel path enqueues GRU_BWD_GRIDS
    grids whatever T (the recompute, the carry as one persistent
    cooperative grid tiled by ``gru_bwd_plan``, the weight grads; see
    csrc/gru_bwd.cu): it counts one in ``gru_bwd.launches`` and those in
    ``gru_bwd.grids``. Raises when the plan or the launch fails (no
    fallback). bf16 streams (xg_t, hs_t, g_t) run the bf16-stream instance
    (counted in ``gru_bwd.bf16_launches``), Uh passed to it as bf16."""
    if resolve_impl(impl, xg_t) == "plain":
        return gru_bwd_plain(xg_t, mask_t, uh, bh, h0, hs_t, g_t,
                             reverse=reverse)
    T, B, H3 = xg_t.shape
    H = H3 // 3
    bf = xg_t.dtype == torch.bfloat16
    sdt = torch.bfloat16 if bf else torch.float32
    check_kernel_arg(xg_t, sdt, (T, B, 3 * H), "gru_bwd: xg_t")
    check_kernel_arg(mask_t, torch.float32, (T, B), "gru_bwd: mask_t")
    check_kernel_arg(uh, torch.float32, (H, 3 * H), "gru_bwd: uh")
    check_kernel_arg(bh, torch.float32, (3 * H,), "gru_bwd: bh")
    check_kernel_arg(h0, torch.float32, (B, H), "gru_bwd: h0")
    check_kernel_arg(hs_t, sdt, (T, B, H), "gru_bwd: hs_t")
    check_kernel_arg(g_t, sdt, (T, B, H), "gru_bwd: g_t")
    dev = xg_t.device
    plan = gru_bwd_plan(B, H, *_device_limits(dev), bf16=bf)
    # scratch: hg (h_prev @ Uh), dhg, base (the carry's direct part)
    f32 = torch.float32
    hg = torch.empty((T, B, 3 * H), dtype=f32, device=dev)
    dhg = torch.empty_like(hg)
    base = torch.empty_like(h0)
    dxg, dh0 = torch.empty_like(xg_t), torch.empty_like(h0)
    duh, dbh = torch.empty_like(uh), torch.empty_like(bh)
    wl2 = (torch.empty(plan.l2_floats, dtype=torch.float32, device=dev)
           if plan.l2_floats else None)
    args = plan.launch_args()
    w = uh.to(torch.bfloat16).contiguous() if bf else uh
    rc = _build.load("gru_bwd_bf16" if bf else "gru_bwd").gru_bwd_launch(
        *(x.data_ptr() for x in (xg_t, mask_t, w, bh, hs_t, h0, g_t, hg, dhg,
                                 base, dxg, dh0, duh, dbh)),
        T, B, H, int(reverse), (ctypes.c_int * len(args))(*args), len(args),
        None if wl2 is None else wl2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gru_bwd kernel launch failed: CUDA error {rc} "
                           f"(plan {plan})")
    gru_bwd.launches += 1
    gru_bwd.grids += GRU_BWD_GRIDS
    gru_bwd.bf16_launches += bf
    return dxg, duh, dbh, dh0


gru_bwd.launches = 0
gru_bwd.grids = 0
gru_bwd.bf16_launches = 0

for _name, _defines in (("gru_bwd", _SCAN_DEFINES),
                        ("gru_bwd_bf16", {**_SCAN_DEFINES, "VAG_BF16": 1})):
    _build.declare(_name, "gru_bwd_launch",
                   [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
                   + [ctypes.c_void_p] * 2, _defines, src="gru_bwd")


class GRUScan(torch.autograd.Function):
    """The masked GRU scan with its gradient: forward through ``gru_fwd``,
    backward through ``gru_bwd`` (counterpart of ``pallas_gru._scan`` and
    its custom VJP). Without it the kernel's output, written through
    ctypes, would carry no gradient at all."""

    @staticmethod
    def forward(ctx, xg_t, mask_t, uh, bh, h0, reverse: bool, impl: str):
        hs_t = gru_fwd(xg_t, mask_t, uh, bh, h0, reverse=reverse, impl=impl)
        ctx.save_for_backward(xg_t, mask_t, uh, bh, h0, hs_t)
        ctx.reverse, ctx.impl = reverse, impl
        return hs_t

    @staticmethod
    def backward(ctx, g_t):
        xg_t, mask_t, uh, bh, h0, hs_t = ctx.saved_tensors
        dxg, duh, dbh, dh0 = gru_bwd(xg_t, mask_t, uh, bh, h0, hs_t,
                                     g_t.contiguous(), reverse=ctx.reverse,
                                     impl=ctx.impl)
        return dxg, None, duh, dbh, dh0, None, None
