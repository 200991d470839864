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
(T, B, H). Gate math and the carry are fp32.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from vag_nmt_tpu_torch.core.device import check_kernel_arg, resolve_impl
from vag_nmt_tpu_torch.ops import _build


def gru_gate_algebra(xg: torch.Tensor, hg: torch.Tensor,
                     h: torch.Tensor) -> torch.Tensor:
    """GRU gates on precomputed pre-activations (reset gate after the hidden
    matmul, as cuDNN and the JAX package): xg/hg (N, 3H), h (N, H)."""
    H = h.shape[-1]
    r = torch.sigmoid(xg[:, :H] + hg[:, :H])
    z = torch.sigmoid(xg[:, H:2 * H] + hg[:, H:2 * H])
    n = torch.tanh(xg[:, 2 * H:] + r * hg[:, 2 * H:])
    return (1.0 - z) * n + z * h


def gru_fwd_plain(xg_t: torch.Tensor, mask_t: torch.Tensor, uh: torch.Tensor,
                  bh: torch.Tensor, h0: torch.Tensor, *,
                  reverse: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel: one step per loop turn."""
    T = xg_t.shape[0]
    out = torch.empty(xg_t.shape[:2] + (uh.shape[0],), dtype=torch.float32,
                      device=xg_t.device)
    h = h0
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_new = gru_gate_algebra(xg_t[t], h @ uh + bh, h)
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
    memory in ``chunk``-deep slices."""

    rows_per_thread: int
    row_block: int
    unit_block: int
    chunk: int
    row_blocks: int
    row_slots: int
    unit_tiles: int

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.row_slots, self.unit_tiles)

    @property
    def threads(self) -> int:
        return (self.row_block // self.rows_per_thread) * (self.unit_block // 2)

    @property
    def smem_bytes(self) -> int:
        return gru_fwd_smem_bytes(self.unit_block * self.unit_tiles,
                                  self.row_block, self.unit_block, self.chunk)

    @property
    def passes(self) -> int:
        """Row blocks a CTA walks per step."""
        return -(-self.row_blocks // self.row_slots)


def gru_fwd_smem_bytes(H: int, row_block: int, unit_block: int,
                       chunk: int) -> int:
    """Dynamic shared memory of one CTA: its Uh slice (H x 3*unit_block)
    and GRU_STAGES staged chunks of row_block state rows (the layout of
    csrc/gru_fwd.cu, whose launcher sizes it the same way)."""
    return 4 * (H * 3 * unit_block + GRU_STAGES * row_block * (chunk + GRU_PAD))


@functools.lru_cache(maxsize=256)
def gru_fwd_plan(B: int, H: int, n_sms: int, max_smem: int) -> GruFwdPlan:
    """The co-resident tiling (one CTA per SM at most) of a (B, H) scan
    with the least work per CTA and step (passes x rows x units), ties
    going to fewer passes (more rows a thread), then more threads, then
    fewer L2 reads of the state (fewer unit tiles), then deeper chunks. On
    the H100 this spreads the rows over every CTA the unit tiles leave room
    for; at the decode shape it gives up about 2% against twice the unit
    tiles of half the width to halve the L2 reads of the state (PERF.md).
    Raises ValueError when no tiling fits ``n_sms`` SMs and ``max_smem``
    bytes of shared memory a block, or H is not a multiple of 16."""
    if B < 1 or H < 16 or H % 16:
        raise ValueError(f"gru_fwd: H={H} must be a positive multiple of 16 "
                         f"(and B={B} positive)")
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
                              and gru_fwd_smem_bytes(H, rb, ub, c) <= max_smem),
                             None)
                if chunk is None:
                    continue
                row_blocks, unit_tiles = -(-B // rb), H // ub
                plan = GruFwdPlan(R, rb, ub, chunk, row_blocks,
                                  min(row_blocks, n_sms // unit_tiles),
                                  unit_tiles)
                key = (plan.passes * rb * ub, plan.passes, -threads,
                       unit_tiles, -chunk)
                if best_key is None or key < best_key:
                    best, best_key = plan, key
    if best is None:
        raise ValueError(f"gru_fwd: no co-resident tiling of B={B}, H={H} "
                         f"on {n_sms} SMs with {max_smem} bytes of shared "
                         "memory a block")
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
    gru_fwd_launch) tiled by ``plan``; returns hs_t. Raises when the
    launcher refuses the plan (not co-resident, malformed) or the launch
    fails."""
    T, B, H3 = xg_t.shape
    out = torch.empty((T, B, H3 // 3), dtype=torch.float32, device=xg_t.device)
    rc = fn(xg_t.data_ptr(), mask_t.data_ptr(), uh.data_ptr(), bh.data_ptr(),
            h0.data_ptr(), out.data_ptr(), T, B, H3 // 3, int(reverse),
            plan.rows_per_thread, plan.row_block, plan.unit_block, plan.chunk,
            plan.row_slots, torch.cuda.current_stream(xg_t.device).cuda_stream)
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
    ``gru_fwd.grids``. A plan the card cannot hold co-resident raises."""
    if resolve_impl(impl, xg_t) == "plain":
        return gru_fwd_plain(xg_t, mask_t, uh, bh, h0, reverse=reverse)
    T, B, H3 = xg_t.shape
    H = H3 // 3
    if H3 != 3 * H:
        raise ValueError(f"gru_fwd: gate width {H3} must be 3*H")
    check_kernel_arg(xg_t, torch.float32, (T, B, 3 * H), "gru_fwd: xg_t")
    check_kernel_arg(mask_t, torch.float32, (T, B), "gru_fwd: mask_t")
    check_kernel_arg(uh, torch.float32, (H, 3 * H), "gru_fwd: uh")
    check_kernel_arg(bh, torch.float32, (3 * H,), "gru_fwd: bh")
    check_kernel_arg(h0, torch.float32, (B, H), "gru_fwd: h0")
    plan = gru_fwd_plan(B, H, *_device_limits(xg_t.device))
    out = _launch(_build.load("gru_fwd").gru_fwd_launch, plan, xg_t, mask_t,
                  uh, bh, h0, reverse)
    gru_fwd.launches += 1
    gru_fwd.grids += 1
    return out


gru_fwd.launches = 0
gru_fwd.grids = 0

_GRU_DEFINES = {"VAG_GRU_STAGES": GRU_STAGES, "VAG_GRU_PAD": GRU_PAD}
_build.declare("gru_fwd", "gru_fwd_launch",
               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
               _GRU_DEFINES)
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
    states. Returns (dxg_t (T, B, 3H), duh (H, 3H), dbh (3H,), dh0 (B, H))."""
    T = xg_t.shape[0]
    hprev = _prev_states(hs_t, h0, reverse)
    dxg = torch.empty_like(xg_t)
    duh = torch.zeros_like(uh)
    dbh = torch.zeros_like(bh)
    dh = torch.zeros_like(h0)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        hg = hprev[t] @ uh + bh
        dh = dh + g_t[t]
        dxg[t], dhg, base = gru_cell_bwd_plain(xg_t[t], hg, hprev[t], dh,
                                               mask_t[t][:, None])
        dh = base + dhg @ uh.T
        duh += hprev[t].T @ dhg
        dbh += dhg.sum(0)
    return dxg, duh, dbh, dh


def gru_bwd(xg_t: torch.Tensor, mask_t: torch.Tensor, uh: torch.Tensor,
            bh: torch.Tensor, h0: torch.Tensor, hs_t: torch.Tensor,
            g_t: torch.Tensor, *, reverse: bool = False, impl: str = "auto"):
    """Gradients of the masked GRU scan: (dxg_t, duh, dbh, dh0) given the
    forward's inputs, its states hs_t and their cotangent g_t (T, B, H).
    impl as gru_fwd. One call of the kernel path enqueues 2T + 3 device
    grids and a memset (see csrc/gru_bwd.cu): it counts one in
    ``gru_bwd.launches`` and the grids in ``gru_bwd.grids``."""
    if resolve_impl(impl, xg_t) == "plain":
        return gru_bwd_plain(xg_t, mask_t, uh, bh, h0, hs_t, g_t,
                             reverse=reverse)
    T, B, H3 = xg_t.shape
    H = H3 // 3
    check_kernel_arg(xg_t, torch.float32, (T, B, 3 * H), "gru_bwd: xg_t")
    check_kernel_arg(mask_t, torch.float32, (T, B), "gru_bwd: mask_t")
    check_kernel_arg(uh, torch.float32, (H, 3 * H), "gru_bwd: uh")
    check_kernel_arg(bh, torch.float32, (3 * H,), "gru_bwd: bh")
    check_kernel_arg(h0, torch.float32, (B, H), "gru_bwd: h0")
    check_kernel_arg(hs_t, torch.float32, (T, B, H), "gru_bwd: hs_t")
    check_kernel_arg(g_t, torch.float32, (T, B, H), "gru_bwd: g_t")
    hprev = _prev_states(hs_t, h0, reverse)
    hg = torch.empty_like(xg_t)
    dhg = torch.empty_like(xg_t)
    dxg = torch.empty_like(xg_t)
    dh0 = torch.empty_like(h0)
    duh = torch.empty_like(uh)
    dbh = torch.empty_like(bh)
    lib = _build.load("gru_bwd")
    split_k, _keep = _build.workspace_args(xg_t.device)
    rc = lib.gru_bwd_launch(
        xg_t.data_ptr(), mask_t.data_ptr(), uh.data_ptr(), bh.data_ptr(),
        hprev.data_ptr(), g_t.data_ptr(), hg.data_ptr(), dhg.data_ptr(),
        dxg.data_ptr(), dh0.data_ptr(), duh.data_ptr(), dbh.data_ptr(),
        T, B, H, int(reverse), *split_k,
        torch.cuda.current_stream(xg_t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gru_bwd kernel launch failed: CUDA error {rc}")
    gru_bwd.launches += 1
    gru_bwd.grids += 2 * T + 3
    return dxg, duh, dbh, dh0


gru_bwd.launches = 0
gru_bwd.grids = 0

_build.declare("gru_bwd", "gru_bwd_launch",
               [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
               + _build.WORKSPACE_ARGTYPES + [ctypes.c_void_p])


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
