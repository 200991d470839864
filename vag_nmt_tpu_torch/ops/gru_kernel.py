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
from typing import Optional

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


def gru_fwd(xg_t: torch.Tensor, mask_t: torch.Tensor, uh: torch.Tensor,
            bh: torch.Tensor, h0: torch.Tensor, *, reverse: bool = False,
            impl: str = "auto") -> torch.Tensor:
    """hs_t (T, B, H) of the masked GRU recurrence. impl: "auto" (kernel for
    CUDA tensors, plain for CPU tensors), "kernel" or "plain".

    One call of the kernel path enqueues the whole scan, one grid per time
    step (see csrc/gru_fwd.cu): it counts one in ``gru_fwd.launches`` and T
    in ``gru_fwd.grids``."""
    if resolve_impl(impl, xg_t) == "plain":
        return gru_fwd_plain(xg_t, mask_t, uh, bh, h0, reverse=reverse)
    T, B, H3 = xg_t.shape
    H = H3 // 3
    if H3 != 3 * H or H % 8:
        raise ValueError(f"gru_fwd: gate width {H3} must be 3*H with H a "
                         "multiple of 8")
    check_kernel_arg(xg_t, torch.float32, (T, B, 3 * H), "gru_fwd: xg_t")
    check_kernel_arg(mask_t, torch.float32, (T, B), "gru_fwd: mask_t")
    check_kernel_arg(uh, torch.float32, (H, 3 * H), "gru_fwd: uh")
    check_kernel_arg(bh, torch.float32, (3 * H,), "gru_fwd: bh")
    check_kernel_arg(h0, torch.float32, (B, H), "gru_fwd: h0")
    out = torch.empty((T, B, H), dtype=torch.float32, device=xg_t.device)
    lib = _build.load("gru_fwd")
    rc = lib.gru_fwd_launch(
        xg_t.data_ptr(), mask_t.data_ptr(), uh.data_ptr(), bh.data_ptr(),
        h0.data_ptr(), out.data_ptr(), T, B, H, int(reverse),
        torch.cuda.current_stream(xg_t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gru_fwd kernel launch failed: CUDA error {rc}")
    gru_fwd.launches += 1
    gru_fwd.grids += T
    return out


gru_fwd.launches = 0
gru_fwd.grids = 0

_build.declare("gru_fwd", "gru_fwd_launch",
               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


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
