"""Masked GRU forward recurrence: the hand-written CUDA kernel
(``csrc/gru_fwd.cu``), its plain PyTorch version and the wrapper that picks
between them by the tensors' device.

Counterpart of the JAX package's ``ops/pallas_gru.py`` (``_fwd_kernel`` via
``pallas_gru_scan``). As there, the time-parallel input projection
``xg = x @ Wi + bi`` is one matmul outside the kernel; the kernel owns the
sequential part: per step ``hg = h @ Uh + bh``, the gate algebra, and the
carry-through mask (at a masked step the state is held and written out
unchanged). Tensors are time-major: ``xg_t`` (T, B, 3H), ``mask_t`` (T, B),
output ``hs_t`` (T, B, H). Gate math and the carry are fp32.
"""

from __future__ import annotations

import ctypes

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
