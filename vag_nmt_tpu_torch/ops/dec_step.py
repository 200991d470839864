"""Fused beam decode step, GRU1 -> attention -> GRU2 -> readout activations
(counterpart of the JAX package's ``ops/pallas_dec_step.py``): the
hand-written CUDA kernel ``csrc/dec_step.cu``, its plain PyTorch version,
the wrapper that picks between them by the tensors' device, and
``decode_step_fused``, the counterpart of ``pallas_decode_step``.

The step starts from the decode tables (``models/decoder.decode_tables``):
the ``gy`` row gather stays outside the kernel (a torch index, as the JAX
package keeps it in XLA), ``ba`` is folded into ``ctx_proj`` per call, and
the fused weight matrices ``w_s = [ua | uh2]`` and ``w_c = [wi2 | wc]``
compute the same per-column dot products as the PyTorch tabled step. The
kernel is not bit-identical to that step (its sums and softmax run in
another order), so the tests hold it to a tolerance.

Selected by ``VAG_DEC_STEP=on`` with decode tables (``core/knobs.py``),
default off as in the JAX package, whose default rests on a TPU
measurement; the kernel's own numbers are in PERF.md."""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Sequence, Tuple

import torch

from vag_nmt_tpu_torch.core.device import check_kernel_arg, resolve_impl
from vag_nmt_tpu_torch.ops import _build
from vag_nmt_tpu_torch.ops.gru_kernel import gru_gate_algebra

NEG_INF = -1e9          # as ops/attention.masked_softmax
MAX_K = 8               # beams per sentence the attention grid holds

WEIGHTS = ("uh1", "bh1", "w_s", "bh2", "va", "w_c", "bi2", "ws", "b")


def step_weights(params: Dict[str, Any],
                 tables: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The step's weights in ``WEIGHTS`` order, contiguous."""
    g1, g2, r = params["gru1"], params["gru2"], params["readout"]
    return tuple(w.contiguous() for w in (
        g1["uh"], g1["bh"], tables["w_s"], g2["bh"], params["attn"]["va"],
        tables["w_c"], g2["bi"], r["ws"], r["b"]))


def dec_step_plain(gy, s, ctx, ctxpb, mask,
                   weights: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, the JAX kernel's arithmetic
    in its order: gy (N, 3H + R), s (N, H) with N = B*K, ctx (B, T, C),
    ctxpb (B, T, A) = ctx_proj + ba, mask (B, T). Returns (s_new (N, H),
    t (N, R))."""
    uh1, bh1, w_s, bh2, va, w_c, bi2, ws, b = weights
    B, T, C = ctx.shape
    N, H = s.shape
    K = N // B
    A = w_s.shape[1] - 3 * H
    xg1, ty = gy[:, :3 * H], gy[:, 3 * H:]
    st = gru_gate_algebra(xg1, s @ uh1 + bh1, s)
    qh = st @ w_s
    q = qh[:, :A].reshape(B, K, A)
    e = torch.tanh(ctxpb[:, None, :, :] + q[:, :, None, :])    # (B, K, T, A)
    sc = (e * va).sum(-1)
    sc = torch.where(mask[:, None, :] > 0, sc, torch.full_like(sc, NEG_INF))
    w = torch.softmax(sc, dim=-1)
    c = torch.einsum("bkt,btc->bkc", w, ctx).reshape(N, C)
    xc = c @ w_c
    s_new = gru_gate_algebra(xc[:, :3 * H] + bi2, qh[:, A:] + bh2, st)
    t = torch.tanh(ty + s_new @ ws + xc[:, 3 * H:] + b)
    return s_new, t


def dec_step(gy, s, ctx, ctxpb, mask, weights: Sequence[torch.Tensor], *,
             impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """``dec_step_plain``'s contract. impl: "auto" (kernel for CUDA
    tensors, plain for CPU tensors), "kernel" or "plain". One call of the
    kernel path enqueues 8 grids (see csrc/dec_step.cu): it counts one in
    ``dec_step.launches`` and those in ``dec_step.grids``."""
    if resolve_impl(impl, s) == "plain":
        return dec_step_plain(gy, s, ctx, ctxpb, mask, weights)
    B, T, C = ctx.shape
    N, H = s.shape
    if N % B or not 1 <= N // B <= MAX_K:
        raise ValueError(f"dec_step kernel: {N} rows for {B} sentences "
                         f"(1..{MAX_K} beams each)")
    K = N // B
    A = weights[2].shape[1] - 3 * H
    R = weights[7].shape[1]
    G = 3 * H + R
    shapes = {"uh1": (H, 3 * H), "bh1": (3 * H,), "w_s": (H, A + 3 * H),
              "bh2": (3 * H,), "va": (A,), "w_c": (C, G), "bi2": (3 * H,),
              "ws": (H, R), "b": (R,)}
    for name, w in zip(WEIGHTS, weights):
        check_kernel_arg(w, torch.float32, shapes[name], f"dec_step: {name}")
    check_kernel_arg(gy, torch.float32, (N, G), "dec_step: gy")
    check_kernel_arg(s, torch.float32, (N, H), "dec_step: s")
    check_kernel_arg(ctx, torch.float32, (B, T, C), "dec_step: ctx")
    check_kernel_arg(ctxpb, torch.float32, (B, T, A), "dec_step: ctxpb")
    check_kernel_arg(mask, torch.float32, (B, T), "dec_step: mask")
    dev = s.device

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    s_new, t = new(N, H), new(N, R)
    scratch = (new(N, 3 * H), new(N, H), new(N, A + 3 * H), new(N, C),
               new(N, G))
    lib = _build.load("dec_step")
    split_k, _keep = _build.workspace_args(dev)
    rc = lib.dec_step_launch(
        gy.data_ptr(), s.data_ptr(), ctx.data_ptr(), ctxpb.data_ptr(),
        mask.data_ptr(), *(w.data_ptr() for w in weights), s_new.data_ptr(),
        t.data_ptr(), *(x.data_ptr() for x in scratch),
        B, K, T, H, A, C, R, *split_k,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dec_step kernel launch failed: CUDA error {rc}")
    dec_step.launches += 1
    dec_step.grids += 8
    return s_new, t


dec_step.launches = 0
dec_step.grids = 0

_build.declare("dec_step", "dec_step_launch",
               [ctypes.c_void_p] * 21 + [ctypes.c_int] * 7
               + _build.WORKSPACE_ARGTYPES + [ctypes.c_void_p],
               defines={"VAG_MAX_K": MAX_K})


def decode_step_fused(params: Dict[str, Any], tables: Dict[str, torch.Tensor],
                      tok: torch.Tensor, s: torch.Tensor, ctx: torch.Tensor,
                      ctx_proj: torch.Tensor, src_mask: torch.Tensor, *,
                      impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused beam decode step off the decode tables: tok (B, K), s
    (B, K, H), ctx (B, T, C), ctx_proj (B, T, A), src_mask (B, T). Returns
    (s_new (B, K, H), t (B*K, R)), the inputs of the fused readout top-K."""
    B, K = tok.shape
    H = s.shape[-1]
    gy = tables["gy"][tok.reshape(-1)]
    ctxpb = (ctx_proj + params["attn"]["ba"]).contiguous()
    s_new, t = dec_step(gy, s.reshape(B * K, H).contiguous(), ctx.contiguous(),
                        ctxpb, src_mask.to(torch.float32).contiguous(),
                        step_weights(params, tables), impl=impl)
    return s_new.reshape(B, K, H), t
