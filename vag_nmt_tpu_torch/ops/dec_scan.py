"""Teacher-forced decoder scan, forward and backward: the hand-written CUDA
kernels (``csrc/dec_scan_fwd.cu``, ``csrc/dec_scan_bwd.cu``), their plain
PyTorch versions, the wrappers that pick between them by the tensors'
device, ``DecoderScan`` (the ``torch.autograd.Function`` that joins them)
and ``decoder_scan``, the counterpart of the JAX package's
``ops/pallas_dec_scan.py::pallas_decoder_scan``.

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
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Sequence, Tuple

import torch

from vag_nmt_tpu_torch.core.device import check_kernel_arg, resolve_impl
from vag_nmt_tpu_torch.ops import _build
from vag_nmt_tpu_torch.ops.gru_kernel import gru_cell_bwd_plain, gru_gate_algebra

NEG_INF = -1e9          # as ops/attention.masked_softmax

WEIGHTS = ("uh1", "bh1", "ua", "va", "wi2", "bi2", "uh2", "bh2", "ws", "wc")
# t (Tt, B, R); s (Tt + 1, B, H) with s[0] = s0; st = s~ (Tt, B, H);
# c (Tt, B, C); w (Tt, B, T); q (Tt, B, A); hg1, xg2, hg2 (Tt, B, 3H)
RESIDUALS = ("t", "s", "st", "c", "w", "q", "hg1", "xg2", "hg2")


def scan_weights(params: Dict[str, Any]) -> Tuple[torch.Tensor, ...]:
    """The decoder's scan weights in ``WEIGHTS`` order."""
    g1, at, g2, r = (params["gru1"], params["attn"], params["gru2"],
                     params["readout"])
    return (g1["uh"], g1["bh"], at["ua"], at["va"], g2["wi"], g2["bi"],
            g2["uh"], g2["bh"], r["ws"], r["wc"])


def _attend(q, ctxp, ctx, mask, va):
    """One step of masked Bahdanau attention: (c (B, C), w (B, T))."""
    e = torch.tanh(ctxp + q[:, None, :])
    scores = torch.where(mask > 0, e @ va, torch.full_like(mask, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return torch.bmm(w[:, None, :], ctx)[:, 0], w


def dec_scan_fwd_plain(ty_t, xg_t, s0, ctx, ctxp, mask,
                       weights: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of the forward kernel: one step per loop
    turn, then the readout over all steps at once, as the kernel."""
    uh1, bh1, ua, va, wi2, bi2, uh2, bh2, ws, wc = weights
    out = {k: [] for k in RESIDUALS if k != "t"}
    s = s0
    out["s"].append(s0)
    for t in range(xg_t.shape[0]):
        hg1 = s @ uh1 + bh1
        st = gru_gate_algebra(xg_t[t], hg1, s)
        q = st @ ua
        hg2 = st @ uh2 + bh2
        c, w = _attend(q, ctxp, ctx, mask, va)
        xg2 = c @ wi2 + bi2
        s = gru_gate_algebra(xg2, hg2, st)
        for k, v in (("s", s), ("st", st), ("c", c), ("w", w), ("q", q),
                     ("hg1", hg1), ("xg2", xg2), ("hg2", hg2)):
            out[k].append(v)
    res = {k: torch.stack(v) for k, v in out.items()}
    pre = res["c"] @ wc
    pre = pre + res["s"][1:] @ ws
    res["t"] = torch.tanh(ty_t + pre)
    return res


def dec_scan_fwd(ty_t, xg_t, s0, ctx, ctxp, mask,
                 weights: Sequence[torch.Tensor], *,
                 impl: str = "auto") -> Dict[str, torch.Tensor]:
    """The readout t and the residuals of the decoder scan (``RESIDUALS``).
    impl: "auto" (kernel for CUDA tensors, plain for CPU tensors), "kernel"
    or "plain". One call of the kernel path enqueues 7 grids per step and 3
    after the loop (see csrc/dec_scan_fwd.cu): it counts one in
    ``dec_scan_fwd.launches`` and those in ``dec_scan_fwd.grids``."""
    if resolve_impl(impl, xg_t) == "plain":
        return dec_scan_fwd_plain(ty_t, xg_t, s0, ctx, ctxp, mask, weights)
    Tt, B, R = ty_t.shape
    _, T, C = ctx.shape
    H = s0.shape[1]
    A = ctxp.shape[2]
    _check_inputs("dec_scan_fwd", ty_t, xg_t, s0, ctx, ctxp, mask, weights,
                  Tt, B, T, H, A, C, R)
    dev = xg_t.device

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    res = {"t": new(Tt, B, R), "s": new(Tt + 1, B, H), "st": new(Tt, B, H),
           "c": new(Tt, B, C), "w": new(Tt, B, T), "q": new(Tt, B, A),
           "hg1": new(Tt, B, 3 * H), "xg2": new(Tt, B, 3 * H),
           "hg2": new(Tt, B, 3 * H)}
    res["s"][0].copy_(s0)
    lib = _build.load("dec_scan_fwd")
    split_k, _keep = _build.workspace_args(dev)
    rc = lib.dec_scan_fwd_launch(
        ty_t.data_ptr(), xg_t.data_ptr(), ctx.data_ptr(), ctxp.data_ptr(),
        mask.data_ptr(), *(w.data_ptr() for w in weights),
        *(res[k].data_ptr() for k in ("s", "st", "c", "w", "q", "hg1", "xg2",
                                      "hg2", "t")),
        Tt, B, T, H, A, C, R, *split_k,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dec_scan_fwd kernel launch failed: CUDA error {rc}")
    dec_scan_fwd.launches += 1
    dec_scan_fwd.grids += 7 * Tt + 3
    return res


dec_scan_fwd.launches = 0
dec_scan_fwd.grids = 0

_build.declare("dec_scan_fwd", "dec_scan_fwd_launch",
               [ctypes.c_void_p] * 24 + [ctypes.c_int] * 7
               + _build.WORKSPACE_ARGTYPES + [ctypes.c_void_p])


def dec_scan_bwd_plain(res: Dict[str, torch.Tensor], xg_t, ctx, ctxp, mask,
                       weights: Sequence[torch.Tensor], g_t):
    """The plain PyTorch version of the backward kernel: the readout terms
    over all steps at once, then the reverse loop with the phases of the
    JAX package's ``pallas_dec_scan._bwd_kernel`` (readout, GRU2,
    attention, GRU1), then the weight grads as sums over all rows. Returns
    (dty, dxg1, ds0, dctx, dctxp, duh1, dbh1, dua, dva, dwi2, dbi2, duh2,
    dbh2, dws, dwc)."""
    uh1, bh1, ua, va, wi2, bi2, uh2, bh2, ws, wc = weights
    Tt, B, _ = xg_t.shape
    H = uh1.shape[0]
    dpre = g_t * (1.0 - res["t"] * res["t"])
    ds_ro = dpre @ ws.T
    dc_all = dpre @ wc.T
    dxg1 = torch.empty_like(xg_t)
    dxg2 = torch.empty_like(xg_t)
    dhg1 = torch.empty_like(xg_t)
    dhg2 = torch.empty_like(xg_t)
    dq = torch.empty_like(res["q"])
    dva_rows = torch.empty_like(res["q"])
    dctx = torch.zeros_like(ctx)
    dctxp = torch.zeros_like(ctxp)
    ds = torch.zeros((B, H), dtype=torch.float32, device=xg_t.device)
    for t in range(Tt - 1, -1, -1):
        st, w, q = res["st"][t], res["w"][t], res["q"][t]
        # GRU2 (s~ -> s')
        dxg2[t], dhg2[t], dst = gru_cell_bwd_plain(res["xg2"][t], res["hg2"][t],
                                                   st, ds + ds_ro[t])
        dc = dc_all[t] + dxg2[t] @ wi2.T
        dst = dst + dhg2[t] @ uh2.T
        # attention
        dw = torch.bmm(ctx, dc[:, :, None])[:, :, 0]            # (B, T)
        dctx += w[:, :, None] * dc[:, None, :]
        dsc = w * (dw - (w * dw).sum(-1, keepdim=True))
        dsc = torch.where(mask > 0, dsc, torch.zeros_like(dsc))
        e = torch.tanh(ctxp + q[:, None, :])
        da = (dsc[:, :, None] * va) * (1.0 - e * e)
        dctxp += da
        dq[t] = da.sum(1)
        dva_rows[t] = (e * dsc[:, :, None]).sum(1)
        dst = dst + dq[t] @ ua.T
        # GRU1 (s -> s~)
        dxg1[t], dhg1[t], ds = gru_cell_bwd_plain(xg_t[t], res["hg1"][t],
                                                  res["s"][t], dst)
        ds = ds + dhg1[t] @ uh1.T

    def rows(x):
        return x.reshape(Tt * B, -1)

    def atb(a, b):
        return rows(a).T @ rows(b)

    return (dpre, dxg1, ds, dctx, dctxp,
            atb(res["s"][:-1], dhg1), rows(dhg1).sum(0),
            atb(res["st"], dq), rows(dva_rows).sum(0),
            atb(res["c"], dxg2), rows(dxg2).sum(0),
            atb(res["st"], dhg2), rows(dhg2).sum(0),
            atb(res["s"][1:], dpre), atb(res["c"], dpre))


def dec_scan_bwd(res: Dict[str, torch.Tensor], xg_t, ctx, ctxp, mask,
                 weights: Sequence[torch.Tensor], g_t, *, impl: str = "auto"):
    """Gradients of the decoder scan given the forward's residuals and the
    cotangent g_t (Tt, B, R) of the readout; returns what
    ``dec_scan_bwd_plain`` returns. One call of the kernel path enqueues 3
    grids before the loop, 7 per step and 10 after it, and a memset (see
    csrc/dec_scan_bwd.cu): it counts one in ``dec_scan_bwd.launches`` and
    those in ``dec_scan_bwd.grids``."""
    if resolve_impl(impl, xg_t) == "plain":
        return dec_scan_bwd_plain(res, xg_t, ctx, ctxp, mask, weights, g_t)
    Tt, B, R = g_t.shape
    _, T, C = ctx.shape
    H = weights[0].shape[0]
    A = ctxp.shape[2]
    _check_inputs("dec_scan_bwd", g_t, xg_t, res["s"][0], ctx, ctxp, mask,
                  weights, Tt, B, T, H, A, C, R)
    for k, shape in (("t", (Tt, B, R)), ("s", (Tt + 1, B, H)),
                     ("st", (Tt, B, H)), ("c", (Tt, B, C)), ("w", (Tt, B, T)),
                     ("q", (Tt, B, A)), ("hg1", (Tt, B, 3 * H)),
                     ("xg2", (Tt, B, 3 * H)), ("hg2", (Tt, B, 3 * H))):
        check_kernel_arg(res[k], torch.float32, shape, f"dec_scan_bwd: {k}")
    dev = xg_t.device

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    uh1, _, ua, va, wi2, _, uh2, _, ws, wc = weights
    dty, dxg1, ds0 = new(Tt, B, R), new(Tt, B, 3 * H), new(B, H)
    dctx = torch.zeros_like(ctx)
    dctxp = torch.zeros_like(ctxp)
    dw = [torch.empty_like(w) for w in weights]
    duh1, dbh1, dua, dva, dwi2, dbi2, duh2, dbh2, dws, dwc = dw
    scratch = (new(Tt, B, H), new(Tt, B, C), new(Tt, B, 3 * H),
               new(Tt, B, 3 * H), new(Tt, B, 3 * H), new(Tt, B, A),
               new(Tt, B, A), new(B, H))
    lib = _build.load("dec_scan_bwd")
    split_k, _keep = _build.workspace_args(dev)
    ptrs = [g_t, res["t"], res["s"], res["st"], res["c"], res["w"], res["q"],
            res["hg1"], res["xg2"], res["hg2"], xg_t, ctx, ctxp, mask,
            uh1, ua, va, wi2, uh2, ws, wc,
            dty, dxg1, ds0, dctx, dctxp,
            duh1, dbh1, dua, dva, dwi2, dbi2, duh2, dbh2, dws, dwc, *scratch]
    rc = lib.dec_scan_bwd_launch(*(p.data_ptr() for p in ptrs),
                                 Tt, B, T, H, A, C, R, *split_k,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dec_scan_bwd kernel launch failed: CUDA error {rc}")
    dec_scan_bwd.launches += 1
    dec_scan_bwd.grids += 7 * Tt + 13
    return (dty, dxg1, ds0, dctx, dctxp, *dw)


dec_scan_bwd.launches = 0
dec_scan_bwd.grids = 0

_build.declare("dec_scan_bwd", "dec_scan_bwd_launch",
               [ctypes.c_void_p] * 44 + [ctypes.c_int] * 7
               + _build.WORKSPACE_ARGTYPES + [ctypes.c_void_p])


def _check_inputs(what, first, xg_t, s0, ctx, ctxp, mask, weights,
                  Tt, B, T, H, A, C, R):
    shapes = {"uh1": (H, 3 * H), "bh1": (3 * H,), "ua": (H, A), "va": (A,),
              "wi2": (C, 3 * H), "bi2": (3 * H,), "uh2": (H, 3 * H),
              "bh2": (3 * H,), "ws": (H, R), "wc": (C, R)}
    check_kernel_arg(first, torch.float32, (Tt, B, R), f"{what}: ty/g")
    check_kernel_arg(xg_t, torch.float32, (Tt, B, 3 * H), f"{what}: xg_t")
    check_kernel_arg(s0, torch.float32, (B, H), f"{what}: s0")
    check_kernel_arg(ctx, torch.float32, (B, T, C), f"{what}: ctx")
    check_kernel_arg(ctxp, torch.float32, (B, T, A), f"{what}: ctxp")
    check_kernel_arg(mask, torch.float32, (B, T), f"{what}: mask")
    for name, w in zip(WEIGHTS, weights):
        check_kernel_arg(w, torch.float32, shapes[name], f"{what}: {name}")


class DecoderScan(torch.autograd.Function):
    """The decoder scan with its gradient: forward through ``dec_scan_fwd``,
    backward through ``dec_scan_bwd`` (counterpart of
    ``pallas_dec_scan._scan`` and its custom VJP)."""

    @staticmethod
    def forward(ctx_, impl, ty_t, xg_t, s0, ctx, ctxp, mask, *weights):
        res = dec_scan_fwd(ty_t, xg_t, s0, ctx, ctxp, mask, weights,
                           impl=impl)
        ctx_.impl = impl
        ctx_.save_for_backward(xg_t, ctx, ctxp, mask, *weights,
                               *(res[k] for k in RESIDUALS))
        return res["t"]

    @staticmethod
    def backward(ctx_, g_t):
        saved = ctx_.saved_tensors
        xg_t, ctx, ctxp, mask = saved[:4]
        weights = saved[4:4 + len(WEIGHTS)]
        res = dict(zip(RESIDUALS, saved[4 + len(WEIGHTS):]))
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
    of 8 for the TPU's tile rules, which the CUDA kernels do not have."""
    r, at = params["readout"], params["attn"]
    ty_t = (ty.transpose(0, 1) + r["b"]).contiguous()
    ctxpb = (ctx_proj + at["ba"]).contiguous()
    args = (ty_t, xg1.transpose(0, 1).contiguous(), s0.contiguous(),
            ctx.contiguous(), ctxpb, src_mask.to(torch.float32).contiguous())
    weights = tuple(w.contiguous() for w in scan_weights(params))
    if torch.is_grad_enabled():
        t_t = DecoderScan.apply(impl, *args, *weights)
    else:
        t_t = dec_scan_fwd(*args, weights, impl=impl)["t"]
    return t_t.transpose(0, 1)
