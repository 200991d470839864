"""GRU cell and masked scans (counterpart of the JAX package's
``ops/gru.py``).

Gate convention as cuDNN and the JAX package (reset gate applied after the
hidden matmul):

    r = sigmoid(xr + hr);  z = sigmoid(xz + hz)
    n = tanh(xn + r * hn)
    h' = (1 - z) * n + z * h

The input projection ``x @ Wi + bi`` for all time steps is one matmul
outside the recurrence. Padding uses the mask-carry rule: at masked steps
the state is carried through unchanged. The recurrence itself runs in
``ops/gru_kernel.py``: the hand-written CUDA kernels for CUDA tensors,
their plain PyTorch versions for CPU tensors; with grad enabled the scan
goes through ``GRUScan``, whose backward is the backward kernel (a bi-GRU
on bf16 streams through ``BiGRUScan``, both directions in one call each
way); a scan that needs no gradient on bf16 streams takes the forward
kernel's instance that sums in the plain version's k order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vag_nmt_tpu_torch.core.knobs import gru_stream_fp32
from vag_nmt_tpu_torch.models.layers import glorot_uniform, mm, orthogonal
from vag_nmt_tpu_torch.ops.gru_kernel import (BiGRUScan, GRUScan, gru_fwd,
                                              gru_gate_algebra)

Params = Dict[str, torch.Tensor]


def init_gru_params(gen: torch.Generator, in_dim: int, hidden: int) -> Params:
    """Glorot input weights, orthogonal per-gate recurrent blocks, zero
    biases."""
    return {
        "wi": glorot_uniform(gen, (in_dim, 3 * hidden)),
        "bi": torch.zeros((3 * hidden,), dtype=torch.float32),
        "uh": torch.cat([orthogonal(gen, hidden) for _ in range(3)], dim=1),
        "bh": torch.zeros((3 * hidden,), dtype=torch.float32),
    }


def gru_gates_from_x(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Time-parallel input projection: (..., E) -> (..., 3H), fp32."""
    return mm(x, params["wi"]) + params["bi"]


def gru_cell_from_gates(xg: torch.Tensor, hg: torch.Tensor,
                        h: torch.Tensor) -> torch.Tensor:
    """Gate nonlinearity given both precomputed gate sets (biases
    included), in fp32; the new state in h's dtype (bf16 in a bf16
    decode, rounded once)."""
    return gru_gate_algebra(xg, hg, h.to(torch.float32)).to(h.dtype)


def gru_cell_from_xgates(params: Params, xg: torch.Tensor,
                         h: torch.Tensor) -> torch.Tensor:
    """One step given precomputed input gates. xg: (N, 3H), h: (N, H)."""
    return gru_cell_from_gates(xg, mm(h, params["uh"]) + params["bh"], h)


def gru_scan(
    params: Params,
    x: torch.Tensor,            # (B, T, E)
    mask: torch.Tensor,         # (B, T) 1.0 at real tokens, 0.0 at pads
    h0: Optional[torch.Tensor] = None,   # (B, H)
    *,
    reverse: bool = False,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked unidirectional GRU over time.

    Returns (states (B, T, H), final state (B, H)); the final state is the
    state at the last (first, if reverse) real token. impl: "auto" (kernel
    for CUDA tensors, plain for CPU tensors), "kernel", "plain", or the JAX
    names "pallas" / "xla" (ModelConfig.gru_impl).

    A bf16 ``x`` (compute_dtype="bfloat16") runs the scan on bf16 time
    streams, as ``pallas_gru_scan``: xg rounded to bf16, the states
    returned in bf16, the carry fp32 (``ops/gru_kernel.py``);
    ``VAG_GRU_STREAM=fp32`` keeps the streams fp32 and returns the states
    cast to bf16."""
    args = _scan_args(params, x, mask, h0)
    if _needs_grad(x, h0, *params.values()):
        hs_t = GRUScan.apply(*args, reverse, impl)
    else:   # bf16 streams: the instance that sums in the plain version's order
        hs_t = gru_fwd(*args, reverse=reverse, impl=impl, k_order=True)
    return _states(hs_t, x, reverse)


def _bf16_streams(x: torch.Tensor) -> bool:
    """Whether a scan of x runs on bf16 time streams."""
    return x.dtype == torch.bfloat16 and not gru_stream_fp32()


def _needs_grad(*inputs: Optional[torch.Tensor]) -> bool:
    """Whether a scan's output needs a gradient (grad mode on and an input
    that requires one): training's scans, not a decode's."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)


def _scan_args(params: Params, x: torch.Tensor, mask: torch.Tensor,
               h0: Optional[torch.Tensor]):
    """(xg_t, mask_t, uh, bh, h0) of a scan of x, time-major, xg_t in the
    streams' dtype, the rest fp32 (bf16 params, a bf16 decode's cast, reach
    the scan as fp32 values); h0 zeros when None."""
    B, T, _ = x.shape
    H = params["uh"].shape[0]
    if h0 is None:
        h0 = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    stream = torch.bfloat16 if _bf16_streams(x) else torch.float32
    xg_t = gru_gates_from_x(params, x).transpose(0, 1).to(stream).contiguous()
    mask_t = mask.transpose(0, 1).to(torch.float32).contiguous()
    return (xg_t, mask_t, params["uh"].to(torch.float32).contiguous(),
            params["bh"].to(torch.float32).contiguous(),
            h0.to(torch.float32).contiguous())


def _states(hs_t: torch.Tensor, x: torch.Tensor, reverse: bool):
    """(states (B, T, H) in x's dtype, the final state) of a scan's hs_t."""
    hs = hs_t.transpose(0, 1).to(x.dtype)
    return hs, (hs[:, 0] if reverse else hs[:, -1])


def bidirectional_gru(
    params_fwd: Params,
    params_bwd: Params,
    x: torch.Tensor,
    mask: torch.Tensor,
    *,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (states (B, T, 2H), h_fwd (B, H), h_bwd (B, H)).

    A scan that needs a gradient on bf16 streams (training) goes with the
    other direction through one ``BiGRUScan`` (``gru_fwd_pair`` /
    ``gru_bwd_pair``): on the card both directions in one grid of kernel
    2b forward and one call of kernel 3b backward, each direction on CTAs
    of its own; on the CPU the two plain scans."""
    if _bf16_streams(x) and _needs_grad(x, *params_fwd.values(),
                                        *params_bwd.values()):
        fwd = _scan_args(params_fwd, x, mask, None)
        bwd = _scan_args(params_bwd, x, mask, None)
        args = (fwd[0], bwd[0], fwd[1], fwd[2], fwd[3], bwd[2], bwd[3],
                fwd[4], bwd[4])
        hs_f, hs_b = BiGRUScan.apply(*args, impl)
        (out_f, h_f), (out_b, h_b) = (_states(hs_f, x, False),
                                      _states(hs_b, x, True))
    else:
        out_f, h_f = gru_scan(params_fwd, x, mask, reverse=False, impl=impl)
        out_b, h_b = gru_scan(params_bwd, x, mask, reverse=True, impl=impl)
    return torch.cat([out_f, out_b], dim=-1), h_f, h_b
