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
goes through ``GRUScan``, whose backward is the backward kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vag_nmt_tpu_torch.core.knobs import gru_stream_fp32
from vag_nmt_tpu_torch.models.layers import glorot_uniform, mm, orthogonal
from vag_nmt_tpu_torch.ops.gru_kernel import GRUScan, gru_fwd, gru_gate_algebra

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
    B, T, _ = x.shape
    H = params["uh"].shape[0]
    if h0 is None:
        h0 = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    stream = (torch.bfloat16 if x.dtype == torch.bfloat16
              and not gru_stream_fp32() else torch.float32)
    xg_t = gru_gates_from_x(params, x).transpose(0, 1).to(stream).contiguous()
    mask_t = mask.transpose(0, 1).to(torch.float32).contiguous()
    # bf16 params (a bf16 decode's cast) reach the scan as fp32 values
    args = (xg_t, mask_t, params["uh"].to(torch.float32).contiguous(),
            params["bh"].to(torch.float32).contiguous(),
            h0.to(torch.float32).contiguous())
    if torch.is_grad_enabled():
        hs_t = GRUScan.apply(*args, reverse, impl)
    else:
        hs_t = gru_fwd(*args, reverse=reverse, impl=impl)
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
    """Returns (states (B, T, 2H), h_fwd (B, H), h_bwd (B, H))."""
    out_f, h_f = gru_scan(params_fwd, x, mask, reverse=False, impl=impl)
    out_b, h_b = gru_scan(params_bwd, x, mask, reverse=True, impl=impl)
    return torch.cat([out_f, out_b], dim=-1), h_f, h_b
