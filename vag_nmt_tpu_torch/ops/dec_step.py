"""Fused beam decode step, GRU1 -> attention -> GRU2 -> readout activations
(counterpart of the JAX package's ``ops/pallas_dec_step.py``): the
hand-written CUDA kernel ``csrc/dec_step.cu``, its plain PyTorch version,
the wrapper that picks between them by the tensors' device, and
``decode_step_fused``, the counterpart of ``pallas_decode_step``. On
bf16 operands the kernel is ``csrc/dec_step_bf16.cu`` (kernel 7b, on
wgmma and TMA, tiled by ``dec_step_bf16_plan``).

The step starts from the decode tables (``models/decoder.decode_tables``):
the ``gy`` row gather stays outside the kernel (a torch index, as the JAX
package keeps it in XLA), ``ba`` is folded into ``ctx_proj`` per call, and
the fused weight matrices ``w_s = [ua | uh2]`` and ``w_c = [wi2 | wc]``
compute the same per-column dot products as the PyTorch tabled step. The
kernel is not bit-identical to that step (its products run as three TF32
products on the tensor cores, its sums and softmax in another order), so
the tests hold it to a tolerance. ``dec_step_plan`` owns the kernel's
tiling: its constants are the build's -D defines and its tile counts the
launch's arguments, so the CPU tests of the plan cover what is launched.

Selected by ``VAG_DEC_STEP=on`` with decode tables (``core/knobs.py``),
default off as in the JAX package, whose default rests on a TPU
measurement; the kernel's own numbers are in PERF.md.

In a bf16 decode (the params cast to bf16) the states, ctx and the four
weight matrices are bf16 and the step runs the kernel's bf16 instances:
the gate algebra, the attention and every sum in fp32, each new state and
the attention's context rounded to bf16 once, t fp32, as the JAX
kernel under bf16."""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import torch

from vag_nmt_tpu_torch.core.device import check_kernel_arg, resolve_impl
from vag_nmt_tpu_torch.models.layers import embed, mm
from vag_nmt_tpu_torch.ops import _build
from vag_nmt_tpu_torch.ops.gru_kernel import gru_gate_algebra
from vag_nmt_tpu_torch.ops.topk import MAX_K, declare_instances, instance

NEG_INF = -1e9          # as ops/attention.masked_softmax

# The kernel's tiling, passed to csrc/dec_step.cu as -D defines: rows of a
# product tile, depth of a staged chunk, hidden units of a gate tile (its
# 3 * UB columns: the r, z and n columns of those units), columns of a qh
# tile and of a readout (s' @ ws) tile, depth splits of the readout
# product, stages of the cp.async ring, CTAs of the attention's cluster
# per sentence.
BM, BK, UB, BN, RN, SPLIT, STAGES, ATT_CLUSTER = 64, 32, 16, 80, 32, 4, 3, 4
SMEM_LIMIT = 232448     # bytes of shared memory a block may use
GRIDS = 5               # grids a call enqueues
# Kernel 7b's tiling (csrc/dec_step_bf16.cu, -D defines): 64-row tiles
# (BM: one wgmma M) in 64-deep TMA stages (BF16_BOX_K: one 128-byte row of
# bf16) of a BF16_STAGES-deep ring; gate tiles of BF16_UB units (three
# boxes of 32 columns), qh tiles of BF16_BN columns (two boxes of 64), tc
# tiles of three 32-column boxes, readout tiles of BF16_RN columns (one
# box, the depth not split).
BF16_UB, BF16_BN, BF16_RN, BF16_STAGES = 32, 128, 32, 4
BF16_BOX_K = 64
# Its attention: the scores' grid, then the softmax and context sums' grid
# of BF16_ATT_PARTS CTAs a sentence; one grid more than kernel 7's.
BF16_ATT_PARTS = 4
GRIDS_BF16 = 6


@dataclass(frozen=True)
class GemmPlan:
    """One product of the step as the kernel tiles it: out = a (rows,
    depth) @ b over ``col_tiles`` column tiles of ``tile_cols`` columns and
    ``row_tiles`` tiles of BM rows. Tiles [0, gate_tiles) are gate tiles
    (UB units of H, columns u, H + u, 2H + u of b), the rest plain tiles
    over b's columns [col0, col0 + cols). The depth is cut into ``splits``
    parts of ``kchunk`` (the last ones empty where the depth is short), the
    CTAs of a tile's splits one thread-block cluster. ``ub``: the units
    of a gate tile; ``box``: kernel 7b's B boxes, of ``box`` columns each
    (0 in kernel 7's plan)."""
    name: str
    rows: int
    depth: int
    tile_cols: int
    H: int
    gate_tiles: int
    col0: int
    cols: int
    col_tiles: int
    splits: int
    kchunk: int
    ub: int = UB
    box: int = 0

    @property
    def row_tiles(self) -> int:
        return -(-self.rows // BM)

    def b_columns(self, ct: int) -> List[int]:
        """b's column of each column of tile ct, -1 outside b (the same map
        as the kernel's device function b_col)."""
        out = []
        for j in range(self.tile_cols):
            if ct < self.gate_tiles:
                u = ct * self.ub + j % self.ub
                out.append((j // self.ub) * self.H + u if u < self.H else -1)
            else:
                c = (ct - self.gate_tiles) * self.tile_cols + j
                out.append(self.col0 + c if c < self.cols else -1)
        return out

    @property
    def smem_bytes(self) -> int:
        """The CTA's ring (or its staged accumulators, whichever is more),
        then its epilogue's operands: a gate tile's three gate rows and
        state rows, or the readout's ty and tc."""
        return self.smem_bytes_of(4)

    def smem_bytes_of(self, itemsize: int) -> int:
        """``smem_bytes`` with the operands staged at ``itemsize`` bytes
        (2: the bf16 instances, whose A rows pad by 8 elements, not 4); the
        staged accumulators and the epilogue's operands stay fp32."""
        ws = self.tile_cols + 8
        ops = (4 * BM * UB if self.gate_tiles else
               2 * BM * self.tile_cols if self.name == "sw" else 0)
        ring = STAGES * itemsize * (BM * (BK + 16 // itemsize) + BK * ws)
        return max(ring, 4 * BM * ws) + 4 * ops


@functools.lru_cache(maxsize=None)   # one shape a decode: once, not per step
def dec_step_plan(N: int, H: int, A: int, C: int, R: int
                  ) -> Tuple[GemmPlan, ...]:
    """The four products of one call in launch order (hg1 with GRU1, qh, xc
    with GRU2 and the tc columns, sw with the readout) for N rows and widths
    H, A, C, R; dec_step launches csrc/dec_step.cu with its tile counts
    (``launch_tiles``)."""
    gt = 3 * UB
    units = -(-H // UB)
    kchunk = -(-(-(-H // SPLIT)) // BK) * BK
    return (
        GemmPlan("hg1", N, H, gt, H, units, 0, 0, units, 1, H),
        GemmPlan("qh", N, H, BN, H, 0, 0, A + 3 * H, -(-(A + 3 * H) // BN),
                 1, H),
        GemmPlan("xc", N, C, gt, H, units, 3 * H, R, units + -(-R // gt), 1,
                 C),
        GemmPlan("sw", N, H, RN, H, 0, 0, R, -(-R // RN), SPLIT, kchunk),
    )


@functools.lru_cache(maxsize=None)
def dec_step_bf16_plan(N: int, H: int, A: int, C: int, R: int
                       ) -> Tuple[GemmPlan, ...]:
    """Kernel 7b's four products in launch order, as ``dec_step_plan``:
    gate tiles of BF16_UB units (boxes of 32 columns), qh tiles of BF16_BN
    columns (boxes of 64), xc's tc tiles three 32-column boxes wide, the
    readout in tiles of BF16_RN columns over its whole depth."""
    ub, gt = BF16_UB, 3 * BF16_UB
    units, Q = -(-H // ub), A + 3 * H
    return (
        GemmPlan("hg1", N, H, gt, H, units, 0, 0, units, 1, H, ub, 32),
        GemmPlan("qh", N, H, BF16_BN, H, 0, 0, Q, -(-Q // BF16_BN), 1, H, ub,
                 64),
        GemmPlan("xc", N, C, gt, H, units, 3 * H, R, units + -(-R // gt), 1,
                 C, ub, 32),
        GemmPlan("sw", N, H, BF16_RN, H, 0, 0, R, -(-R // BF16_RN), 1, H, ub,
                 32),
    )


def launch_tiles(plan: Sequence[GemmPlan]) -> Tuple[int, ...]:
    """The plan as dec_step_launch takes it: each product's gate tiles and
    column tiles in launch order, then the last product's split depth."""
    return tuple(x for g in plan for x in (g.gate_tiles, g.col_tiles)) + (
        plan[-1].kchunk,)


WEIGHTS = ("uh1", "bh1", "w_s", "bh2", "va", "w_c", "bi2", "ws", "b")


# the weights that keep the params' dtype (bf16 in a bf16 decode); the
# biases and va go in as fp32, as the JAX kernel takes them
MATRICES = ("uh1", "w_s", "w_c", "ws")


def step_weights(params: Dict[str, Any],
                 tables: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The step's weights in ``WEIGHTS`` order, contiguous: the matrices
    in the params' dtype, the biases and va in fp32."""
    g1, g2, r = params["gru1"], params["gru2"], params["readout"]
    ws = (g1["uh"], g1["bh"], tables["w_s"], g2["bh"], params["attn"]["va"],
          tables["w_c"], g2["bi"], r["ws"], r["b"])
    return tuple((w if n in MATRICES else w.to(torch.float32)).contiguous()
                 for n, w in zip(WEIGHTS, ws))


def dec_step_plain(gy, s, ctx, ctxpb, mask,
                   weights: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, the JAX kernel's arithmetic
    in its order: gy (N, 3H + R), s (N, H) with N = B*K, ctx (B, T, C),
    ctxpb (B, T, A) = ctx_proj + ba, mask (B, T). Returns (s_new (N, H) in
    s's dtype, t (N, R) fp32). Under bf16 s, ctx and matrices the products
    are bf16 x bf16 summed in fp32 (``mm``) and s~, c and s_new are
    rounded to bf16 once each."""
    uh1, bh1, w_s, bh2, va, w_c, bi2, ws, b = weights
    B, T, C = ctx.shape
    N, H = s.shape
    K = N // B
    A = w_s.shape[1] - 3 * H
    sd, f32 = s.dtype, torch.float32
    xg1, ty = gy[:, :3 * H], gy[:, 3 * H:]
    st = gru_gate_algebra(xg1, mm(s, uh1) + bh1, s.to(f32)).to(sd)
    qh = mm(st, w_s)
    q = qh[:, :A].reshape(B, K, A)
    e = torch.tanh(ctxpb[:, None, :, :] + q[:, :, None, :])    # (B, K, T, A)
    sc = (e * va).sum(-1)
    sc = torch.where(mask[:, None, :] > 0, sc, torch.full_like(sc, NEG_INF))
    w = torch.softmax(sc, dim=-1)
    c = torch.einsum("bkt,btc->bkc", w, ctx.to(f32)).reshape(N, C).to(sd)
    xc = mm(c, w_c)
    s_new = gru_gate_algebra(xc[:, :3 * H] + bi2, qh[:, A:] + bh2,
                             st.to(f32)).to(sd)
    t = torch.tanh(ty + mm(s_new, ws) + xc[:, 3 * H:] + b)
    return s_new, t


def dec_step(gy, s, ctx, ctxpb, mask, weights: Sequence[torch.Tensor], *,
             impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """``dec_step_plain``'s contract. impl: "auto" (kernel for CUDA
    tensors, plain for CPU tensors), "kernel" or "plain". One call of the
    kernel path enqueues GRIDS grids (GRIDS_BF16 on bf16 operands; see
    csrc/dec_step.cu and csrc/dec_step_bf16.cu): it counts one in
    ``dec_step.launches`` and those in ``dec_step.grids``. The kernel
    has an instance for K <= 8 beams a sentence and one for K > 8
    (``ops/topk.K_INSTANCES``), whose attention takes the beams of a
    sentence in groups of 16 above 16 (each such call also counts one in
    ``dec_step.beam_groups``); each has a bf16 build, taken when s is
    bf16 (counted in ``dec_step.bf16_launches``): then s, ctx, uh1, w_s,
    w_c and ws must be bf16 and the rest fp32, else ValueError."""
    B, T, C = ctx.shape
    N, H = s.shape
    if resolve_impl(impl, s) == "plain":
        return dec_step_plain(gy, s, ctx, ctxpb, mask, weights)
    if N % B or N < B:
        raise ValueError(f"dec_step kernel: {N} rows for {B} sentences")
    K = N // B
    A = weights[2].shape[1] - 3 * H
    R = weights[7].shape[1]
    G = 3 * H + R
    shapes = {"uh1": (H, 3 * H), "bh1": (3 * H,), "w_s": (H, A + 3 * H),
              "bh2": (3 * H,), "va": (A,), "w_c": (C, G), "bi2": (3 * H,),
              "ws": (H, R), "b": (R,)}
    bf = s.dtype == torch.bfloat16
    sd = torch.bfloat16 if bf else torch.float32
    for name, w in zip(WEIGHTS, weights):
        check_kernel_arg(w, sd if name in MATRICES else torch.float32,
                         shapes[name], f"dec_step: {name}")
    check_kernel_arg(gy, torch.float32, (N, G), "dec_step: gy")
    check_kernel_arg(s, sd, (N, H), "dec_step: s")
    check_kernel_arg(ctx, sd, (B, T, C), "dec_step: ctx")
    check_kernel_arg(ctxpb, torch.float32, (B, T, A), "dec_step: ctxpb")
    check_kernel_arg(mask, torch.float32, (B, T), "dec_step: mask")
    dev = s.device

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    s_new, t = new(N, H, dtype=sd), new(N, R)
    # s~ qh c tc (kernel 7b: tc, then its attention's scores (N, T))
    scratch = (new(N, H, dtype=sd), new(N, A + 3 * H), new(N, C, dtype=sd),
               new(N * (R + T)) if bf else new(N, R))
    plan = (dec_step_bf16_plan if bf else dec_step_plan)(N, H, A, C, R)
    lib = _build.load(instance("dec_step", K, bf16=bf))
    rc = lib.dec_step_launch(
        gy.data_ptr(), s.data_ptr(), ctx.data_ptr(), ctxpb.data_ptr(),
        mask.data_ptr(), *(w.data_ptr() for w in weights), s_new.data_ptr(),
        t.data_ptr(), *(x.data_ptr() for x in scratch), B, K, T, H, A, C, R,
        *launch_tiles(plan), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dec_step kernel launch failed: CUDA error {rc}")
    dec_step.launches += 1
    dec_step.bf16_launches += bf
    dec_step.grids += GRIDS_BF16 if bf else GRIDS
    if K > MAX_K:
        dec_step.beam_groups += 1
    return s_new, t


dec_step.launches = 0
dec_step.bf16_launches = 0
dec_step.grids = 0
dec_step.beam_groups = 0

# The attention grid holds a sentence's K beams in one cluster: at K = 16,
# T = 32 and A = 512 its shared memory is 16 * 512 + 512 + 16 * 32 floats
# (37.9 KB), and its softmax warps take beams k, k + 8; at K = 32 (two
# groups of 16) 32 * 512 + 512 + 32 * 32 floats (71.7 KB).
declare_instances("dec_step", "dec_step_launch",
                  [ctypes.c_void_p] * 20 + [ctypes.c_int] * 16 + [ctypes.c_void_p],
                  {"VAG_BM": BM, "VAG_BK": BK, "VAG_UB": UB, "VAG_BN": BN,
                   "VAG_RN": RN, "VAG_SPLIT": SPLIT, "VAG_STAGES": STAGES,
                   "VAG_ATT_CLUSTER": ATT_CLUSTER},
                  bf16_defines={"VAG_UB": BF16_UB, "VAG_BN": BF16_BN,
                                "VAG_RN": BF16_RN, "VAG_STAGES": BF16_STAGES,
                                "VAG_ATT_PARTS": BF16_ATT_PARTS})


def decode_step_fused(params: Dict[str, Any], tables: Dict[str, torch.Tensor],
                      tok: torch.Tensor, s: torch.Tensor, ctx: torch.Tensor,
                      ctx_proj: torch.Tensor, src_mask: torch.Tensor, *,
                      impl: str = "auto",
                      vocab=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused beam decode step off the decode tables: tok (B, K), s
    (B, K, H), ctx (B, T, C), ctx_proj (B, T, A), src_mask (B, T). Returns
    (s_new (B, K, H), t (B*K, R)), the inputs of the fused readout top-K.
    vocab: the target vocab's slice under tensor parallelism (``gy``
    holds its rows; the step's rows come through ``vocab_embed``)."""
    B, K = tok.shape
    H = s.shape[-1]
    gy = embed({"table": tables["gy"]}, tok.reshape(-1), vocab)
    ctxpb = (ctx_proj + params["attn"]["ba"]).contiguous()
    s_new, t = dec_step(gy, s.reshape(B * K, H).contiguous(), ctx.contiguous(),
                        ctxpb, src_mask.to(torch.float32).contiguous(),
                        step_weights(params, tables), impl=impl)
    return s_new.reshape(B, K, H), t
