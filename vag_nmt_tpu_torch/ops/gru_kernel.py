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
fp32 (``h.astype(bf16) @ uh.astype(bf16)``), through the bf16 instances
(builds ``gru_fwd_bf16``, ``csrc/gru_fwd_bf16.cu``: the per-step product on
the bf16 tensor cores, tiled by ``gru_fwd_bf16_plan``; ``gru_bwd_bf16``:
the recompute and the weight grads on bf16 tiles, the cell backward's
coefficients precomputed for the carry, ``gru_cell_coef``); the carry, the
gate math, dUh, dbh and dh0 stay fp32.
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
    to the bf16 build's entry (gru_fwd_bf16_fma) with its carry buffers
    and h0 rounded (``uh`` already rounded by the caller). Raises when the
    launcher refuses the plan (not co-resident, malformed) or the launch
    fails."""
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


def _ptrs(xs) -> ctypes.Array:
    """The device pointers of tensors xs as a C array (one a scan)."""
    return (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))


def _ints(xs) -> ctypes.Array:
    return (ctypes.c_int * len(xs))(*xs)


def _launch_bf16(plan: "PersistentPlan", mask_t: torch.Tensor,
                 scans) -> list:
    """Enqueue len(scans) bf16-stream scans (1, or 2 on plan's disjoint CTA
    ranges), each (xg_t, uh, bh, h0, reverse), as one grid of
    csrc/gru_fwd_bf16.cu tiled by ``plan`` (gru_fwd_bf16_plan,
    gru_fwd_pair_plan), with each scan's (2, B, H) fp32 carry and, where
    the plan puts Uh's slices in L2, their buffer; Uh passed in bf16.
    Returns each scan's hs_t in bf16; raises when the launcher refuses the
    plan or the launch fails."""
    T, B, H3 = scans[0][0].shape
    H, dev = H3 // 3, mask_t.device
    outs = [torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
            for _ in scans]
    carry = [torch.empty((2, B, H), dtype=torch.float32, device=dev)
             for _ in scans]
    wl2 = (torch.empty(plan.l2_floats, dtype=torch.float32, device=dev)
           if plan.l2_floats else None)
    w = [sc[1].to(torch.bfloat16).contiguous() for sc in scans]
    args = plan.launch_args()
    rc = _build.load("gru_fwd_bf16").gru_fwd_bf16_launch(
        len(scans), _ptrs([sc[0] for sc in scans]), mask_t.data_ptr(),
        _ptrs(w), _ptrs([sc[2] for sc in scans]), _ptrs([sc[3] for sc in scans]),
        _ptrs(outs), _ptrs(carry), _ints([int(sc[4]) for sc in scans]), T, B,
        H, _ints(args), len(args), None if wl2 is None else wl2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gru_fwd_bf16 kernel launch failed: CUDA error "
                           f"{rc} (plan {plan})")
    return outs


def gru_fwd(xg_t: torch.Tensor, mask_t: torch.Tensor, uh: torch.Tensor,
            bh: torch.Tensor, h0: torch.Tensor, *, reverse: bool = False,
            impl: str = "auto", k_order: bool = False) -> torch.Tensor:
    """hs_t (T, B, H) of the masked GRU recurrence. impl: "auto" (kernel for
    CUDA tensors, plain for CPU tensors), "kernel" or "plain".

    One call of the kernel path enqueues the whole scan as one persistent
    cooperative grid (see csrc/gru_fwd.cu) tiled by ``gru_fwd_plan`` for
    this card: it counts one in ``gru_fwd.launches`` and one in
    ``gru_fwd.grids``. A width that is no multiple of 16 runs zero-padded
    to ``padded_width(H)`` (``pad_units``, exact), the output cut back. A
    plan the card cannot hold co-resident raises. A bf16 ``xg_t`` runs a
    bf16-stream instance (``gru_fwd.bf16_launches`` counts those calls)
    and returns hs_t in bf16: csrc/gru_fwd_bf16.cu, tiled by
    ``gru_fwd_bf16_plan``, its sums on the tensor cores; with ``k_order``
    csrc/gru_fwd.cu's bf16 build, tiled by ``gru_fwd_plan``, each sum an
    FMA chain in k order as the plain version's (ops/gru.py takes it for
    scans that need no gradient: the decode's states then are the plain
    version's where cuBLAS sums in k order)."""
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
    limits = _device_limits(xg_t.device)
    if bf and not k_order:
        out, = _launch_bf16(gru_fwd_bf16_plan(B, Hp, *limits), mask_t,
                            [(xg_t, uh, bh, h0, reverse)])
    else:
        if bf:
            uh = rbf(uh).contiguous()   # the product's operand, exact in fp32
        lib = _build.load("gru_fwd_bf16_fma" if bf else "gru_fwd")
        out = _launch(lib.gru_fwd_launch, gru_fwd_plan(B, Hp, *limits), xg_t,
                      mask_t, uh, bh, h0, reverse)
    gru_fwd.launches += 1
    gru_fwd.grids += 1
    gru_fwd.bf16_launches += bf
    return out if Hp == H else out[..., :H].contiguous()


gru_fwd.launches = 0
gru_fwd.grids = 0
gru_fwd.bf16_launches = 0

_GRU_DEFINES = {"VAG_GRU_STAGES": GRU_STAGES, "VAG_GRU_PAD": GRU_PAD}
# The bf16 GRU builds' depth of a per-step product's activation prefetch
# (16-deep slabs in flight a warp; dec_scan.cuh's PREFETCH, 4 in the other
# builds): their products read the fp32 carry (2b) or dhg (3b, depth 3H)
# from L2, latency-bound at B = 64 (PERF.md).
GRU_BF16_PREFETCH = 12
_GRU_BF16_DEFINES = {**_SCAN_DEFINES, "VAG_BF16": 1,
                     "VAG_PREFETCH": GRU_BF16_PREFETCH}
_GRU_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_build.declare("gru_fwd", "gru_fwd_launch", _GRU_FWD_ARGS, _GRU_DEFINES)
_build.declare("gru_fwd", "gru_fwd_limits",
               [ctypes.POINTER(ctypes.c_int)] * 2, _GRU_DEFINES)
# its bf16-stream build (k_order): the entry takes the carry buffers hc, ps
# and the rounded h0 after the stream
_build.declare("gru_fwd_bf16_fma", "gru_fwd_launch",
               _GRU_FWD_ARGS + [ctypes.c_void_p] * 3,
               {**_GRU_DEFINES, "VAG_BF16": 1}, src="gru_fwd")
# the bf16-stream instance, a source of its own on dec_scan.cuh's products;
# its entry takes one or two scans, their pointers in arrays
_VP, _IP = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
_build.declare("gru_fwd_bf16", "gru_fwd_bf16_launch",
               [ctypes.c_int, _VP, ctypes.c_void_p] + [_VP] * 5 + [_IP]
               + [ctypes.c_int] * 3 + [_IP, ctypes.c_int]
               + [ctypes.c_void_p] * 2, _GRU_BF16_DEFINES)


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


def gru_cell_coef(xg: torch.Tensor, hg: torch.Tensor, h: torch.Tensor,
                  m: torch.Tensor) -> torch.Tensor:
    """The masked cell backward's coefficients that do not depend on the
    gradient dh of the new state, as the bf16 backward's recompute writes
    them (common.cuh's gru_unit_coef): (N, 5H), blocks [c_r, c_z, c_n,
    c_nr, share] with c_n = (1 - z)(1 - n^2) and, for the (N, 1) 0/1 mask
    m, c_r = m c_n hn r (1 - r), c_z = m (h - n) z (1 - z), c_n m, c_nr = m
    c_n r and share = z where m > 0, else 1. ``gru_cell_bwd_coef`` takes
    them to gru_cell_bwd_plain's outputs."""
    H = h.shape[-1]
    r = torch.sigmoid(xg[:, :H] + hg[:, :H])
    z = torch.sigmoid(xg[:, H:2 * H] + hg[:, H:2 * H])
    hn = hg[:, 2 * H:]
    n = torch.tanh(xg[:, 2 * H:] + r * hn)
    cn = (1.0 - z) * (1.0 - n * n)
    return torch.cat([m * (cn * hn * (r * (1.0 - r))),
                      m * ((h - n) * (z * (1.0 - z))), m * cn, m * (cn * r),
                      torch.where(m > 0, z, torch.ones_like(z))], dim=-1)


def gru_cell_bwd_coef(c: torch.Tensor, dh: torch.Tensor):
    """The carry's epilogue of the bf16 backward on ``gru_cell_coef``'s
    coefficients c (N, 5H): (dxg, dhg, base) = (dh [c_r, c_z, c_n], dh
    [c_r, c_z, c_nr], dh share), gru_cell_bwd_plain's outputs up to the
    rounding of its products in another order."""
    H = dh.shape[-1]
    cr, cz, cn, cnr, share = (c[:, k * H:(k + 1) * H] for k in range(5))
    dr, dz = dh * cr, dh * cz
    return (torch.cat([dr, dz, dh * cn], dim=-1),
            torch.cat([dr, dz, dh * cnr], dim=-1), dh * share)


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
class PersistentPlan:
    """Tiling of a persistent cooperative grid that runs one of
    dec_scan.cuh's per-step products each step: the carry of one
    ``gru_bwd`` call (csrc/gru_bwd.cu, dh += dhg @ Uh^T, Uh^T sliced by
    output unit and read transposed from the row-major uh) or the bf16
    forward's scan (csrc/gru_fwd_bf16.cu, hg = h @ Uh on gate tiles):
    ``ctas`` CTAs (one a SM at most) and the product as ``product`` tiles
    it (its weight slices resident in shared memory from float 0 or, when
    ``l2_floats`` > 0, in a buffer of that many floats read through L2),
    the k-slices' accumulators at float ``scratch_off``, ``smem_bytes`` of
    dynamic shared memory."""

    ctas: int
    product: ScanProduct
    scratch_off: int
    smem_bytes: int
    l2_floats: int
    # the bi-GRU's other direction on CTAs of its own (the pair plans)
    second: Optional[ScanProduct] = None

    @property
    def products(self) -> Tuple[ScanProduct, ...]:
        return (self.product,) + ((self.second,) if self.second else ())

    def launch_args(self) -> Tuple[int, ...]:
        return (self.ctas, self.scratch_off, self.smem_bytes, self.l2_floats,
                *(a for p in self.products for a in p.launch_args()))


def _persistent_plan(spec, B: int, H: int, n_sms: int, max_smem: int,
                     bf16: bool, all_sms: bool,
                     fewest_passes: bool = False) -> Optional[PersistentPlan]:
    """The best tiling of product ``spec`` (scan_tiles' (name, depth,
    cols, gate)) by gru_bwd_plan's order, or None where nothing fits; the
    grid of ``n_sms`` CTAs when ``all_sms``, else of the product's;
    ``fewest_passes``: among tilings of equal work and reads, the fewest
    tiles a CTA a step (each a product and an epilogue in turn)."""
    best, best_key = None, None
    for p in _product_options(spec, B, H, n_sms, bf16):
        scratch = _up(p.part_floats, 32)
        region = _up(p.region_floats, 32)
        resident = 4 * (region + scratch) <= max_smem
        if not resident and 4 * scratch > max_smem:
            continue
        smem = 4 * (region + scratch) if resident else 4 * scratch
        key = (not resident, p.work, p.passes * p.tile_rows * p.depth,
               p.passes if fewest_passes else 0, p.ctas, smem)
        if best_key is None or key < best_key:
            best_key = key
            ctas = n_sms if all_sms else p.ctas
            best = (PersistentPlan(ctas, replace(p, woff=0), region, smem, 0)
                    if resident else
                    PersistentPlan(ctas, replace(p, l2off=0), 0, smem,
                                   p.ctas * p.region_floats))
    return best


@functools.lru_cache(maxsize=256)
def gru_fwd_bf16_plan(B: int, H: int, n_sms: int,
                      max_smem: int) -> PersistentPlan:
    """Kernel 2b's tiling of a (B, H) scan (csrc/gru_fwd_bf16.cu): the
    per-step product hg = h @ Uh on gate tiles (a block of ub units, their
    r, z and n columns in one tile, so the cell runs in the product's
    epilogue) with Uh's bf16 slices, chosen as ``gru_bwd_plan`` chooses
    (resident slices first, then the least work and activation reads of
    the busiest CTA a step, then the fewest tiles a CTA a step, fewer
    CTAs, less shared memory); the grid is the product's CTAs. Raises
    ValueError where nothing fits or H is not a positive multiple of 16
    (the wrapper pads it)."""
    if B < 1 or n_sms < 1 or H < 16 or H % 16:
        raise ValueError(f"gru_fwd_bf16_plan: H={H} must be a positive "
                         f"multiple of 16 (and B={B}, n_sms={n_sms} "
                         "positive)")
    plan = _persistent_plan(("hg", H, 3 * H, True), B, H, n_sms, max_smem,
                            True, False, fewest_passes=True)
    if plan is None:
        raise ValueError(f"gru_fwd_bf16_plan: the accumulators of B={B}, "
                         f"H={H} do not fit {max_smem} bytes of shared "
                         "memory")
    return plan


def _pair(plan: PersistentPlan, half: int) -> PersistentPlan:
    """Both directions of the bi-GRU in one grid: ``plan`` (made for
    ``half`` SMs) for the first and its copy on the CTAs from ``half`` on
    (its L2 slices after the first's) for the second."""
    p = plan.product
    second = replace(p, cta0=half,
                     l2off=p.l2off + plan.l2_floats if p.l2off >= 0 else -1)
    return replace(plan, ctas=2 * half, l2_floats=2 * plan.l2_floats,
                   second=second)


@functools.lru_cache(maxsize=256)
def gru_fwd_pair_plan(B: int, H: int, n_sms: int,
                      max_smem: int) -> PersistentPlan:
    """Kernel 2b's tiling of both directions' (B, H) scans in one grid:
    each direction ``gru_fwd_bf16_plan`` on half of the SMs, the second on
    CTAs of its own. Raises as gru_fwd_bf16_plan (and on a card of one
    SM)."""
    if n_sms < 2:
        raise ValueError(f"gru_fwd_pair_plan: n_sms={n_sms} must be at least "
                         "2 (positive)")
    half = gru_fwd_bf16_plan(B, H, n_sms // 2, max_smem)
    return _pair(half, half.ctas)


@functools.lru_cache(maxsize=256)
def gru_bwd_pair_plan(B: int, H: int, n_sms: int,
                      max_smem: int) -> PersistentPlan:
    """Kernel 3b's carry tiling of both directions in one grid: each
    direction ``gru_bwd_plan`` (bf16) on half of the SMs, the second on
    CTAs of its own."""
    if n_sms < 2:
        raise ValueError(f"gru_bwd_pair_plan: n_sms={n_sms} must be at least "
                         "2 (positive)")
    return _pair(gru_bwd_plan(B, H, n_sms // 2, max_smem, bf16=True),
                 n_sms // 2)


@functools.lru_cache(maxsize=256)
def gru_bwd_plan(B: int, H: int, n_sms: int, max_smem: int,
                 bf16: bool = False) -> PersistentPlan:
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
    best = _persistent_plan(("dh", 3 * H, H, False), B, H, n_sms, max_smem,
                            bf16, True)
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
    (counted in ``gru_bwd.bf16_launches``), Uh and h0 passed to it also in
    bf16, its recompute writing the cell's coefficients (T, B, 5H) for the
    carry, which writes dhg and a bf16 copy for the weight grads."""
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
    plan = gru_bwd_plan(B, H, *_device_limits(xg_t.device), bf16=bf)
    out, = _launch_bwd(plan, mask_t, [(xg_t, uh, bh, h0, hs_t, g_t, reverse)])
    gru_bwd.launches += 1
    gru_bwd.grids += GRU_BWD_GRIDS
    gru_bwd.bf16_launches += bf
    return out


def _launch_bwd(plan: PersistentPlan, mask_t: torch.Tensor, scans) -> list:
    """Enqueue one ``gru_bwd`` call of len(scans) scans (2 only on bf16
    streams, on plan's disjoint CTA ranges), each (xg_t, uh, bh, h0, hs_t,
    g_t, reverse), with its scratch: hg (h_prev @ Uh; bf16: the
    coefficients, 5H wide), dhg, base (the carry's direct part); bf16: dhg's
    bf16 copy and h0 rounded (the products' operands). Returns each scan's
    (dxg_t, duh, dbh, dh0); raises when the launcher refuses the plan or
    the launch fails."""
    xg_t = scans[0][0]
    T, B, H3 = xg_t.shape
    H, dev = H3 // 3, xg_t.device
    bf = xg_t.dtype == torch.bfloat16
    f32 = torch.float32
    cols = {"hg": (5 if bf else 3) * H, "dhg": 3 * H}
    sc = {k: [torch.empty((T, B, c), dtype=f32, device=dev) for _ in scans]
          for k, c in cols.items()}
    base = [torch.empty((B, H), dtype=f32, device=dev) for _ in scans]
    outs = [(torch.empty_like(x), torch.empty((B, H), dtype=f32, device=dev),
             torch.empty((H, H3), dtype=f32, device=dev),
             torch.empty((H3,), dtype=f32, device=dev))
            for x, *_ in scans]
    wl2 = (torch.empty(plan.l2_floats, dtype=f32, device=dev)
           if plan.l2_floats else None)
    w = [x[1].to(torch.bfloat16).contiguous() if bf else x[1] for x in scans]
    extra = ()
    if bf:   # held here until the launch is enqueued
        dhgb = [torch.empty_like(d, dtype=torch.bfloat16) for d in sc["dhg"]]
        h0b = [x[3].to(torch.bfloat16) for x in scans]
        extra = (_ptrs(dhgb), _ptrs(h0b))
    args = plan.launch_args()

    def col(i):
        return _ptrs([x[i] for x in scans])

    rc = _build.load("gru_bwd_bf16" if bf else "gru_bwd").gru_bwd_launch(
        len(scans), col(0), mask_t.data_ptr(), _ptrs(w), col(2), col(4),
        col(3), col(5), _ptrs(sc["hg"]), _ptrs(sc["dhg"]), _ptrs(base),
        _ptrs([o[0] for o in outs]), _ptrs([o[1] for o in outs]),
        _ptrs([o[2] for o in outs]), _ptrs([o[3] for o in outs]),
        _ints([int(x[6]) for x in scans]), T, B, H, _ints(args), len(args),
        None if wl2 is None else wl2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, *extra)
    if rc != 0:
        raise RuntimeError(f"gru_bwd kernel launch failed: CUDA error {rc} "
                           f"(plan {plan})")
    # (dxg, duh, dbh, dh0) in the order of the plain version
    return [(o[0], o[2], o[3], o[1]) for o in outs]


gru_bwd.launches = 0
gru_bwd.grids = 0
gru_bwd.bf16_launches = 0


def _check_pair(what: str, xgs, mask_t, uhs, bhs, h0s, streams=()) -> None:
    """The pair wrappers' argument checks: each direction's bf16 xg (T, B,
    3H), fp32 uh, bh, h0, and the bf16 ``streams`` (T, B, H)."""
    T, B, H3 = xgs[0].shape
    H = H3 // 3
    check_kernel_arg(mask_t, torch.float32, (T, B), f"{what}: mask_t")
    for d, (xg, uh, bh, h0) in enumerate(zip(xgs, uhs, bhs, h0s)):
        check_kernel_arg(xg, torch.bfloat16, (T, B, 3 * H), f"{what}: xg[{d}]")
        check_kernel_arg(uh, torch.float32, (H, 3 * H), f"{what}: uh[{d}]")
        check_kernel_arg(bh, torch.float32, (3 * H,), f"{what}: bh[{d}]")
        check_kernel_arg(h0, torch.float32, (B, H), f"{what}: h0[{d}]")
    for i, x in enumerate(streams):
        check_kernel_arg(x, torch.bfloat16, (T, B, H), f"{what}: stream {i}")


def gru_fwd_pair(xg_f: torch.Tensor, xg_b: torch.Tensor, mask_t: torch.Tensor,
                 uh_f: torch.Tensor, bh_f: torch.Tensor, uh_b: torch.Tensor,
                 bh_b: torch.Tensor, h0_f: torch.Tensor, h0_b: torch.Tensor,
                 *, impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions of the bi-GRU on bf16 streams: (hs_f, hs_b), the
    scan of xg_f forward and of xg_b in reverse, over one mask. impl as
    gru_fwd; plain: the two plain scans. The kernel path runs them as one
    grid of kernel 2b (csrc/gru_fwd_bf16.cu) tiled by
    ``gru_fwd_pair_plan``, each direction on CTAs of its own and a step of
    both one grid sync: it counts two in ``gru_fwd.launches`` and
    ``gru_fwd.bf16_launches`` (one a scan) and one in ``gru_fwd.grids``."""
    if resolve_impl(impl, xg_f) == "plain":
        return (gru_fwd_plain(xg_f, mask_t, uh_f, bh_f, h0_f),
                gru_fwd_plain(xg_b, mask_t, uh_b, bh_b, h0_b, reverse=True))
    _check_pair("gru_fwd_pair", (xg_f, xg_b), mask_t, (uh_f, uh_b),
                (bh_f, bh_b), (h0_f, h0_b))
    T, B, H3 = xg_f.shape
    H = H3 // 3
    Hp = padded_width(H)
    scans = []
    for xg, uh, bh, h0, rev in ((xg_f, uh_f, bh_f, h0_f, False),
                                (xg_b, uh_b, bh_b, h0_b, True)):
        if Hp != H:
            xg, uh, bh, h0 = pad_units(xg, uh, bh, h0, Hp)
        scans.append((xg, uh, bh, h0, rev))
    outs = _launch_bf16(gru_fwd_pair_plan(B, Hp, *_device_limits(xg_f.device)),
                        mask_t, scans)
    gru_fwd.launches += 2
    gru_fwd.grids += 1
    gru_fwd.bf16_launches += 2
    return tuple(o if Hp == H else o[..., :H].contiguous() for o in outs)


def gru_bwd_pair(xg_f: torch.Tensor, xg_b: torch.Tensor, mask_t: torch.Tensor,
                 uh_f: torch.Tensor, bh_f: torch.Tensor, uh_b: torch.Tensor,
                 bh_b: torch.Tensor, h0_f: torch.Tensor, h0_b: torch.Tensor,
                 hs_f: torch.Tensor, hs_b: torch.Tensor, g_f: torch.Tensor,
                 g_b: torch.Tensor, *, impl: str = "auto"):
    """Gradients of ``gru_fwd_pair``'s two scans: ((dxg_t, duh, dbh, dh0)
    forward, the same in reverse) given their states and cotangents, bf16
    streams. impl as gru_fwd; plain: the two plain backwards. The kernel
    path enqueues GRU_BWD_GRIDS grids of kernel 3b for both (each grid's
    tiles of both directions in one launch, the carry tiled by
    ``gru_bwd_pair_plan``, each direction on CTAs of its own): it counts
    two in ``gru_bwd.launches`` and ``gru_bwd.bf16_launches`` and those
    grids in ``gru_bwd.grids``."""
    if resolve_impl(impl, xg_f) == "plain":
        return (gru_bwd_plain(xg_f, mask_t, uh_f, bh_f, h0_f, hs_f, g_f),
                gru_bwd_plain(xg_b, mask_t, uh_b, bh_b, h0_b, hs_b, g_b,
                              reverse=True))
    _check_pair("gru_bwd_pair", (xg_f, xg_b), mask_t, (uh_f, uh_b),
                (bh_f, bh_b), (h0_f, h0_b), (hs_f, hs_b, g_f, g_b))
    T, B, H3 = xg_f.shape
    plan = gru_bwd_pair_plan(B, H3 // 3, *_device_limits(xg_f.device))
    out = _launch_bwd(plan, mask_t, [(xg_f, uh_f, bh_f, h0_f, hs_f, g_f, False),
                                     (xg_b, uh_b, bh_b, h0_b, hs_b, g_b, True)])
    gru_bwd.launches += 2
    gru_bwd.grids += GRU_BWD_GRIDS
    gru_bwd.bf16_launches += 2
    return tuple(out)

_GRU_BWD_ARGS = ([ctypes.c_int, _VP, ctypes.c_void_p] + [_VP] * 12 + [_IP]
                 + [ctypes.c_int] * 3 + [_IP, ctypes.c_int]
                 + [ctypes.c_void_p] * 2)
_build.declare("gru_bwd", "gru_bwd_launch", _GRU_BWD_ARGS, _SCAN_DEFINES)
# the bf16 instance's entry also takes dhg's bf16 copy and h0 rounded
_build.declare("gru_bwd_bf16", "gru_bwd_launch", _GRU_BWD_ARGS + [_VP] * 2,
               _GRU_BF16_DEFINES, src="gru_bwd")


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


class BiGRUScan(torch.autograd.Function):
    """Both directions of a bi-GRU on bf16 streams with their gradients:
    forward through ``gru_fwd_pair``, backward through ``gru_bwd_pair`` (on
    the card, one grid of kernel 2b and one call of kernel 3b for both
    directions). Inputs: each direction's xg_t, the shared mask_t, each
    direction's uh, bh, h0; outputs (hs_f, hs_b)."""

    @staticmethod
    def forward(ctx, xg_f, xg_b, mask_t, uh_f, bh_f, uh_b, bh_b, h0_f, h0_b,
                impl: str):
        hs_f, hs_b = gru_fwd_pair(xg_f, xg_b, mask_t, uh_f, bh_f, uh_b, bh_b,
                                  h0_f, h0_b, impl=impl)
        ctx.save_for_backward(xg_f, xg_b, mask_t, uh_f, bh_f, uh_b, bh_b,
                              h0_f, h0_b, hs_f, hs_b)
        ctx.impl = impl
        return hs_f, hs_b

    @staticmethod
    def backward(ctx, g_f, g_b):
        saved = ctx.saved_tensors
        (dxf, duf, dbf, dhf), (dxb, dub, dbb, dhb) = gru_bwd_pair(
            *saved, g_f.contiguous(), g_b.contiguous(), impl=ctx.impl)
        return dxf, dxb, None, duf, dbf, dub, dbb, dhf, dhb, None
