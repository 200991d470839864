#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. card and build: the card's name and power limit, and the build of every
     hand-written kernel under vag_nmt_tpu_torch/csrc/ (one nvcc each, all
     started together);
  2. readout_topk kernel against its plain PyTorch version at the beam-5
     decode shape of m30k_ende_vag (R=640 rows, E=256, V=8000, K=5);
  3. gru_fwd kernel (one persistent grid per scan) against its plain
     version at the encoders' shapes (B, T) = (1024, 32) m30k decode,
     (64, 24) training and (512, 120) ikea_vag (E=256, H=512), ragged
     lengths, both directions, and at the ragged batches of GRU_RAGGED
     (a last row block part full, two passes over the row blocks a step,
     under the card's plan and other tilings); at each path shape its
     grid alone, cold (L2 flushed) and warm, beside cuDNN's nn.GRU forward
     and the cuBLAS input projection alone (cuDNN minus it is the
     recurrence's yardstick), and the operations bound;
  4. the main path: translate_corpus at beam 5 on the full-width
     m30k_ende_vag model (random weights from a fixed seed) over a synthetic
     corpus, through the kernels (impl="auto"), with each kernel's launch
     count read from that run alone, then the same corpus with impl="plain"
     on the card and the share of identical hypotheses;
  5. where the time goes: the kernel path once more under torch.profiler
     (device activity only), giving the device's busy time, its idle share
     of the host wall, device launches per beam step and the top kernels;
  6. gru_bwd kernel against its plain version at the encoder's training
     shape (B=64, T=24, E=256, H=512), ragged lengths, both directions;
  7. dec_scan_fwd and dec_scan_bwd kernels against their plain versions at
     full width (B=64, T=Tt=24), ragged source mask: the readout, every
     residual and all 15 gradients;
  8. the training path: train_loop on the full-width m30k_ende_vag model
     (preset dropout 0.3, batch 64) from a seed's random init over a
     synthetic corpus of 2048 pairs, 40 steps and one dev eval, with each
     kernel's launch count read from that run alone, steps/s, target
     tokens/s and the first and last loss; then 5 steps through the kernels
     and through the plain versions from the same init and dropout draws;
     then 3 steps under torch.profiler, as phase 5;
  9. beam_topk kernel against its plain version at the unfused beam step's
     shape (B=128, K=5, V=8000), exactly, with finished rows and forced ties,
     and on the split cases (ragged V=8003, B=1 over many vocab slices, ties
     straddling a slice boundary and across beams, K=1, K=8, all finished);
     before it, kernels 6, 8 and 9 timed as grids alone at V=8000 and 16000,
     cold (L2 flushed) and warm, beside torch.topk on the candidates;
 10. dec_step kernel against its plain version at full width (B=128, K=5,
     T=32) and at a ragged shape, with masked source positions;
 11. the serving path: Translator.from_run on phase 8's run dir (its
     checkpoint, plus config.json and vocab files written here), then a
     1024-line raw-text request at batch 128 in six modes: (a) the default
     streaming pool, (b) the pool with VAG_DEC_STEP=on, (c) streaming off,
     (d) VAG_READOUT_TOPK=unfused, (e) bulk=True, (f) greedy on 128 lines;
     each kernel's launches read from each mode alone, the shares of
     identical hypotheses between modes, and (a) and (b) under the profiler;
 12. legacy_topk_blocks and legacy_topk_rows (the two legacy beam top-K
     kernels) against their plain versions at (B, K, V) = (128, 5, 16000)
     and (128, 5, 8000), exactly: random, all-finished and forced ties
     across 512-blocks, where each follows its own tie rule; gen 2 on the
     split cases of phase 9;
 13. the readout_topk kernel's shallow-slot watermark mode at R=640, E=256,
     V=16000, slot depths 1 and 3: every row's viol as the plain version's
     under the kernel's lane map, unflagged rows and the per-step recovery
     bit for bit as depth K, a lane collision, a ban mask, the deferred
     live flag (all-frozen rows do not arm it);
 14. the long-caption decode: translate_corpus on the full-width ikea_vag
     model (V=16000, max_len 128, random weights from a seed, the output
     matrix scaled by IKEA_READOUT_SCALE) over 512
     synthetic sentences of 40-120 source tokens, in the eight modes of
     IKEA_MODES (two-phase at depth K and with per-step recovery; chunked
     with the deferred chunk rerun, per-step, unrolled; the unfused step
     through kernels 8, 9 and 6), each kernel's launches read from its own
     mode, the shares of identical hypotheses between modes, and (a), (b),
     (g) and (h) under the profiler.
Phase 1 builds all eight sources. It prints one JSON line of per-kernel
numbers and, last, the device line. With --gru-grids it prints phase 3's
grid times alone (see main).
Needs torch with CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

# Kernel against plain tolerances.
READOUT_RTOL = 1e-5      # values and lse, relative; ids must be equal
# The GRU kernel sums the 512-term h @ Uh products in another order than
# cuBLAS, and the error passes through sigmoid/tanh and 32 recurrent steps.
GRU_ATOL = 1e-4
# Share of identical hypotheses, kernels against plain, on the main path
# (measured 0.9678 on an H100 SXM at 700 W for this corpus and seed).
# An untrained model has near-tied logits, so a last-bit difference can
# flip a beam; exactness is held in phases 2 and 3.
MIN_IDENTICAL_SHARE = 0.95

N_SENT = 1024

# Training shapes (m30k_ende_vag: batch 64; 24 is a source/target bucket).
TRAIN_B, TRAIN_T = 64, 24
# Kernel against plain, training kernels: error over the reference's scale
# (see _rel_err). The kernels sum their products in another order than
# cuBLAS, through 24 recurrent steps, and the weight grads sum B*T terms.
GRU_BWD_RTOL = 1e-4
DEC_SCAN_RTOL = 1e-4
# The training path: a synthetic corpus, steps through train_loop, then
# kernels against plain over the first steps, then a profiled few steps.
N_TRAIN_PAIRS, N_DEV_PAIRS = 2048, 64
N_TRAIN_STEPS, N_COMPARE_STEPS, N_PROFILE_STEPS = 40, 5, 3
# Losses and grad norms, kernels against plain, relative: Adam turns a
# gradient that is roundoff-sized in one path into a full lr-sized update,
# so the paths drift apart a little over the steps.
TRAIN_RTOL = 1e-3
# The fused decode step against its plain version, error over the
# reference's scale (see _rel_err): its GEMMs and attention sums run in
# another order than cuBLAS and torch's reductions.
DEC_STEP_RTOL = 1e-4
# The serving request: raw-text lines, and the greedy mode's share of them.
N_SERVE, N_GREEDY = 1024, 128


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def _time_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return _median(times)


# Grid-only timings: a read of FLUSH_BYTES (more than the H100's 50 MB L2,
# and a read, so the timed grid finds no dirty lines to write back) before
# each cold launch, then HOLD_CYCLES of device sleep so the host has
# enqueued the event pair and the launch before the device reaches them;
# WARM_LAUNCHES back to back behind WARM_HOLD_CYCLES of sleep.
FLUSH_BYTES = 96 << 20
HOLD_CYCLES = 200_000
WARM_LAUNCHES, WARM_HOLD_CYCLES = 200, 20_000_000


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _grid_ms(torch, launch, reps: int = 41):
    """(cold, warm) device ms of one launch(): cold is the median of
    per-launch event pairs with L2 flushed before each, warm the time of
    WARM_LAUNCHES back-to-back launches over their count. launch() enqueues
    the grid alone (inputs and outputs made beforehand)."""
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in pairs:
        flush.sum()
        torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        launch()
        b.record()
    torch.cuda.synchronize()
    cold = _median([a.elapsed_time(b) for a, b in pairs])
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(WARM_HOLD_CYCLES)
    a.record()
    for _ in range(WARM_LAUNCHES):
        launch()
    b.record()
    torch.cuda.synchronize()
    return cold, a.elapsed_time(b) / WARM_LAUNCHES


def _bound(flops: float, nbytes: float):
    """Least time on the card (ms) and what bounds it, against the H100 SXM's
    fp32 peak outside the tensor cores and its HBM rate (core/flops.py)."""
    from vag_nmt_tpu_torch.core.flops import (H100_HBM_BYTES_PER_S,
                                              H100_PEAK_FP32_FLOPS)

    t_ops = flops / H100_PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_readout(torch, np, dev):
    from vag_nmt_tpu_torch.ops import readout_topk as rt

    B, K, E, V, M = 128, 5, 256, 8000, 12
    R = B * K
    rng = np.random.RandomState(1)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def case(kind):
        if kind == "integer":
            t = rng.randint(-3, 4, (R, E)).astype(np.float32)
            w = rng.randint(-3, 4, (E, V)).astype(np.float32)
            b = rng.randint(-3, 4, V).astype(np.float32)
            scores = rng.randint(-5, 5, (B, K)).astype(np.float32)
        else:
            t = np.tanh(rng.randn(R, E)).astype(np.float32)
            w = (0.05 * rng.randn(E, V)).astype(np.float32)
            b = (0.1 * rng.randn(V)).astype(np.float32)
            scores = rng.randn(B, K).astype(np.float32)
        fin = rng.rand(B, K) < (1.0 if kind == "all_finished" else 0.2)
        ban = None
        if kind == "ban":
            ban = rng.randint(0, V + 1, (R, M))          # V = sentinel
            ban[:, -1] = ban[:, 0]                        # duplicates
            ban = cuda(ban)
        return cuda(t), cuda(w), cuda(b), cuda(scores), cuda(fin), ban

    max_err = 0.0
    for kind in ("random", "integer", "all_finished", "ban"):
        t, w, b, scores, fin, ban = case(kind)
        mask = None if ban is None else rt.ban_mask(ban, V)
        kv, ki, kl = rt.readout_topk_rows(t, w, b, K, mask, impl="kernel")
        pv, pi, pl = rt.readout_topk_rows_plain(t, w, b, K, mask)
        torch.cuda.synchronize()
        if not torch.equal(ki, pi):
            raise AssertionError(f"readout_topk {kind}: ids differ in "
                                 f"{int((ki != pi).sum())} places")
        for name, a, c in (("vals", kv, pv), ("lse", kl, pl)):
            if not torch.allclose(a, c, rtol=READOUT_RTOL, atol=0.0):
                raise AssertionError(f"readout_topk {kind}: {name} off by "
                                     f"{float((a - c).abs().max())}")
            max_err = max(max_err, float((a - c).abs().max()))
        if kind == "integer" and not torch.equal(kv, pv):
            raise AssertionError("readout_topk integer: values not exact")
        fk = rt.fused_readout_topk(t, w, b, scores, fin, ban, impl="kernel")
        fp = rt.fused_readout_topk(t, w, b, scores, fin, ban, impl="plain")
        if not torch.equal(fk[1], fp[1]):
            raise AssertionError(f"fused_readout_topk {kind}: ids differ")
        if not torch.allclose(fk[0], fp[0], rtol=READOUT_RTOL, atol=0.0):
            raise AssertionError(f"fused_readout_topk {kind}: values off by "
                                 f"{float((fk[0] - fp[0]).abs().max())}")
        print(f"readout_topk {kind}: ok")

    t, w, b, *_ = case("random")
    ms = _time_ms(torch, lambda: rt.readout_topk_rows(t, w, b, K, impl="kernel"))
    plain_ms = _time_ms(torch, lambda: rt.readout_topk_rows_plain(t, w, b, K))
    bound_ms, bound_by = _bound(2.0 * R * E * V,
                                4.0 * (R * E + E * V + V) + 8.0 * R * K + 4.0 * R)
    print(f"readout_topk: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) max_abs_err={max_err:.3g}")
    return {"name": "readout_topk", "route": "cuda",
            "source": "vag_nmt_tpu_torch/csrc/readout_topk.cu",
            "replaces": "vag_nmt_tpu/ops/pallas_readout_topk.py:113",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# gru_fwd's shapes on the paths (label, B, T): the m30k decode's encoder
# super chunk, the m30k training batch, the ikea_vag encoder over 40-120
# token captions; E and H of both presets.
GRU_SHAPES = (("decode", 1024, 32), ("train", TRAIN_B, TRAIN_T),
              ("ikea", 512, 120))
GRU_E, GRU_H = 256, 512


def _gru_case(torch, np, dev, B, T, seed):
    """(x, params, xg_t, mask_t, h0) of one direction at (B, T), random
    biases and ragged lengths (every row at least min(4, T) tokens, one
    full)."""
    from vag_nmt_tpu_torch.ops.gru import init_gru_params

    rng = np.random.RandomState(seed)
    p = {k: v.to(dev) for k, v in
         init_gru_params(torch.Generator().manual_seed(seed), GRU_E, GRU_H).items()}
    for k in ("bi", "bh"):
        p[k] = torch.from_numpy((0.1 * rng.randn(3 * GRU_H)).astype(np.float32)).to(dev)
    x = torch.from_numpy((0.5 * rng.randn(T, B, GRU_E)).astype(np.float32)).to(dev)
    lens = rng.randint(min(4, T), T + 1, B)
    lens[0] = T
    lens = torch.from_numpy(lens).to(dev)
    mask_t = (torch.arange(T, device=dev)[:, None] < lens[None, :]).float().contiguous()
    xg_t = (x @ p["wi"] + p["bi"]).contiguous()
    h0 = torch.zeros((B, GRU_H), device=dev)
    return x, p, xg_t, mask_t, h0


def gru_grid_times(torch, np, dev):
    """gru_fwd at GRU_SHAPES, cold and warm (_grid_ms), through the wrapper
    of whichever vag_nmt_tpu_torch is first on sys.path: its only device
    work is the kernel's grids (one persistent grid; T step grids in the
    trees before it), so the event pair times the grids alone.
    {label: (cold, warm)}."""
    from vag_nmt_tpu_torch.ops.gru_kernel import gru_fwd

    out = {}
    for label, B, T in GRU_SHAPES:
        _, p, xg_t, mask_t, h0 = _gru_case(torch, np, dev, B, T, seed=2)
        out[label] = _grid_ms(torch, lambda: gru_fwd(
            xg_t, mask_t, p["uh"], p["bh"], h0, impl="kernel"))
    return out


# gru_fwd's ragged checks, against the plain version within GRU_ATOL, both
# directions (label, B, T, tiling): B not a whole number of row blocks
# (1000 is the line count of Multi30k test2016; its last block holds 104
# of 128 rows), under the card's plan ("plan"), the plan for half the
# card's SMs (two passes over the row blocks a step, the ragged block in
# the second), and a hand tiling of two passes (rows a thread, row_block,
# unit_block, chunk, row_slots; H = GRU_H).
GRU_RAGGED = (("test2016", 1000, 32, "plan"), ("toy", 37, 24, "plan"),
              ("test2016 half card", 1000, 32, "half"),
              ("test2016 two passes", 1000, 32, (4, 64, 32, 32, 8)))


def _gru_ragged_checks(torch, np, dev):
    """Max abs error of gru_fwd against gru_fwd_plain over GRU_RAGGED; the
    tilings other than the card's plan go straight to the launcher."""
    from vag_nmt_tpu_torch.ops import _build
    from vag_nmt_tpu_torch.ops.gru_kernel import (GruFwdPlan, _device_limits,
                                                  _launch, gru_fwd,
                                                  gru_fwd_plain, gru_fwd_plan)

    fn, max_err = _build.load("gru_fwd").gru_fwd_launch, 0.0
    for label, B, T, tiling in GRU_RAGGED:
        _, p, xg_t, mask_t, h0 = _gru_case(torch, np, dev, B, T, seed=3)
        args = (xg_t, mask_t, p["uh"], p["bh"], h0)
        n_sms, max_smem = _device_limits(xg_t.device)
        if tiling == "plan":
            plan = gru_fwd_plan(B, GRU_H, n_sms, max_smem)
        elif tiling == "half":
            plan = gru_fwd_plan(B, GRU_H, n_sms // 2, max_smem)
        else:
            R, RB, UB, KC, GX = tiling
            plan = GruFwdPlan(R, RB, UB, KC, -(-B // RB), GX, GRU_H // UB)
        if B % plan.row_block == 0 or (tiling != "plan" and plan.passes < 2):
            raise AssertionError(f"gru_fwd ragged check {label}: {plan} "
                                 "has no ragged block or a single pass")
        for reverse in (False, True):
            hk = (gru_fwd(*args, reverse=reverse, impl="kernel")
                  if tiling == "plan" else _launch(fn, plan, *args, reverse))
            e = float((hk - gru_fwd_plain(*args, reverse=reverse)).abs().max())
            if not e <= GRU_ATOL:
                raise AssertionError(f"gru_fwd {label} (B={B}, T={T}, {plan}) "
                                     f"reverse={reverse}: max abs err {e}")
            max_err = max(max_err, e)
        print(f"gru_fwd ragged {label} (B={B}, T={T}, grid {plan.grid}, "
              f"{plan.passes} passes) both directions: ok")
    return max_err


def phase_gru(torch, np, dev):
    """gru_fwd against gru_fwd_plain at GRU_SHAPES, both directions; its
    grid alone at each shape beside cuDNN's nn.GRU forward and the cuBLAS
    input projection (yardsticks the port never calls), and its bound."""
    from vag_nmt_tpu_torch.ops.gru_kernel import (_device_limits, gru_fwd,
                                                  gru_fwd_plain, gru_fwd_plan)

    max_err, shapes = 0.0, []
    for label, B, T in GRU_SHAPES:
        x, p, xg_t, mask_t, h0 = _gru_case(torch, np, dev, B, T, seed=2)
        err = 0.0
        for reverse in (False, True):
            hk = gru_fwd(xg_t, mask_t, p["uh"], p["bh"], h0, reverse=reverse,
                         impl="kernel")
            hp = gru_fwd_plain(xg_t, mask_t, p["uh"], p["bh"], h0,
                               reverse=reverse)
            torch.cuda.synchronize()
            e = float((hk - hp).abs().max())
            if not e <= GRU_ATOL:
                raise AssertionError(f"gru_fwd {label} (B={B}, T={T}) "
                                     f"reverse={reverse}: max abs err {e}")
            err = max(err, e)
        max_err = max(max_err, err)
        # Yardsticks: cuDNN's GRU forward at the same (T, B, E, H), fp32
        # with TF32 off, which also does the input projection; and that
        # projection alone, so cudnn - projection is the recurrence's.
        cudnn = torch.nn.GRU(GRU_E, GRU_H).to(dev)
        x2, proj = x.reshape(T * B, GRU_E), torch.empty_like(xg_t).reshape(T * B, -1)
        with torch.no_grad():
            cudnn_ms = _grid_ms(torch, lambda: cudnn(x))
        proj_ms = _grid_ms(torch, lambda: torch.addmm(p["bi"], x2, p["wi"],
                                                      out=proj))
        H = GRU_H
        bound_ms, bound_by = _bound(
            2.0 * T * B * H * 3 * H,
            4.0 * (T * B * 3 * H + T * B + H * 3 * H + 3 * H + B * H + T * B * H))
        plan = gru_fwd_plan(B, H, *_device_limits(xg_t.device))
        f = {"shape": label, "B": B, "T": T, "cudnn_ms": cudnn_ms[0],
             "cudnn_warm_ms": cudnn_ms[1], "projection_ms": proj_ms[0],
             "projection_warm_ms": proj_ms[1],
             "recurrence_library_ms": cudnn_ms[0] - proj_ms[0],
             "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
             "plan": {"grid": list(plan.grid), "threads": plan.threads,
                      "rows_per_thread": plan.rows_per_thread,
                      "row_block": plan.row_block,
                      "unit_block": plan.unit_block, "chunk": plan.chunk,
                      "smem_bytes": plan.smem_bytes}}
        shapes.append(f)
        print(f"gru_fwd {label} (B={B}, T={T}) both directions: ok "
              f"(max abs err {err:.3g})")
    max_err = max(max_err, _gru_ragged_checks(torch, np, dev))
    grids = gru_grid_times(torch, np, dev)
    for f in shapes:
        f["grid_ms"], f["grid_warm_ms"] = grids[f["shape"]]
        f["grid_bound_share"] = f["bound_ms"] / f["grid_ms"]
        print(f"gru_fwd grid {f['shape']}: " + json.dumps(f))

    x, p, xg_t, mask_t, h0 = _gru_case(torch, np, dev, *GRU_SHAPES[0][1:], seed=2)
    ms = _time_ms(torch, lambda: gru_fwd(xg_t, mask_t, p["uh"], p["bh"], h0,
                                         impl="kernel"), reps=20)
    plain_ms = _time_ms(torch, lambda: gru_fwd_plain(xg_t, mask_t, p["uh"],
                                                     p["bh"], h0), reps=10)
    cudnn = torch.nn.GRU(GRU_E, GRU_H).to(dev)
    with torch.no_grad():
        library_ms = _time_ms(torch, lambda: cudnn(x), reps=20)
    dec = shapes[0]
    print(f"gru_fwd (one direction, decode shape): kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={dec['bound_ms']:.4f} ({dec['bound_by']})")
    return {"name": "gru_fwd", "route": "cuda",
            "source": "vag_nmt_tpu_torch/csrc/gru_fwd.cu",
            "replaces": "vag_nmt_tpu/ops/pallas_gru.py:114",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
            "library_ms": library_ms, "grid_ms": dec["grid_ms"],
            "grid_warm_ms": dec["grid_warm_ms"],
            "projection_ms": dec["projection_ms"], "shapes": shapes}


def _rel_err(a, b) -> float:
    """max |a - b| over max(1, max |b|): the error relative to the
    reference's scale (weight grads are sums of B*T terms)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def phase_gru_bwd(torch, np, dev):
    """gru_bwd against gru_bwd_plain at the encoder's training shape."""
    from vag_nmt_tpu_torch.ops.gru import init_gru_params
    from vag_nmt_tpu_torch.ops.gru_kernel import gru_bwd, gru_bwd_plain, gru_fwd

    B, T, E, H = TRAIN_B, TRAIN_T, 256, 512
    rng = np.random.RandomState(6)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    p = {k: v.to(dev) for k, v in
         init_gru_params(torch.Generator().manual_seed(6), E, H).items()}
    bh = cuda(0.1 * rng.randn(3 * H))
    x = cuda(0.5 * rng.randn(T, B, E))
    xg_t = (x @ p["wi"] + cuda(0.1 * rng.randn(3 * H))).contiguous()
    lens = torch.from_numpy(rng.randint(4, T + 1, B)).to(dev)
    mask_t = (torch.arange(T, device=dev)[:, None] < lens[None, :]).float().contiguous()
    h0 = cuda(0.5 * rng.randn(B, H))
    g_t = cuda(rng.randn(T, B, H))
    errs, abs_err = {}, 0.0
    for reverse in (False, True):
        hs_t = gru_fwd(xg_t, mask_t, p["uh"], bh, h0, reverse=reverse,
                       impl="plain")
        got = gru_bwd(xg_t, mask_t, p["uh"], bh, h0, hs_t, g_t,
                      reverse=reverse, impl="kernel")
        want = gru_bwd_plain(xg_t, mask_t, p["uh"], bh, h0, hs_t, g_t,
                             reverse=reverse)
        torch.cuda.synchronize()
        for name, a, b in zip(("dxg", "duh", "dbh", "dh0"), got, want):
            err = _rel_err(a, b)
            errs[name] = max(errs.get(name, 0.0), err)
            abs_err = max(abs_err, float((a - b).abs().max()))
            if not err <= GRU_BWD_RTOL:
                raise AssertionError(f"gru_bwd reverse={reverse} {name}: "
                                     f"relative err {err}")
        masked = (mask_t == 0)[:, :, None].expand(T, B, 3 * H)
        if masked.any() and float(got[0][masked].abs().max()) != 0.0:
            raise AssertionError("gru_bwd: dxg is not 0 at masked steps")
        print(f"gru_bwd reverse={reverse}: ok")
    print(f"gru_bwd relative errors: {json.dumps(errs)}")

    hs_t = gru_fwd(xg_t, mask_t, p["uh"], bh, h0, impl="plain")
    args = (xg_t, mask_t, p["uh"], bh, h0, hs_t, g_t)
    ms = _time_ms(torch, lambda: gru_bwd(*args, impl="kernel"), reps=20)
    plain_ms = _time_ms(torch, lambda: gru_bwd_plain(*args), reps=10)
    # Yardstick only (the port never calls it): cuDNN's GRU forward +
    # backward minus its forward at the same (T, B, E, H), TF32 off; it also
    # does the input projection's backward.
    cudnn = torch.nn.GRU(E, H).to(dev)
    xr = x.clone().requires_grad_(True)
    gy = torch.randn(T, B, H, device=dev)

    def fwd_bwd():
        y, _ = cudnn(xr)
        y.backward(gy)

    with torch.no_grad():
        cudnn_fwd_ms = _time_ms(torch, lambda: cudnn(x), reps=20)
    library_ms = _time_ms(torch, fwd_bwd, reps=20) - cudnn_fwd_ms
    flops = 3 * 2.0 * T * B * H * 3 * H
    nbytes = 4.0 * (2 * T * B * 3 * H + T * B + H * 3 * H + 3 * H + 2 * B * H
                    + 2 * T * B * H + H * 3 * H + 3 * H)
    bound_ms, bound_by = _bound(flops, nbytes)
    print(f"gru_bwd (one direction, B={B}, T={T}): kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by})")
    return {"name": "gru_bwd", "route": "cuda",
            "source": "vag_nmt_tpu_torch/csrc/gru_bwd.cu",
            "replaces": "vag_nmt_tpu/ops/pallas_gru.py:180",
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _dec_scan_case(torch, np, dev):
    """Full-width decoder-scan inputs at B=TRAIN_B, T=Tt=TRAIN_T, ragged
    source mask, random biases, the bias folding applied."""
    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.ops.dec_scan import scan_weights

    m = vt.preset("m30k_ende_vag").model
    B, T, Tt = TRAIN_B, TRAIN_T, TRAIN_T
    H, A, C, R = m.dec_hidden_dim, m.attn_dim, m.ctx_dim, m.emb_dim
    rng = np.random.RandomState(7)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    params = vt.init_params(m, torch.Generator().manual_seed(7), device=dev)
    d = params["decoder"]
    for g in ("gru1", "gru2"):
        for b in ("bi", "bh"):
            d[g][b] = cuda(0.1 * rng.randn(3 * H))
    weights = tuple(w.contiguous() for w in scan_weights(d))
    lens = rng.randint(4, T + 1, B)
    mask = cuda(np.arange(T)[None, :] < lens[:, None])
    ctx = cuda(0.5 * rng.randn(B, T, C))
    ctxp = (ctx @ d["attn"]["wa"] + cuda(0.1 * rng.randn(A))).contiguous()
    inputs = (cuda(0.5 * rng.randn(Tt, B, R)),            # ty (+b)
              cuda(0.5 * rng.randn(Tt, B, 3 * H)),        # xg1
              cuda(0.5 * rng.randn(B, H)), ctx, ctxp, mask)
    g_t = cuda(rng.randn(Tt, B, R))
    return inputs, weights, g_t, (B, T, Tt, H, A, C, R)


def _dec_scan_flops(B, T, Tt, H, A, C, R):
    """(forward, backward) operations of the scan at these shapes: the GEMMs
    (2 per multiply-add) and the attention's products over T positions."""
    gemm = 2.0 * B * (H * 3 * H + H * A + H * 3 * H + C * 3 * H + H * R + C * R)
    fwd = Tt * (gemm + 2.0 * B * T * (A + C))
    # backward: every GEMM once transposed and once as a weight reduction;
    # attention: dw, dctx, the energies' da and the dq / dva sums
    bwd = Tt * (2 * gemm + 2.0 * B * T * (2 * C + 3 * A))
    return fwd, bwd


def phase_dec_scan(torch, np, dev):
    """dec_scan_fwd / dec_scan_bwd against their plain versions at full
    width: the readout and every residual, and all grads."""
    from vag_nmt_tpu_torch.ops.dec_scan import (
        RESIDUALS, dec_scan_bwd, dec_scan_bwd_plain, dec_scan_fwd,
        dec_scan_fwd_plain)

    inputs, weights, g_t, shape = _dec_scan_case(torch, np, dev)
    B, T, Tt, H, A, C, R = shape
    got = dec_scan_fwd(*inputs, weights, impl="kernel")
    want = dec_scan_fwd_plain(*inputs, weights)
    torch.cuda.synchronize()
    fwd_err = fwd_abs = 0.0
    for k in RESIDUALS:
        err = _rel_err(got[k], want[k])
        fwd_err = max(fwd_err, err)
        fwd_abs = max(fwd_abs, float((got[k] - want[k]).abs().max()))
        if not err <= DEC_SCAN_RTOL:
            raise AssertionError(f"dec_scan_fwd {k}: relative err {err}")
    print(f"dec_scan_fwd: ok (max relative err {fwd_err:.3g})")
    xg_t, ctx, ctxp, mask = inputs[1], inputs[3], inputs[4], inputs[5]
    gk = dec_scan_bwd(want, xg_t, ctx, ctxp, mask, weights, g_t, impl="kernel")
    gp = dec_scan_bwd_plain(want, xg_t, ctx, ctxp, mask, weights, g_t)
    torch.cuda.synchronize()
    names = ("dty", "dxg1", "ds0", "dctx", "dctx_proj", "duh1", "dbh1", "dua",
             "dva", "dwi2", "dbi2", "duh2", "dbh2", "dws", "dwc")
    bwd_errs, bwd_abs = {}, 0.0
    for name, a, b in zip(names, gk, gp):
        bwd_errs[name] = _rel_err(a, b)
        bwd_abs = max(bwd_abs, float((a - b).abs().max()))
        if not bwd_errs[name] <= DEC_SCAN_RTOL:
            raise AssertionError(f"dec_scan_bwd {name}: relative err "
                                 f"{bwd_errs[name]}")
    print(f"dec_scan_bwd: ok, relative errors {json.dumps(bwd_errs)}")

    fwd_flops, bwd_flops = _dec_scan_flops(B, T, Tt, H, A, C, R)
    w_bytes = 4.0 * sum(w.numel() for w in weights)
    io = 4.0 * (Tt * B * (R + 3 * H) + B * H + B * T * (C + A + 1))
    res_bytes = 4.0 * sum(want[k].numel() for k in RESIDUALS)
    out = []
    for name, fn, plain, flops, nbytes, err, line in (
            ("dec_scan_fwd",
             lambda: dec_scan_fwd(*inputs, weights, impl="kernel"),
             lambda: dec_scan_fwd_plain(*inputs, weights),
             fwd_flops, w_bytes + io + res_bytes, fwd_abs, 165),
            ("dec_scan_bwd",
             lambda: dec_scan_bwd(want, xg_t, ctx, ctxp, mask, weights, g_t,
                                  impl="kernel"),
             lambda: dec_scan_bwd_plain(want, xg_t, ctx, ctxp, mask, weights,
                                        g_t),
             bwd_flops, 2 * w_bytes + 2 * io + res_bytes + 4.0 * g_t.numel(),
             bwd_abs, 286)):
        ms = _time_ms(torch, fn, reps=10)
        plain_ms = _time_ms(torch, plain, reps=5)
        bound_ms, bound_by = _bound(flops, nbytes)
        print(f"{name} (B={B}, T=Tt={T}): kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
        out.append({"name": name, "route": "cuda",
                    "source": f"vag_nmt_tpu_torch/csrc/{name}.cu",
                    "replaces": f"vag_nmt_tpu/ops/pallas_dec_scan.py:{line}",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None})
    return out


def phase_main(torch, np, dev):
    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.core.config import SPECIALS
    from vag_nmt_tpu_torch.data.batching import Example
    from vag_nmt_tpu_torch.data.vocab import Vocab
    from vag_nmt_tpu_torch.ops.gru_kernel import gru_fwd
    from vag_nmt_tpu_torch.ops.readout_topk import readout_topk_rows

    cfg = vt.preset("m30k_ende_vag")
    m = cfg.model
    params = vt.init_params(m, torch.Generator().manual_seed(0), device=dev)
    rng = np.random.RandomState(0)
    examples = []
    for i in range(N_SENT):
        L = int(np.clip(rng.normal(13, 4), 4, 32))
        examples.append(Example(src=list(rng.randint(4, m.src_vocab_size, L)),
                                img=rng.randn(m.img_feat_dim).astype(np.float32),
                                index=i))
    vocab = Vocab(list(SPECIALS) + [f"t{i}" for i in range(m.tgt_vocab_size - 4)])
    img_table = vt.build_img_table(examples, m.img_feat_dim, device=dev)

    # warm-up (allocator, cuBLAS handles) on one chunk
    vt.translate_corpus(params, cfg, examples[:128], vocab, img_table=img_table)
    torch.cuda.synchronize()

    wrappers = {"gru_fwd": gru_fwd, "readout_topk": readout_topk_rows}
    for fn in wrappers.values():
        fn.launches = 0
        fn.grids = 0

    def run(impl):
        return vt.translate_corpus(params, cfg, examples, vocab,
                                   img_table=img_table, impl=impl)

    hyps, st = run("auto")
    launches = {n: fn.launches for n, fn in wrappers.items()}
    grids = {n: fn.grids for n, fn in wrappers.items()}
    print(f"main path (kernels): sentences_per_sec={st['sentences_per_sec']:.1f} "
          f"elapsed_s={st['elapsed_s']:.4f} t_src={st['t_src']} "
          f"n_chunks={st['n_chunks']} beam_loop_steps={st['beam_loop_steps']} "
          f"chunk_steps={st['chunk_steps']} launches={launches} grids={grids}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if launches["readout_topk"] != st["beam_loop_steps"]:
        raise AssertionError("readout_topk launches != beam loop steps")
    if len(hyps) != N_SENT or not all(isinstance(h, str) for h in hyps):
        raise AssertionError("malformed hypotheses")
    if not any(hyps):
        raise AssertionError("every hypothesis is empty")

    hyps_p, st_p = run("plain")
    share = sum(a == b for a, b in zip(hyps, hyps_p)) / N_SENT
    print(f"main path (plain): sentences_per_sec={st_p['sentences_per_sec']:.1f} "
          f"elapsed_s={st_p['elapsed_s']:.4f} "
          f"beam_loop_steps={st_p['beam_loop_steps']}")
    print(f"identical hypotheses kernels vs plain: {share:.4f} "
          f"(threshold {MIN_IDENTICAL_SHARE})")
    if share < MIN_IDENTICAL_SHARE:
        raise AssertionError(f"only {share:.4f} of hypotheses identical")
    return launches, grids, lambda: run("auto")[1]["beam_loop_steps"]


def _zipf_tokens(np, rng, vocab: int, n: int):
    """n token ids in [4, vocab) drawn with probability ~ 1/rank, the shape
    of a natural-language unigram distribution."""
    p = 1.0 / np.arange(1, vocab - 3)
    return list(4 + rng.choice(vocab - 4, n, p=p / p.sum()))


def _train_corpus(np, m, n: int, seed: int):
    """n pairs with Zipf tokens, lengths normal(13, 4) clipped to 4..32, and
    pool5-like image features: a fixed random projection of the source
    tokens, averaged and rectified, so image and sentence share content
    (features unrelated to the text let the grounding loss only collapse)."""
    from vag_nmt_tpu_torch.data.batching import Example

    rng = np.random.RandomState(seed)
    proj = (np.random.RandomState(4).randn(m.src_vocab_size, m.img_feat_dim)
            / 4).astype(np.float32)
    out = []
    for i in range(n):
        ls, lt = (int(np.clip(rng.normal(13, 4), 4, 32)) for _ in range(2))
        src = _zipf_tokens(np, rng, m.src_vocab_size, ls)
        out.append(Example(src=src,
                           tgt=_zipf_tokens(np, rng, m.tgt_vocab_size, lt),
                           img=np.maximum(proj[src].mean(0), 0.0), index=i))
    return out


def phase_train(torch, np, dev):
    """The training path: train_loop on the full-width m30k_ende_vag model
    from the seed's random init, with each kernel's launches read from that
    run alone; then N_COMPARE_STEPS steps through the kernels and through
    the plain versions from the same init and the same dropout draws."""
    from pathlib import Path

    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.core.config import SPECIALS
    from vag_nmt_tpu_torch.data.batching import BucketBatcher
    from vag_nmt_tpu_torch.data.vocab import Vocab
    from vag_nmt_tpu_torch.ops.dec_scan import dec_scan_bwd, dec_scan_fwd
    from vag_nmt_tpu_torch.ops.gru_kernel import gru_bwd, gru_fwd
    from vag_nmt_tpu_torch.ops.readout_topk import readout_topk_rows
    from vag_nmt_tpu_torch.train.loop import _step_rows
    from vag_nmt_tpu_torch.train.state import tree_leaves

    cfg = vt.preset("m30k_ende_vag").replace(train=dict(
        eval_every_steps=N_TRAIN_STEPS, log_every_steps=N_TRAIN_STEPS - 1))
    m = cfg.model
    train = _train_corpus(np, m, N_TRAIN_PAIRS, seed=8)
    dev_set = _train_corpus(np, m, N_DEV_PAIRS, seed=9)
    vocab = Vocab(list(SPECIALS) + [f"t{i}" for i in range(m.tgt_vocab_size - 4)])
    refs = [" ".join(vocab.itos[t] for t in ex.tgt) for ex in dev_set]
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(out_dir, ignore_errors=True)

    wrappers = {"gru_fwd": gru_fwd, "gru_bwd": gru_bwd,
                "dec_scan_fwd": dec_scan_fwd, "dec_scan_bwd": dec_scan_bwd,
                "readout_topk": readout_topk_rows}
    for fn in wrappers.values():
        fn.launches = 0
        fn.grids = 0
    t0 = time.perf_counter()
    final = vt.train_loop(cfg, str(out_dir), train, dev_set, vocab, refs,
                          max_steps=N_TRAIN_STEPS, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in wrappers.items()}
    grids = {n: fn.grids for n, fn in wrappers.items()}
    recs = [json.loads(line) for line in open(out_dir / "metrics.jsonl")]
    ckpts = sorted(p.name for p in (out_dir / cfg.train.checkpoint_dir).iterdir())
    rows = [r for r in recs if r["tag"] == "train"]
    first, last = rows[0], rows[-1]
    if (first["step"], last["step"]) != (1, N_TRAIN_STEPS):
        raise AssertionError(f"expected log rows at steps 1 and "
                             f"{N_TRAIN_STEPS}: {[r['step'] for r in rows]}")
    if final["steps"] != N_TRAIN_STEPS:
        raise AssertionError(f"train_loop ran {final['steps']} steps")
    if "state_best.pt" not in ckpts or "state_last.pt" not in ckpts:
        raise AssertionError(f"checkpoints missing: {ckpts}")

    # Target tokens of steps 2..N (the steps the step-N row times), from
    # the same batch stream as the loop's.
    batcher = BucketBatcher(train, cfg.data.batch_size, cfg.data.length_buckets,
                            seed=cfg.data.shuffle_seed, image_ids=True,
                            img_dim=m.img_feat_dim, compact=True)
    K = cfg.train.steps_per_dispatch
    batches, epoch = [], 0
    while len(batches) < N_TRAIN_STEPS:
        batches += list(_step_rows(batcher.epoch_stacked(epoch, K), 0))
        epoch += 1
    batches = batches[:N_TRAIN_STEPS]
    tokens = sum(float((((b["tgt_len"] >= 0) * (b["tgt_len"] + 1))
                        * b["sample_mask"]).sum()) for b in batches[1:])
    step_s = last["step_time_s"]       # mean over steps 2..N, completion rate
    print(f"train path (kernels): wall_s={wall_s:.2f} "
          f"steps_per_sec={1.0 / step_s:.3f} "
          f"tgt_tokens_per_sec={tokens / (step_s * (N_TRAIN_STEPS - 1)):.1f} "
          f"first_loss={first['loss']:.5f} last_loss={last['loss']:.5f} "
          f"dev_bleu={final.get('dev_bleu')} launches={launches} grids={grids}")
    losses = (first["loss"], last["loss"])
    if not all(np.isfinite(losses)) or not last["loss"] < first["loss"]:
        raise AssertionError(f"loss did not fall: {losses}")
    for n in ("gru_fwd", "gru_bwd", "dec_scan_fwd", "dec_scan_bwd"):
        if launches[n] <= 0:
            raise AssertionError(f"{n} never launched on the training path")

    # Kernels against plain over the first steps, same init and draws.
    state0 = vt.create_train_state(
        cfg, torch.Generator().manual_seed(cfg.train.seed), device=dev)
    table = vt.build_img_table(train, m.img_feat_dim, device=dev)

    def run(c):
        step = vt.make_train_step(c, with_img_table=True)
        st, first_state, out = state0, None, []
        for b in batches[:N_COMPARE_STEPS]:
            st, aux = step(st, b, table)
            first_state = first_state or st
            out.append(torch.stack([aux["loss"], aux["grad_norm"]]))
        return torch.stack(out).cpu(), first_state, st

    got, st1, st_end = run(cfg)
    want, _, _ = run(cfg.replace(model=dict(gru_impl="xla",
                                            dec_scan_impl="xla")))
    rel = float(((got - want).abs() / want.abs()).max())
    print(f"train kernels vs plain over {N_COMPARE_STEPS} steps: losses "
          f"{got[:, 0].tolist()} vs {want[:, 0].tolist()}, grad norms "
          f"{got[:, 1].tolist()} vs {want[:, 1].tolist()}, max relative "
          f"diff {rel:.3g} (tolerance {TRAIN_RTOL})")
    if not rel <= TRAIN_RTOL:
        raise AssertionError(f"kernel and plain training differ by {rel}")
    # Adam's first moment after one step is (1 - b1) * the clipped grad.
    dead = [i for i, mu in enumerate(tree_leaves(st1.mu))
            if float(mu.abs().max()) == 0.0]
    if dead:
        raise AssertionError(f"parameter leaves {dead} got no gradient")
    print(f"every one of {len(tree_leaves(st1.mu))} parameter leaves has a "
          "gradient")

    step = vt.make_train_step(cfg, with_img_table=True)

    def profiled():
        st = st_end
        for b in batches[N_COMPARE_STEPS:N_COMPARE_STEPS + N_PROFILE_STEPS]:
            st, _ = step(st, b, table)
        return N_PROFILE_STEPS

    # the run dir (its checkpoints) serves phase 11, which removes it
    return launches, grids, profiled, (out_dir, cfg, vocab)


def _split_cases(torch, np, dev):
    """Exactness cases of the split top-K kernels (6 and 9) beyond the
    paths' shapes: (label, (logits, scores, finished), expected leading ids
    or None). A ragged V and a logits view one float into its storage
    (rows not 16-byte aligned), a single sentence over
    many slices, ties straddling a slice boundary and across beams, K=1,
    K=8, and all beams finished (the closed form)."""
    from vag_nmt_tpu_torch.ops.topk import split_bounds, split_plan

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def case(B, K, V, ff, seed, ties=False):
        rng = np.random.RandomState(seed)
        if ties:
            logits = np.repeat(rng.randint(-2, 3, (B, 1, V)), K, 1)
            scores = np.repeat(rng.randint(-3, 1, (B, 1)), K, 1)
        else:
            logits, scores = 3.0 * rng.randn(B, K, V), rng.randn(B, K)
        return [cuda(logits.astype(np.float32)), cuda(scores.astype(np.float32)),
                cuda(rng.rand(B, K) < ff)]

    shifted = case(128, 5, 8000, 0.2, 36)
    store = torch.empty(shifted[0].numel() + 1, device=dev)
    shifted[0] = store[1:].view(shifted[0].shape).copy_(shifted[0])
    out = [("ragged V=8003", case(128, 5, 8003, 0.2, 30), None),
           ("logits 4 bytes past a 16-byte boundary", shifted, None),
           ("B=1 V=16000", case(1, 5, 16000, 0.2, 31), None),
           ("K=1", case(128, 1, 8000, 0.2, 32), None),
           ("K=8 ties V=8003", case(16, 8, 8003, 0.3, 33, ties=True), None),
           ("B=1 all finished", case(1, 5, 8003, 1.0, 34), None)]
    B, K, V = 1, 5, 8003
    args = case(B, K, V, 0.0, 35, ties=True)
    edge = split_bounds(V, split_plan(B, K, V))[1][0]
    args[0][:, :, [edge - 1, edge]] = 5.0
    out.append((f"slice-boundary ties at {edge} (S={split_plan(B, K, V)})", args,
                [k * V + c for k in range(K) for c in (edge - 1, edge)][:K]))
    return out


def _split_exactness(torch, name, fn, plain, cases):
    """fn (kernel) against plain on every case: ids and values exactly."""
    for label, args, lead in cases:
        kv, ki = fn(*args, impl="kernel")
        pv, pi = plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
            raise AssertionError(f"{name} {label}: ids differ in "
                                 f"{int((ki != pi).sum())} places, values by "
                                 f"{float((kv - pv).abs().max())}")
        if lead is not None and ki[0].tolist() != lead:
            raise AssertionError(f"{name} {label}: took {ki[0].tolist()}, "
                                 f"expected {lead}")
        print(f"{name} {label}: ok (exact)")


def phase_beam_topk(torch, np, dev):
    """beam_topk against beam_topk_plain at the unfused beam step's shape:
    ids and values exactly, with finished rows and forced ties (integer
    logits repeated across a sentence's beams under equal scores, so
    candidates tie within rows, across rows and across beams), then the
    split cases of _split_cases."""
    from vag_nmt_tpu_torch.ops.topk import beam_topk, beam_topk_plain, candidates

    B, K, V = 128, 5, 8000
    rng = np.random.RandomState(3)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def case(kind):
        if kind == "ties":
            logits = np.repeat(rng.randint(-2, 3, (B, 1, V)), K, 1)
            scores = np.repeat(rng.randint(-3, 1, (B, 1)), K, 1)
        else:
            logits = 3.0 * rng.randn(B, K, V)
            scores = rng.randn(B, K)
        ff = {"random": 0.2, "ties": 0.3, "all_finished": 1.0}[kind]
        return (cuda(logits.astype(np.float32)), cuda(scores.astype(np.float32)),
                cuda(rng.rand(B, K) < ff))

    for kind in ("random", "ties", "all_finished"):
        args = case(kind)
        kv, ki = beam_topk(*args, impl="kernel")
        pv, pi = beam_topk_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(ki, pi):
            raise AssertionError(f"beam_topk {kind}: ids differ in "
                                 f"{int((ki != pi).sum())} places")
        if not torch.equal(kv, pv):
            raise AssertionError(f"beam_topk {kind}: values off by "
                                 f"{float((kv - pv).abs().max())}")
        print(f"beam_topk {kind}: ok (exact)")
    _split_exactness(torch, "beam_topk", beam_topk, beam_topk_plain,
                     _split_cases(torch, np, dev))

    args = case("random")
    ms = _time_ms(torch, lambda: beam_topk(*args, impl="kernel"))
    plain_ms = _time_ms(torch, lambda: beam_topk_plain(*args))
    # Yardstick only (the port never calls it; its tie order differs):
    # torch.topk over the materialized (B, K*V) candidates.
    cand = candidates(*args)
    library_ms = _time_ms(torch, lambda: torch.topk(cand, K, dim=-1))
    # logsumexp (max, subtract, exp, add) and the candidate add per logit;
    # logits, scores and flags in, values and int64 ids out
    n = B * K * V
    bound_ms, bound_by = _bound(5.0 * n, 4.0 * n + 5.0 * B * K + 12.0 * B * K)
    print(f"beam_topk (B={B}, K={K}, V={V}): kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by})")
    return {"name": "beam_topk", "route": "cuda",
            "source": "vag_nmt_tpu_torch/csrc/beam_topk.cu",
            "replaces": "vag_nmt_tpu/ops/pallas_topk.py:61",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# Shapes of the top-K grid timings: m30k serving (d) and ikea (f)-(h); the
# kernels line carries each kernel's at the V of its own path.
TOPK_GRID_SHAPES = ((128, 5, 8000), (128, 5, 16000))
TOPK_PATH_V = {"beam_topk": 8000, "legacy_topk_blocks": 16000,
               "legacy_topk_rows": 16000}


def phase_topk_grids(torch, np, dev):
    """Kernels 6, 8 and 9 timed as grids alone (their C entry points on
    base, flags and outputs made beforehand), cold and warm (_grid_ms),
    beside torch.topk on the materialized candidates, (B, K*V) and, the
    per-row yardstick of kernel 9, (B*K, V); all beams live, so every
    logit is read. Two references for what is not reading: the same grid
    with every beam finished (no logit read: launch, merges and tickets),
    and an empty device op (the floor of an event pair). Returns
    {(name, V): fields of the kernels line}."""
    from vag_nmt_tpu_torch.ops import topk

    floor_ms = _grid_ms(torch, lambda: torch.cuda._sleep(0))[0]
    out = {}
    for B, K, V in TOPK_GRID_SHAPES:
        rng = np.random.RandomState(V + 1)
        args = tuple(torch.from_numpy(a).to(dev) for a in (
            (3.0 * rng.randn(B, K, V)).astype(np.float32),
            rng.randn(B, K).astype(np.float32), np.zeros((B, K), bool)))
        done = args[:2] + (torch.ones((B, K), dtype=torch.bool, device=dev),)
        cand = topk.candidates(*args)
        rows = cand.reshape(B * K, V)
        lib = {}
        for what, x in (("", cand), ("rows_", rows)):
            tv = torch.empty((x.shape[0], K), dtype=torch.float32, device=dev)
            ti = torch.empty((x.shape[0], K), dtype=torch.int64, device=dev)
            lib[what] = _grid_ms(torch, lambda: torch.topk(x, K, dim=-1,
                                                           out=(tv, ti)))
        n = B * K * V
        bound_ms, _ = _bound(2.0 * n, 4.0 * n + 5.0 * B * K + 12.0 * B * K)
        for name in ("beam_topk", "legacy_topk_blocks", "legacy_topk_rows"):
            fn, cargs, _, keep = topk.grid_call(name, *args)
            cold, warm = _grid_ms(torch, lambda: fn(*cargs))
            fn, cargs, _, keep = topk.grid_call(name, *done)
            f = {"grid_ms": cold, "grid_warm_ms": warm,
                 "grid_finished_ms": _grid_ms(torch, lambda: fn(*cargs))[0],
                 "grid_floor_ms": floor_ms,
                 "library_grid_ms": lib[""][0],
                 "library_grid_warm_ms": lib[""][1]}
            if name == "legacy_topk_rows":
                f["library_rows_grid_ms"] = lib["rows_"][0]
                f["library_rows_grid_warm_ms"] = lib["rows_"][1]
            out[(name, V)] = f
            print(f"{name} grid (B={B}, K={K}, V={V}): " + json.dumps(
                {**f, "bound_ms": bound_ms,
                 "grid_bound_share": bound_ms / cold}))
            del keep
    return out


def _dec_step_case(torch, np, dev, B, K, T, H, A, C, R, seed):
    """dec_step inputs: random weights at 1/sqrt(fan-in) scale and biases,
    gathered table rows, states, ctx and ctx_proj + ba, source lengths
    from 1 to T (masked positions)."""
    rng = np.random.RandomState(seed)
    N = B * K

    def cuda(*shape, scale=0.5):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32)).to(dev)

    weights = (cuda(H, 3 * H, scale=H ** -0.5), cuda(3 * H, scale=0.1),
               cuda(H, A + 3 * H, scale=H ** -0.5), cuda(3 * H, scale=0.1),
               cuda(A, scale=A ** -0.5), cuda(C, 3 * H + R, scale=C ** -0.5),
               cuda(3 * H, scale=0.1), cuda(H, R, scale=H ** -0.5),
               cuda(R, scale=0.1))
    lens = rng.randint(1, T + 1, B)
    lens[0] = T
    mask = torch.from_numpy((np.arange(T)[None] < lens[:, None]).astype(
        np.float32)).to(dev)
    return (cuda(N, 3 * H + R), cuda(N, H), cuda(B, T, C), cuda(B, T, A),
            mask), weights


def phase_dec_step(torch, np, dev):
    """dec_step against dec_step_plain at full width and at a ragged shape
    (widths and batch that fill no tile)."""
    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.ops.dec_step import dec_step, dec_step_plain

    m = vt.preset("m30k_ende_vag").model
    full = (128, 5, 32, m.dec_hidden_dim, m.attn_dim, m.ctx_dim, m.emb_dim)
    max_abs = 0.0
    for shape in (full, (12, 3, 13, 96, 96, 192, 64)):
        inputs, weights = _dec_step_case(torch, np, dev, *shape, seed=11)
        got = dec_step(*inputs, weights, impl="kernel")
        want = dec_step_plain(*inputs, weights)
        torch.cuda.synchronize()
        errs = {n: _rel_err(a, b) for n, a, b in zip(("s_new", "t"), got, want)}
        if not max(errs.values()) <= DEC_STEP_RTOL:
            raise AssertionError(f"dec_step {shape}: relative errors {errs}")
        max_abs = max([max_abs] + [float((a - b).abs().max())
                                   for a, b in zip(got, want)])
        print(f"dec_step (B, K, T, H, A, C, R)={shape}: ok, relative errors "
              f"{json.dumps(errs)}")

    inputs, weights = _dec_step_case(torch, np, dev, *full, seed=12)
    ms = _time_ms(torch, lambda: dec_step(*inputs, weights, impl="kernel"))
    plain_ms = _time_ms(torch, lambda: dec_step_plain(*inputs, weights))
    B, K, T, H, A, C, R = full
    N = B * K
    # the four GEMMs, then the energies (add, tanh, multiply-add by va) and
    # the context's multiply-adds per position of the sentence's source
    flops = (2.0 * N * (H * 3 * H + H * (A + 3 * H) + C * (3 * H + R) + H * R)
             + N * T * (4.0 * A + 2.0 * C))
    nbytes = 4.0 * (sum(w.numel() for w in weights) + N * (3 * H + R)
                    + N * H + B * T * (C + A + 1) + N * (H + R))
    bound_ms, bound_by = _bound(flops, nbytes)
    print(f"dec_step (B={B}, K={K}, T={T}): kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    return {"name": "dec_step", "route": "cuda",
            "source": "vag_nmt_tpu_torch/csrc/dec_step.cu",
            "replaces": "vag_nmt_tpu/ops/pallas_dec_step.py:106",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _legacy_case(torch, np, dev, kind, B, K, V, seed):
    """Inputs of the legacy top-K kernels: random logits with a fifth of the
    rows finished, all rows finished, or forced ties (integer logits repeated
    across a sentence's beams under equal scores, the maximum at v=100 and
    v=600: ties across beams and across the first two 512-blocks)."""
    rng = np.random.RandomState(seed)
    if kind == "ties":
        logits = np.repeat(rng.randint(-2, 3, (B, 1, V)), K, 1).astype(np.float32)
        logits[:, :, [100, 600]] = 5.0
        scores = np.repeat(rng.randint(-3, 1, (B, 1)), K, 1)
    else:
        logits = 3.0 * rng.randn(B, K, V)
        scores = rng.randn(B, K)
    fin = rng.rand(B, K) < {"random": 0.2, "ties": 0.0, "all_finished": 1.0}[kind]

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (cuda(logits.astype(np.float32)), cuda(scores.astype(np.float32)),
            cuda(fin))


def phase_legacy_topk(torch, np, dev):
    """Kernels 8 and 9 (legacy_topk_blocks, legacy_topk_rows) against their
    plain versions, ids and values exactly, at (B, K, V) = (128, 5, 16000)
    and (128, 5, 8000) (neither V a multiple of the 512-block): random,
    all-finished and forced cross-block ties, where gen 1 and gen 2 must
    each follow their own rule and differ; then gen 2 on the split cases
    of _split_cases."""
    from vag_nmt_tpu_torch.ops import topk

    kernels = (("legacy_topk_blocks", topk.legacy_topk_blocks,
                topk.legacy_topk_blocks_plain, 25, 207),
               ("legacy_topk_rows", topk.legacy_topk_rows,
                topk.legacy_topk_rows_plain, 95, 175))
    for B, K, V in ((128, 5, 16000), (128, 5, 8000)):
        for kind in ("random", "all_finished", "ties"):
            args = _legacy_case(torch, np, dev, kind, B, K, V, seed=V)
            got = {}
            for name, fn, plain, _, _ in kernels:
                kv, ki = fn(*args, impl="kernel")
                pv, pi = plain(*args)
                torch.cuda.synchronize()
                if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
                    raise AssertionError(
                        f"{name} {kind} V={V}: ids differ in "
                        f"{int((ki != pi).sum())} places, values by "
                        f"{float((kv - pv).abs().max())}")
                got[name] = ki
            if kind == "ties":
                g1, g2 = got["legacy_topk_blocks"], got["legacy_topk_rows"]
                want1 = torch.tensor([100, V + 100], device=dev)
                want2 = torch.tensor([100, 600], device=dev)
                if not ((g1[:, :2] == want1).all() and (g2[:, :2] == want2).all()):
                    raise AssertionError(f"forced ties V={V}: gen 1 took "
                                         f"{g1[0].tolist()}, gen 2 {g2[0].tolist()}")
            print(f"legacy top-K {kind} (B={B}, K={K}, V={V}): ok (exact)")
    _split_exactness(torch, "legacy_topk_rows", topk.legacy_topk_rows,
                     topk.legacy_topk_rows_plain, _split_cases(torch, np, dev))

    B, K, V = 128, 5, 16000
    args = _legacy_case(torch, np, dev, "random", B, K, V, seed=1)
    cand = topk.candidates(*args)
    # Yardstick only (the port never calls it; its tie order differs):
    # torch.topk over the materialized (B, K*V) candidates.
    library_ms = _time_ms(torch, lambda: torch.topk(cand, K, dim=-1))
    n = B * K * V
    bound_ms, bound_by = _bound(5.0 * n, 4.0 * n + 5.0 * B * K + 12.0 * B * K)
    out = []
    for name, fn, plain, line, _ in kernels:
        ms = _time_ms(torch, lambda: fn(*args, impl="kernel"))
        plain_ms = _time_ms(torch, lambda: plain(*args), reps=10)
        print(f"{name} (B={B}, K={K}, V={V}): kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by})")
        out.append({"name": name, "route": "cuda",
                    "source": "vag_nmt_tpu_torch/csrc/legacy_topk.cu",
                    "replaces": f"vag_nmt_tpu/ops/topk_legacy.py:{line}",
                    "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms})
    return out


# Kernel 1's watermark mode: the slot depths checked, and the lane-collision
# ids (lane 0 of the kernel's map at R=640, V=16000: split 0, columns 0-3 of
# each 64-column tile).
READOUT_SLOTS = (1, 3)
LANE_COLLISION = (0, 1, 2, 3, 64)


def _slots_case(torch, np, dev, kind, R, E, V, seed):
    """Readout inputs whose logits are exact in fp32 whatever the order of
    the sums (multiples of 1/512 below 2^14 / 512), so the kernel and the
    plain version see the same values: ties, watermarks and flags alike;
    "collision" puts every row's five best logits in one kernel lane."""
    rng = np.random.RandomState(seed)
    t = rng.randint(-8, 9, (R, E)) / 8.0
    w = rng.randint(-8, 9, (E, V)) / 64.0
    b = rng.randint(-64, 65, V) / 64.0
    if kind == "collision":
        for rank, vid in enumerate(LANE_COLLISION):
            b[vid] = 100.0 - rank
    mask = None
    if kind == "ban":
        mask = torch.from_numpy((rng.rand(R, V) < 0.001).astype(np.uint8)).to(dev)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return cuda(t), cuda(w), cuda(b), mask


def phase_readout_slots(torch, np, dev):
    """Kernel 1's shallow-slot watermark mode at R=640, E=256, V=16000 for
    each slot depth of READOUT_SLOTS, against its plain version under the
    kernel's own lane map and against the depth-K kernel: every row's viol
    as the plain version's; vals, ids, lse as the plain version's (exact
    logits) and, on every row that is not flagged, bit for bit as depth K's;
    the per-step recovery equal to depth K on every row and its counter;
    the deferred live flag, which all-frozen rows never arm."""
    from vag_nmt_tpu_torch.ops import readout_topk as rt

    R, E, V, K = 640, 256, 16000, 5
    lanes = rt.kernel_lanes(R, V)
    if len(set(lanes[list(LANE_COLLISION)].tolist())) != 1:
        raise AssertionError("LANE_COLLISION ids do not share a kernel lane")
    live = torch.ones(R, dtype=torch.bool, device=dev)
    flagged, max_err = {}, 0.0
    for kind in ("exact", "collision", "ban"):
        t, w, b, mask = _slots_case(torch, np, dev, kind, R, E, V, seed=13)
        deep = rt.readout_topk_rows(t, w, b, K, mask, impl="kernel")
        for sk in READOUT_SLOTS:
            kv, ki, kl, viol = rt.readout_topk_rows(t, w, b, K, mask, slots=sk,
                                                    impl="kernel")
            pv, pi, pl, pviol = rt.readout_topk_rows_plain(t, w, b, K, mask,
                                                           slots=sk)
            rt.readout_topk_rows.recoveries = None
            rec = rt.readout_topk_rows(t, w, b, K, mask, slots=sk,
                                       recover_live=live, impl="kernel")
            torch.cuda.synchronize()
            what = f"readout_topk slots={sk} {kind}"
            if not torch.equal(viol, pviol):
                raise AssertionError(f"{what}: viol differs from the plain "
                                     f"version on {int((viol != pviol).sum())} rows")
            if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
                raise AssertionError(f"{what}: vals/ids differ from the plain "
                                     "version")
            max_err = max(max_err, float((kl - pl).abs().max()))
            if not torch.allclose(kl, pl, rtol=READOUT_RTOL, atol=0.0):
                raise AssertionError(f"{what}: lse off by {max_err}")
            ok = viol == 0
            if not (torch.equal(kv[ok], deep[0][ok]) and torch.equal(ki[ok], deep[1][ok])
                    and torch.equal(kl, deep[2])):
                raise AssertionError(f"{what}: an unflagged row differs from depth K")
            if not all(torch.equal(a, c) for a, c in zip(rec[:3], deep)):
                raise AssertionError(f"{what}: the recovered rows differ from depth K")
            n_flag = int(viol.sum())
            counts = rt.readout_topk_rows.recoveries.tolist()
            if counts != [n_flag, int(n_flag > 0)]:
                raise AssertionError(f"{what}: recoveries {counts}, {n_flag} flagged")
            if kind == "collision" and n_flag != R:
                raise AssertionError(f"{what}: only {n_flag} of {R} rows flagged")
            flagged[(kind, sk)] = n_flag
        print(f"readout_topk slots {kind}: ok, flagged rows "
              f"{ {sk: flagged[(kind, sk)] for sk in READOUT_SLOTS} }")

    # the deferred live flag through fused_readout_topk
    t, w, b, _ = _slots_case(torch, np, dev, "collision", R, E, V, seed=14)
    scores = torch.zeros((R // K, K), device=dev)
    for frac in (0.0, 1.0):
        fin = torch.full((R // K, K), frac > 0, device=dev)
        *_, flag = rt.fused_readout_topk(t, w, b, scores, fin, impl="kernel",
                                         slots=1, defer_exact=True)
        if bool(flag) != (frac == 0.0):
            raise AssertionError(f"deferred flag {bool(flag)} with finished={frac}")
    print("readout_topk deferred live flag: ok (all-frozen rows do not arm it)")

    t, w, b, _ = _slots_case(torch, np, dev, "exact", R, E, V, seed=15)
    times = {sk: _time_ms(torch, lambda: rt.readout_topk_rows(
        t, w, b, K, slots=sk, impl="kernel")) for sk in READOUT_SLOTS}
    deep_ms = _time_ms(torch, lambda: rt.readout_topk_rows(t, w, b, K,
                                                           impl="kernel"))
    rec_ms = _time_ms(torch, lambda: rt.readout_topk_rows(
        t, w, b, K, slots=READOUT_SLOTS[0], recover_live=live, impl="kernel"))
    plain_ms = _time_ms(torch, lambda: rt.readout_topk_rows_plain(
        t, w, b, K, slots=READOUT_SLOTS[0]), reps=5)
    bound_ms, bound_by = _bound(2.0 * R * E * V,
                                4.0 * (R * E + E * V + V) + 8.0 * R * K + 8.0 * R)
    print(f"readout_topk slots (R={R}, E={E}, V={V}): kernel_ms by slots "
          f"{json.dumps(times)} depth K {deep_ms:.4f}, slots "
          f"{READOUT_SLOTS[0]} with per-step recovery {rec_ms:.4f}, "
          f"plain_ms (slots {READOUT_SLOTS[0]}) {plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by})")
    return {"name": "readout_topk_slots", "route": "cuda",
            "source": "vag_nmt_tpu_torch/csrc/readout_topk.cu",
            "replaces": "vag_nmt_tpu/ops/pallas_readout_topk.py:113",
            "max_abs_err": max_err, "ms": times[READOUT_SLOTS[0]],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


# (mode, Translator.translate arguments, environment): the serving modes
SERVE_MODES = (
    ("a", {}, {}),
    ("b", {}, {"VAG_DEC_STEP": "on"}),
    ("c", {"streaming": False}, {}),
    ("d", {}, {"VAG_READOUT_TOPK": "unfused"}),
    ("e", {"bulk": True}, {}),
    ("f", {"beam_size": 1}, {}),
)


def _with_env(env, fn):
    import os

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def phase_serve(torch, np, dev, run):
    """The serving path through Translator, raw text in: the modes of
    SERVE_MODES, each kernel's launches from each mode alone; returns the
    launches and grids of beam_topk from (d) and dec_step from (b)."""
    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.core.config import SPECIALS
    from vag_nmt_tpu_torch.data.vocab import Vocab
    from vag_nmt_tpu_torch.ops.dec_step import dec_step
    from vag_nmt_tpu_torch.ops.gru_kernel import gru_fwd
    from vag_nmt_tpu_torch.ops.readout_topk import readout_topk_rows
    from vag_nmt_tpu_torch.ops.topk import beam_topk

    out_dir, cfg, tgt_vocab = run
    m, d = cfg.model, cfg.data
    (out_dir / "config.json").write_text(
        cfg.replace(data=dict(data_dir=str(out_dir))).to_json())
    Vocab(list(SPECIALS) + [f"s{i}" for i in range(4, m.src_vocab_size)]).save(
        str(out_dir / f"vocab.{d.src_lang}.json"))
    tgt_vocab.save(str(out_dir / f"vocab.{d.tgt_lang}.json"))
    corpus = _train_corpus(np, m, N_SERVE, seed=10)
    lines = [" ".join(f"s{t}" for t in ex.src) for ex in corpus]
    images = np.stack([ex.img for ex in corpus]).astype(np.float32)

    tr = vt.Translator.from_run(str(out_dir), device=dev)
    t0 = time.perf_counter()
    n_warm = tr.warmup()
    torch.cuda.synchronize()
    print(f"serve warmup: {n_warm} requests in {time.perf_counter() - t0:.2f} s")

    wrappers = {"gru_fwd": gru_fwd, "readout_topk": readout_topk_rows,
                "beam_topk": beam_topk, "dec_step": dec_step}

    def request(kw, n):
        hyps = tr.translate(lines[:n], images=images[:n], **kw)
        steps = sum(s.get("beam_loop_steps", 0) for s in tr.last_stats)
        return hyps, steps

    out = {}
    for mode, kw, env in SERVE_MODES:
        n = N_GREEDY if mode == "f" else N_SERVE
        for fn in wrappers.values():
            fn.launches = 0
            fn.grids = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hyps, steps = _with_env(env, lambda: request(kw, n))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        grids = {k: fn.grids for k, fn in wrappers.items()}
        trips = [s["chunk_steps"] for s in tr.last_stats]
        refills = [s.get("refills") for s in tr.last_stats]
        # decode_s: translate_corpus's own clock (upload to hypotheses on
        # the host), as phase 4's sentences_per_sec; the wall adds the text
        # pipeline, the image table and the detokenization
        decode_s = sum(s["elapsed_s"] for s in tr.last_stats)
        print(f"serve ({mode}) {kw} {env}: sentences_per_sec={n / wall:.1f} "
              f"wall_s={wall:.4f} decode_s={decode_s:.4f} "
              f"calls={len(tr.last_stats)} "
              f"streaming={[bool(s.get('streaming')) for s in tr.last_stats]} "
              f"steps={steps} trips={trips} refills={refills} "
              f"launches={launches} grids={grids}")
        if len(hyps) != n or not any(hyps):
            raise AssertionError(f"serve ({mode}): malformed or empty hypotheses")
        if launches["gru_fwd"] <= 0:
            raise AssertionError(f"serve ({mode}): the encoder kernel never ran")
        beam = mode != "f"
        want = {"readout_topk": steps if beam and mode != "d" else 0,
                "beam_topk": steps if mode == "d" else 0,
                "dec_step": steps if mode == "b" else 0}
        for k, v in want.items():
            if launches[k] != v:
                raise AssertionError(f"serve ({mode}): {k} launched "
                                     f"{launches[k]} times, expected {v}")
        if beam and not steps:
            raise AssertionError(f"serve ({mode}): no beam steps")
        out[mode] = (hyps, launches, grids, steps, wall)

    for a, b in (("a", "c"), ("b", "a"), ("d", "a"), ("e", "a")):
        share = sum(x == y for x, y in zip(out[a][0], out[b][0])) / N_SERVE
        print(f"serve identical hypotheses ({a}) vs ({b}): {share:.4f} "
              f"(threshold {MIN_IDENTICAL_SHARE})")
        if share < MIN_IDENTICAL_SHARE:
            raise AssertionError(f"serve ({a}) vs ({b}): only {share:.4f} "
                                 "of hypotheses identical")

    envs = {mode: env for mode, _, env in SERVE_MODES}
    # (b) and (a) once more, so the two ran in turns a, b, b, a
    rates = {mode: [N_SERVE / out[mode][4]] for mode in ("a", "b")}
    for mode in ("b", "a"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _with_env(envs[mode], lambda: request({}, N_SERVE))
        torch.cuda.synchronize()
        rates[mode].append(N_SERVE / (time.perf_counter() - t0))
    print(f"serve sentences_per_sec in turns a, b, b, a: {json.dumps(rates)}; "
          f"(b)/(a) of the means "
          f"{sum(rates['b']) / sum(rates['a']):.4f}")
    for mode in ("a", "b"):
        env = envs[mode]
        phase_profile(torch, f"serve ({mode}) (beam steps)",
                      lambda: _with_env(env, lambda: request({}, N_SERVE))[1])
    return ({"beam_topk": out["d"][1]["beam_topk"],
             "dec_step": out["b"][1]["dec_step"]},
            {"beam_topk": out["d"][2]["beam_topk"],
             "dec_step": out["b"][2]["dec_step"]})


# The long-caption decode: ikea_vag at full width over IKEA_N_SENT synthetic
# sentences with source lengths uniform in IKEA_SRC_LENS (the 128 bucket;
# IKEA captions are 40-90 words), in the modes of IKEA_MODES: (mode,
# environment, the route it exercises).
IKEA_N_SENT = 512
IKEA_SRC_LENS = (40, 120)
# The seed's random model has a near-flat posterior over its 16000 words:
# a step's best candidates lie within a few fp32 roundings of each other
# once the beam scores have grown over 128 steps, so the last-bit
# difference between cuBLAS logits and the readout kernel's decides
# near-ties: with IKEA_READOUT_SCALE = 1, 16% of the hypotheses differed
# between (h) and (a) (share 0.8418, NVIDIA H100 80GB HBM3, 700 W). The
# output matrix is scaled up, as a trained model's posterior is peaked:
# the share is then 1.0000 on the same card.
IKEA_READOUT_SCALE = 100.0
IKEA_MODES = (
    ("a", {}, "two-phase at depth K"),
    ("b", {"VAG_FRT_SLOTS": "1"}, "two-phase, per-step recovery"),
    ("c", {"VAG_TWO_PHASE": "off", "VAG_FRT_SLOTS": "1"},
     "chunked, deferred chunk rerun"),
    ("d", {"VAG_TWO_PHASE": "off", "VAG_FRT_SLOTS": "3", "VAG_FRT_DEFER": "0"},
     "chunked, per-step"),
    ("e", {"VAG_TWO_PHASE": "off", "VAG_BEAM_UNROLL": "4"}, "chunked, unrolled"),
    ("f", {"VAG_READOUT_TOPK": "unfused", "VAG_TOPK_IMPL": "pallas"},
     "unfused step, kernel 8"),
    ("g", {"VAG_READOUT_TOPK": "unfused", "VAG_TOPK_IMPL": "pallas_rows"},
     "unfused step, kernel 9"),
    ("h", {"VAG_READOUT_TOPK": "unfused", "VAG_TOPK_IMPL": "pallas_lanes"},
     "unfused step, kernel 6"),
)


def phase_ikea(torch, np, dev):
    """The ikea_vag long-caption decode at full width through
    translate_corpus in each mode of IKEA_MODES, each kernel's launches read
    from each mode alone: the routes exact by construction agree with (a)
    on every hypothesis, as (f) and (g) do with (h), and (h) with (a) on at
    least MIN_IDENTICAL_SHARE; (b) must recover rows and (c) rerun chunks.
    Returns the launches and grids of legacy_topk_blocks from (f),
    legacy_topk_rows from (g) and the readout's shallow slots from (b)."""
    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.core.config import SPECIALS
    from vag_nmt_tpu_torch.data.batching import Example
    from vag_nmt_tpu_torch.data.vocab import Vocab
    from vag_nmt_tpu_torch.ops import topk
    from vag_nmt_tpu_torch.ops.gru_kernel import gru_fwd
    from vag_nmt_tpu_torch.ops.readout_topk import readout_topk_rows

    cfg = vt.preset("ikea_vag")
    m = cfg.model
    params = vt.init_params(m, torch.Generator().manual_seed(0), device=dev)
    params["decoder"]["readout"]["w_out"].mul_(IKEA_READOUT_SCALE)
    rng = np.random.RandomState(20)
    lo, hi = IKEA_SRC_LENS
    examples = [Example(src=list(rng.randint(4, m.src_vocab_size, L)),
                        img=rng.randn(m.img_feat_dim).astype(np.float32),
                        index=i)
                for i, L in enumerate(rng.randint(lo, hi + 1, IKEA_N_SENT))]
    vocab = Vocab(list(SPECIALS) + [f"t{i}" for i in range(m.tgt_vocab_size - 4)])
    img_table = vt.build_img_table(examples, m.img_feat_dim, device=dev)

    def run():
        return vt.translate_corpus(params, cfg, examples, vocab,
                                   img_table=img_table)

    run()                                 # warm-up (allocator, cuBLAS)
    wrappers = {"gru_fwd": gru_fwd, "readout_topk": readout_topk_rows,
                "beam_topk": topk.beam_topk,
                "legacy_topk_blocks": topk.legacy_topk_blocks,
                "legacy_topk_rows": topk.legacy_topk_rows}
    out = {}
    for mode, env, route in IKEA_MODES:
        for fn in wrappers.values():
            fn.launches = 0
            fn.grids = 0
        readout_topk_rows.recoveries = None
        torch.cuda.synchronize()
        hyps, st = _with_env(env, run)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in wrappers.items()}
        grids = {k: fn.grids for k, fn in wrappers.items()}
        rec = readout_topk_rows.recoveries
        rec = [0, 0] if rec is None else rec.tolist()
        steps = st["beam_loop_steps"]
        print(f"ikea ({mode}) {route} {env}: "
              f"sentences_per_sec={st['sentences_per_sec']:.1f} "
              f"elapsed_s={st['elapsed_s']:.4f} t_src={st['t_src']} "
              f"beam_loop_steps={steps} chunk_steps={st['chunk_steps']} "
              f"phase2_steps={st.get('phase2_steps')} reruns={st['reruns']} "
              f"recoveries(rows, steps)={rec} launches={launches} "
              f"grids={grids} launches_per_beam_step="
              f"{json.dumps({k: v / steps for k, v in launches.items() if v})}")
        if len(hyps) != IKEA_N_SENT or not any(hyps) or not steps:
            raise AssertionError(f"ikea ({mode}): malformed or empty output")
        if st.get("two_phase", False) != (env.get("VAG_TWO_PHASE") != "off"):
            raise AssertionError(f"ikea ({mode}): two_phase {st.get('two_phase')}")
        fused = env.get("VAG_READOUT_TOPK") != "unfused"
        impl = env.get("VAG_TOPK_IMPL")
        want = {"readout_topk": steps if fused else 0,
                "beam_topk": steps if impl == "pallas_lanes" else 0,
                "legacy_topk_blocks": steps if impl == "pallas" else 0,
                "legacy_topk_rows": steps if impl == "pallas_rows" else 0}
        if launches["gru_fwd"] <= 0 or any(launches[k] != v
                                           for k, v in want.items()):
            raise AssertionError(f"ikea ({mode}): launches {launches}, "
                                 f"expected {want}")
        if mode == "b" and rec[0] <= 0:
            raise AssertionError("ikea (b): no per-step recovery ran")
        if mode == "c" and st["reruns"] <= 0:
            raise AssertionError("ikea (c): no chunk was rerun")
        out[mode] = (hyps, launches, grids)

    envs = {k: e for k, e, _ in IKEA_MODES}
    for a, b, least in (("a", "b", 1.0), ("a", "c", 1.0), ("a", "d", 1.0),
                        ("a", "e", 1.0), ("g", "h", 1.0), ("f", "h", 1.0),
                        ("h", "a", MIN_IDENTICAL_SHARE)):
        share = sum(x == y for x, y in zip(out[a][0], out[b][0])) / IKEA_N_SENT
        print(f"ikea identical hypotheses ({a}) vs ({b}): {share:.4f} "
              f"(threshold {least})")
        if share < least and (a, b) == ("f", "h"):
            _gen1_tie_audit(torch, topk, envs["f"], run, out["f"][0])
        elif share < least:
            raise AssertionError(f"ikea ({a}) vs ({b}): only {share:.4f} of "
                                 "hypotheses identical")
    for mode in ("a", "b", "g", "h"):
        phase_profile(torch, f"ikea ({mode}) (beam steps)",
                      lambda: _with_env(envs[mode], run)[1]["beam_loop_steps"])
    pick = {"legacy_topk_blocks": ("f", "legacy_topk_blocks"),
            "legacy_topk_rows": ("g", "legacy_topk_rows"),
            "readout_topk_slots": ("b", "readout_topk")}
    return ({k: out[mode][1][w] for k, (mode, w) in pick.items()},
            {k: out[mode][2][w] for k, (mode, w) in pick.items()})


def _gen1_tie_audit(torch, topk, env, run, hyps_f):
    """Mode (f) once more with every step's gen 1 result held against the
    flat-index order of kernel 6 (beam_topk_plain) on the same inputs: the
    values must be equal at every step, so the ids can differ only where
    candidates tie exactly and gen 1's rule (512-block, beam, id) picks
    another of them. Prints the count and the first such tie; raises on any
    other difference or if the audited run's hypotheses are not (f)'s."""
    orig = topk.legacy_topk_blocks
    seen = {"steps": 0, "rows": 0, "first": None}

    def audited(logits, scores, finished, *, pad_id, impl):
        vals, idx = orig(logits, scores, finished, pad_id=pad_id, impl=impl)
        ref_v, ref_i = topk.beam_topk_plain(logits, scores, finished,
                                            pad_id=pad_id)
        if not torch.equal(vals, ref_v):
            raise AssertionError("gen 1's values differ from the flat order's")
        diff = (idx != ref_i).any(1)
        n = int(diff.sum())
        if n:
            seen["steps"] += 1
            seen["rows"] += n
            if seen["first"] is None:
                b = int(diff.nonzero()[0, 0])
                seen["first"] = {"sentence": b, "values": vals[b].tolist(),
                                 "gen1_ids": idx[b].tolist(),
                                 "flat_order_ids": ref_i[b].tolist()}
        return vals, idx

    audited.launches = audited.grids = 0      # the kernel's wrapper counts here
    topk.legacy_topk_blocks = audited
    try:
        hyps, _ = _with_env(env, run)
    finally:
        topk.legacy_topk_blocks = orig
    if hyps != hyps_f:
        raise AssertionError("ikea (f): the audited run decoded otherwise")
    print(f"ikea (f) tie audit: gen 1 broke exact ties otherwise than the "
          f"flat order in {seen['rows']} sentence-steps over {seen['steps']} "
          f"beam steps, with equal values at every step; first tie: "
          f"{json.dumps(seen['first'])}")
    if not seen["rows"]:
        raise AssertionError("ikea (f) differs from (h) with no tie flipped")


def phase_profile(torch, what: str, run):
    """One run of a path under torch.profiler, device activity only; run()
    returns its step count (beam steps or train steps). One stream, so
    kernels do not overlap and their summed time is the device's busy time;
    the idle share is 1 - busy / host wall. The profiler's own host cost
    makes the wall, and so the idle share, an upper estimate."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    n_launch = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us()
        n_launch += 1
    busy_ms = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    print(f"profile {what}: " + json.dumps({
        "steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        # None: the profiler saw no device activity (not measured)
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        "device_launches": n_launch,
        "device_launches_per_step": n_launch / max(1, steps),
        "gru_fwd_ms": sum(us for name, us in kernels.items()
                          if "gru_fwd" in name) / 1e3,
        "top_kernels_ms": [[name[:80], us / 1e3] for name, us in top]}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import numpy as np

    from vag_nmt_tpu_torch.core.device import resolve_device
    from vag_nmt_tpu_torch.ops import _build

    dev = resolve_device(None)
    print(_smi())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if sys.argv[1:] == ["--gru-grids"]:
        # gru_fwd's grids alone at GRU_SHAPES and nothing else, for timing
        # another tree's kernel in the same call (a copy of this script in
        # that tree's root): {label: [cold, warm]}.
        print(json.dumps({"gru_grids": gru_grid_times(torch, np, dev)}))
        return 0
    print(f"build_s: {_build.build_all():.2f}")
    t0 = time.perf_counter()
    decode_kernels = [phase_readout(torch, np, dev), phase_gru(torch, np, dev)]
    train_kernels = [phase_gru_bwd(torch, np, dev), *phase_dec_scan(torch, np, dev)]
    grid_times = phase_topk_grids(torch, np, dev)
    serve_kernels = [phase_beam_topk(torch, np, dev),
                     phase_dec_step(torch, np, dev)]
    ikea_kernels = [*phase_legacy_topk(torch, np, dev),
                    phase_readout_slots(torch, np, dev)]
    launches, grids, run = phase_main(torch, np, dev)
    phase_profile(torch, "decode (beam steps)", run)
    t_launches, t_grids, t_run, train_run = phase_train(torch, np, dev)
    phase_profile(torch, "train (steps)", t_run)
    try:
        s_launches, s_grids = phase_serve(torch, np, dev, train_run)
    finally:
        shutil.rmtree(train_run[0], ignore_errors=True)
    i_launches, i_grids = phase_ikea(torch, np, dev)
    # Each kernel's launches come from the run of its own path: the decode
    # path for the decode kernels, the training path for the training
    # kernels, the serving modes that select them for beam_topk and dec_step,
    # the ikea_vag modes that select them for the legacy top-K kernels and
    # the readout's shallow slots.
    for ks, ln, gr in ((decode_kernels, launches, grids),
                       (train_kernels, t_launches, t_grids),
                       (serve_kernels, s_launches, s_grids),
                       (ikea_kernels, i_launches, i_grids)):
        for k in ks:
            k["launches"] = ln[k["name"]]
            k["grids"] = gr[k["name"]]    # device grids those launches enqueued
    kernels = decode_kernels + train_kernels + serve_kernels + ikea_kernels
    for k in kernels:
        k.update(grid_times.get((k["name"], TOPK_PATH_V.get(k["name"])), {}))
    print(f"phases_s: {time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
