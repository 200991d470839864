#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. card and build: the card's name and power limit, and the build of every
     hand-written kernel under vag_nmt_tpu_torch/csrc/ (one nvcc each, all
     started together);
  2. readout_topk kernel against its plain PyTorch version at the beam-5
     decode shape of m30k_ende_vag (R=640 rows, E=256, V=8000, K=5) and at
     the ragged shapes of READOUT_CASES (V=8003, E=250, 35 rows), a second
     call bit for bit as the first;
  2b. the K-capped kernels (1, 1', 6, 8, 9 and 7) at beams 12, 16, 20 and
     32 (kernels 1 and 7 through their VAG_MAX_K = 16 instances; above 16
     the top-K kernels in passes of 16, kernel 7's attention in groups of
     16 beams), beside beam 5 (the K <= 8 instances), against their plain
     versions (kernel 1's ids exact but among candidates within
     READOUT_RTOL of each other in float64, and exact on integer inputs),
     each grid timed alone, cold and warm, the passes counted, torch.topk
     on the candidates beside 6, 8, 9 above 16; then K above V: each top-K
     wrapper's kernel route raises ValueError, with no launch;
  3. gru_fwd kernel (one persistent grid per scan) against its plain
     version at the encoders' shapes (B, T) = (1024, 32) m30k decode,
     (64, 24) training and (512, 120) ikea_vag (E=256, H=512), ragged
     lengths, both directions, and at the ragged batches of GRU_RAGGED
     (a last row block part full, two passes over the row blocks a step,
     under the card's plan and other tilings); at each path shape its
     grid alone, cold (L2 flushed) and warm, beside cuDNN's nn.GRU forward
     and the cuBLAS input projection alone (cuDNN minus it is the
     recurrence's yardstick), and the operations bound;
  3b. gru_fwd at widths the H = 512 plan does not cover: H = 94 (padded
     to 96), 1280 and 2048 (Uh's slices in L2), within GRU_ATOL, its grid
     and bound at 2048;
  4. the main path: translate_corpus at beam 5 on the full-width
     m30k_ende_vag model (random weights from a fixed seed) over a synthetic
     corpus, through the kernels (impl="auto"), with each kernel's launch
     count read from that run alone, then the same corpus with impl="plain"
     on the card and the share of identical hypotheses;
  5. where the time goes: the kernel path once more under torch.profiler
     (device activity only), giving the device's busy time, its idle share
     of the host wall, device launches per beam step and the top kernels;
  6. gru_bwd kernel (three grids a call, the carry one persistent grid)
     against its plain version at the encoder's training shape (B=64,
     T=24, E=256, H=512), its longest source bucket (T=128), a ragged
     batch at a narrow width (B=37, H=94) and H=1024, ragged lengths, both
     directions, a second call bit for bit as the first; at the first two
     its whole call timed alone, cold (L2 flushed) and warm, with each
     grid's device ms, beside cuDNN's backward;
  7. dec_scan_fwd and dec_scan_bwd kernels (one persistent grid each)
     against their plain versions at (B, T, Tt) = (64, 24, 24) full width,
     ikea_vag's (64, 128, 128), a ragged batch (B=37) at widths that are no
     multiples of 4 with every operand 4 bytes off a 16-byte boundary, and
     Tt = 1, ragged source masks: the readout, every residual and all 15
     gradients, a second call bit for bit as the first; at the first two
     both calls timed alone, cold (L2 flushed) and warm, with each phase's
     device ms from the kernels' barrier stamps; the energies' tanh_fast
     against tanhf;
  8. the training path: train_loop on the full-width m30k_ende_vag model
     (preset dropout 0.3, batch 64) from a seed's random init over a
     synthetic corpus of 2048 pairs, 40 steps and one dev eval, with each
     kernel's launch count read from that run alone, steps/s, target
     tokens/s and the first and last loss; then 5 steps through the kernels
     and through the plain versions from the same init and dropout draws;
     then 3 steps under torch.profiler, as phase 5, with the decoder scans'
     device ms a step;
  8b. the bf16-stream instances of kernels 2-5 (builds *_bf16, the
     reference's compute_dtype="bfloat16") against their plain versions on
     bf16 streams at (64, 24, 24) and (64, 128, 128), within
     BF16_STATE_ATOL / BF16_RTOL, a second call bit for bit, each call
     timed alone cold and warm beside its bound at the bf16 tensor rate
     and cuDNN's GRU in bf16 (a bf16 carry: not the same function);
  8c. phase 8's training at compute_dtype="bfloat16", beside it: 40 steps
     through train_loop, steps/s, target tokens/s, launches a step, a
     falling loss, kernels 2-5 in their bf16 instances only; 5 steps
     through the kernels and the plain versions; 2 steps with
     VAG_GRU_STREAM=fp32 (the fp32 instances only); 3 steps profiled;
  9. beam_topk kernel against its plain version at the unfused beam step's
     shape (B=128, K=5, V=8000), exactly, with finished rows and forced ties,
     and on the split cases (ragged V=8003, B=1 over many vocab slices, ties
     straddling a slice boundary and across beams, K=1, K=8, all finished;
     kernels 8 and 9 on them in phase 12);
     before it, kernels 6, 8 and 9 timed as grids alone at V=8000 and 16000,
     cold (L2 flushed) and warm, beside torch.topk on the candidates;
 10. dec_step kernel against its plain version at full width (B=128, K=5,
     T=32), at a ragged shape, at K=1 and at B=1, with masked source
     positions, a second call bit for bit as the first; its whole call
     timed alone, cold (L2 flushed) and warm, each of its grids' device
     time from torch.profiler, beside the four products through torch.mm
     in fp32;
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
     across 512-blocks, where each follows its own tie rule; both gens on
     the split cases of phase 9;
 13. the readout_topk kernel's shallow-slot watermark mode at R=640, E=256,
     V=16000 and at a part-full last row tile (R=35, V=8003), slot depths
     1 and 3: every row's viol as the plain version's
     under the kernel's lane map, unflagged rows and the per-step recovery
     bit for bit as depth K, a lane collision, a ban mask, the deferred
     live flag (all-frozen rows do not arm it);
 13b. kernel 1's whole call timed alone (readout_grid_times) at R=640,
     E=256, V=8000 and 16000: depth K, slots 1, slots 1 with the per-step
     recovery where no row is flagged, cold (L2 flushed) and warm, beside
     torch.addmm in fp32 and an empty device op;
 14. the long-caption decode: translate_corpus on the full-width ikea_vag
     model (V=16000, max_len 128, random weights from a seed, the output
     matrix scaled by IKEA_READOUT_SCALE) over 512
     synthetic sentences of 40-120 source tokens, in the eight modes of
     IKEA_MODES (two-phase at depth K and with per-step recovery; chunked
     with the deferred chunk rerun, per-step, unrolled; the unfused step
     through kernels 8, 9 and 6), each kernel's launches read from its own
     mode, the shares of identical hypotheses between modes, (a), (b),
     (f), (g) and (h) under the profiler, and (b) once more counting the row
     groups its per-step recoveries mark at 32 and at 64 rows;
 15. the command line (python -m vag_nmt_tpu_torch, in this process through
     cli.main) on a synthetic Multi30k data directory at full
     m30k_ende_vag width: train 20 steps with a dev eval, translate at
     beams 5, 12 and 20 (kernel 1 in passes) through the kernels and with
     --impl plain (the share of identical hypotheses), translate --nbest
     3, score --meteor, retrieval and translate-text (also with
     VAG_DEC_STEP=on), then train --set model.compute_dtype=bfloat16 and
     translate of that run (at fp32), each kernel's launches read from each
     command alone;
 16. the JAX package's toy run checked in under tests/goldens/jax_run_toy
     (its msgpack checkpoint read by the port) decoded on the card through
     the kernels against the JAX package's beam golden;
 17. kernel 1b, readout_topk's bf16 instances (bf16 t and W), against the
     plain version at R=640, E=256, V=8000 and 16000, K=5: depth K, slots
     1 and 3, the per-step recovery; at K = 12, 16 and 20 (passes) and
     phase 2's ragged shapes: values within READOUT_RTOL, ids exact on
     integer inputs and, but among near ties, on random ones; timed cold
     and warm beside the fp32 instance and torch.addmm in bf16; a mixed
     operand set raises;
 18. kernel 7b, dec_step's bf16 instances, at full width (128, 5, 32), K =
     12, K = 20 (beam groups) and the ragged shape, within BF16_STATE_ATOL
     (states) and BF16_RTOL (t), timed beside the fp32 instance and the
     four products through torch.mm in bf16;
 19. kernel 2b at the decode shapes (1024, 32) and (512, 120) against its
     plain version (held within BF16_STATE_ATOL; the share of identical
     states printed), timed beside the fp32 instance;
 20. the bf16 decode of phase 4's corpus (decode.compute_dtype=bfloat16):
     kernels 1b once a beam step and 2b twice an encoder pass, no fp32
     instance; the plain path (MIN_IDENTICAL_SHARE identical), the share
     split between kernel 2b alone and kernel 1b alone, and the fp32
     decode in the same run; profiled; then VAG_DEC_STEP=on (7b),
     VAG_FRT_GEMM_DTYPE=bf16 in the fp32 decode (1b), VAG_ATTN_E_DTYPE=fp32,
     the unfused step (kernel 6), and Translator in bf16;
 21. translate_corpus(fused=False), the bucketed path, fp32 and bf16,
     against the fused path (MIN_BUCKETED_SHARE), and VAG_SUPER_CHUNK=0
     and =256 against the default, kernel 2 twice an encoder pass;
 22. data parallelism on one card: two ranks of this script (gloo, the
     backend rule's pick for ranks sharing a card) train DP_STEPS steps
     of the full-width m30k_ende_vag model (batch 64, 32 a rank, dropout
     0.3) through make_train_step(mesh=) against the same steps in this
     process (losses, the reduced grads, the params, the replicas bit
     for bit), decode phase 4's corpus through translate_corpus(mesh=)
     (DP_MIN_SHARE identical; streaming and two-phase on a smaller
     corpus), kernels 2-5 and 1-2 counted on each rank; then train and
     translate under python -m torch.distributed.run --nproc-per-node 2;
     with two cards visible, the training and the decode again under
     NCCL, a rank a card;
 23. vocab-dim tensor parallelism on the one card (see the comment at
     phase_tensor_parallel);
 24. the host modules: init_params at one thread and at this process's
     count bit for bit, ResNet50 (random weights in torchvision's
     format) on a batch of 32 against its CPU forward with the card's
     images/s, and the extract-features command on 64 PNGs where PIL
     imports.
Phase 15 also decodes the bf16 run with --set decode.compute_dtype=bfloat16
(kernels 1b and 2b only), and runs make-toy -> train -> translate and a raw
synthetic Multi30k directory through preprocess -> train ->
translate-text.
Phase 1 builds all eight sources, readout_topk.cu and dec_step.cu four
times (K <= 8 and K > 8, each fp32 and bf16), gru_fwd.cu, gru_bwd.cu,
dec_scan_fwd.cu and dec_scan_bwd.cu twice (fp32 and bf16 streams), and
prints ptxas's spills of every build. It prints one JSON line of per-kernel
numbers and, last, the device line. With --gru-grids it prints phase 3's
grid times alone, with --readout-grids kernel 1's, with --dec-step-grids
kernel 7's, with --dec-scan-grids kernels 4 and 5's, with --gru-bwd-grids
kernel 3's (see main).
Needs torch with CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

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


def _grid_ms(torch, launch, reps: int = 41, hold: int = HOLD_CYCLES,
             warm_hold: int = WARM_HOLD_CYCLES):
    """(cold, warm) device ms of one launch(): cold is the median of
    per-launch event pairs with L2 flushed before each, warm the time of
    WARM_LAUNCHES back-to-back launches over their count. launch() enqueues
    the grid alone (inputs and outputs made beforehand); the holds (device
    sleep, cycles) must outlast the host's enqueue of one launch (cold) and
    of WARM_LAUNCHES (warm)."""
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in pairs:
        flush.sum()
        torch.cuda._sleep(hold)
        a.record()
        launch()
        b.record()
    torch.cuda.synchronize()
    cold = _median([a.elapsed_time(b) for a, b in pairs])
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(warm_hold)
    a.record()
    for _ in range(WARM_LAUNCHES):
        launch()
    b.record()
    torch.cuda.synchronize()
    return cold, a.elapsed_time(b) / WARM_LAUNCHES


def _bound(flops: float, nbytes: float, peak: float = 0.0):
    """Least time on the card (ms) and what bounds it, against ``peak``
    operations/s (0: the H100 SXM's fp32 peak outside the tensor cores) and
    the HBM rate (core/flops.py)."""
    from vag_nmt_tpu_torch.core.flops import (H100_HBM_BYTES_PER_S,
                                              H100_PEAK_FP32_FLOPS)

    t_ops = flops / (peak or H100_PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _readout_bound(R: int, E: int, V: int, K: int, slots: bool):
    """Kernel 1's bound (ms, by): its product t @ W runs as three TF32
    products on the tensor cores (3xTF32), 3 x 2REV operations at the TF32
    peak; its bytes are t, W and b read once, the top-K, lse (and viol)
    written once."""
    from vag_nmt_tpu_torch.core.flops import H100_PEAK_TF32_FLOPS

    nbytes = 4.0 * (R * E + E * V + V) + 8.0 * R * K + (8.0 if slots else 4.0) * R
    return _bound(3 * 2.0 * R * E * V, nbytes, H100_PEAK_TF32_FLOPS)


# Phase 2's readout cases (kind, sentences, E, V): the m30k beam-5 decode
# shape, and ragged ones: V = 8003 (W's rows off a 16-byte boundary: 4-byte
# copies, a part-full last column tile) at 7 sentences (one part-full row
# tile), and E = 250 (t's rows off a 16-byte boundary, a part-full depth
# chunk).
READOUT_CASES = (("random", 128, 256, 8000), ("integer", 128, 256, 8000),
                 ("all_finished", 128, 256, 8000), ("ban", 128, 256, 8000),
                 ("ragged", 7, 256, 8003), ("ragged_e", 7, 250, 8003))


def phase_readout(torch, np, dev):
    from vag_nmt_tpu_torch.ops import readout_topk as rt

    K, M = 5, 12
    rng = np.random.RandomState(1)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def case(kind, B, E, V):
        R = B * K
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
    for kind, B, E, V in READOUT_CASES:
        t, w, b, scores, fin, ban = case(kind, B, E, V)
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
        again = rt.readout_topk_rows(t, w, b, K, mask, impl="kernel")
        if not all(torch.equal(x, y) for x, y in zip(again, (kv, ki, kl))):
            raise AssertionError(f"readout_topk {kind}: a second call differs")
        fk = rt.fused_readout_topk(t, w, b, scores, fin, ban, impl="kernel")
        fp = rt.fused_readout_topk(t, w, b, scores, fin, ban, impl="plain")
        if not torch.equal(fk[1], fp[1]):
            raise AssertionError(f"fused_readout_topk {kind}: ids differ")
        if not torch.allclose(fk[0], fp[0], rtol=READOUT_RTOL, atol=0.0):
            raise AssertionError(f"fused_readout_topk {kind}: values off by "
                                 f"{float((fk[0] - fp[0]).abs().max())}")
        print(f"readout_topk {kind} (R={B * K}, E={E}, V={V}): ok")

    _, B, E, V = READOUT_CASES[0]
    R = B * K
    t, w, b, *_ = case("random", B, E, V)
    ms = _time_ms(torch, lambda: rt.readout_topk_rows(t, w, b, K, impl="kernel"))
    plain_ms = _time_ms(torch, lambda: rt.readout_topk_rows_plain(t, w, b, K))
    bound_ms, bound_by = _readout_bound(R, E, V, K, slots=False)
    print(f"readout_topk: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) max_abs_err={max_err:.3g}")
    return {"name": "readout_topk", "route": "cuda",
            "source": "vag_nmt_tpu_torch/csrc/readout_topk.cu",
            "replaces": "vag_nmt_tpu/ops/pallas_readout_topk.py:113",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# Kernel 1 timed as a grid alone (readout_grid_times): R = 640 rows (128
# sentences x beam 5), E = 256, at the m30k and ikea_vag vocabularies.
READOUT_GRID_V = (8000, 16000)
# Through the wrapper, whose host work (allocations, the C call) must be
# enqueued before the device gets there: ~1 ms of device sleep before a
# cold call, ~50 ms before WARM_LAUNCHES warm ones.
READOUT_HOLD, READOUT_WARM_HOLD = 2_000_000, 100_000_000
# Ids of distinct lanes (split 0, 4-column groups 0-4) made the five best of
# every row by far: slots 1 then flags no row (the recovery's rerun exits).
READOUT_CLEAR_IDS = (0, 4, 8, 12, 16)


def readout_grid_times(torch, np, dev):
    """Kernel 1's whole call, its device work alone, cold (L2 flushed) and
    warm (_grid_ms), at R=640, E=256, K=5 and each V of READOUT_GRID_V:
    depth K, slots 1, and slots 1 with the per-step recovery where no row
    is flagged; beside it torch.addmm(b, t, W) in fp32 (TF32 off), the GEMM
    share of the same work, and an empty device op. Through the wrapper of
    whichever vag_nmt_tpu_torch is first on sys.path. {V: fields}."""
    from vag_nmt_tpu_torch.ops import readout_topk as rt

    R, E, K = 640, 256, 5
    floor_ms = _grid_ms(torch, lambda: torch.cuda._sleep(0))[0]
    allow = torch.backends.cuda.matmul.allow_tf32
    out = {}
    for V in READOUT_GRID_V:
        rng = np.random.RandomState(V + 7)
        t = torch.from_numpy(np.tanh(rng.randn(R, E)).astype(np.float32)).to(dev)
        w = torch.from_numpy((0.05 * rng.randn(E, V)).astype(np.float32)).to(dev)
        bn = (0.1 * rng.randn(V)).astype(np.float32)
        bn[list(READOUT_CLEAR_IDS)] += 100.0
        b = torch.from_numpy(bn).to(dev)
        live = torch.ones(R, dtype=torch.uint8, device=dev)
        viol = rt.readout_topk_rows(t, w, b, K, slots=1, impl="kernel")[3]
        if int(viol.sum()) != 0:
            raise AssertionError(f"readout grid case V={V}: rows flagged")
        kw = {"hold": READOUT_HOLD, "warm_hold": READOUT_WARM_HOLD}
        depth = _grid_ms(torch, lambda: rt.readout_topk_rows(
            t, w, b, K, impl="kernel"), **kw)
        slots = _grid_ms(torch, lambda: rt.readout_topk_rows(
            t, w, b, K, slots=1, impl="kernel"), **kw)
        rec = _grid_ms(torch, lambda: rt.readout_topk_rows(
            t, w, b, K, slots=1, recover_live=live, impl="kernel"), **kw)
        logits = torch.empty((R, V), dtype=torch.float32, device=dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            addmm = _grid_ms(torch, lambda: torch.addmm(b, t, w, out=logits))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
        bound_ms, bound_by = _readout_bound(R, E, V, K, slots=False)
        out[V] = {"R": R, "E": E, "V": V, "K": K,
                  "grid_ms": depth[0], "grid_warm_ms": depth[1],
                  "slots1_grid_ms": slots[0], "slots1_grid_warm_ms": slots[1],
                  "recovery_grid_ms": rec[0], "recovery_grid_warm_ms": rec[1],
                  "addmm_grid_ms": addmm[0], "addmm_grid_warm_ms": addmm[1],
                  "grid_floor_ms": floor_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "grid_bound_share": bound_ms / depth[0]}
        print(f"readout_topk grid (R={R}, E={E}, V={V}): " + json.dumps(out[V]))
    return out


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


# Phase 6's cases (label, B, T, H): the m30k training bucket (64, 24), its
# longest source bucket (64, 128), a ragged batch at a narrow width (a part
# full row part, widths that are no multiple of 16), and twice m30k's width
# (H = 1024: a CTA's Uh^T slice 192 KB); E = GRU_E, both directions.
GRU_BWD_CASES = (("train", TRAIN_B, TRAIN_T, 512), ("long", 64, 128, 512),
                 ("ragged", 37, 13, 94), ("wide", TRAIN_B, TRAIN_T, 1024))
GRU_BWD_TIMED = ("train", "long")   # timed as whole calls (--gru-bwd-grids)


def _gru_bwd_case(torch, np, dev, B, T, H, seed=6):
    """(args of gru_bwd for the forward direction, x, the states of the
    reverse one): params from init_gru_params with random biases, ragged
    lengths (every row at least min(4, T) tokens), h0 and a cotangent from
    numpy; the states from the plain forward."""
    from vag_nmt_tpu_torch.ops.gru import init_gru_params
    from vag_nmt_tpu_torch.ops.gru_kernel import gru_fwd_plain

    rng = np.random.RandomState(seed)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    p = {k: v.to(dev) for k, v in
         init_gru_params(torch.Generator().manual_seed(seed), GRU_E, H).items()}
    bh = cuda(0.1 * rng.randn(3 * H))
    x = cuda(0.5 * rng.randn(T, B, GRU_E))
    xg_t = (x @ p["wi"] + cuda(0.1 * rng.randn(3 * H))).contiguous()
    lens = torch.from_numpy(rng.randint(min(4, T), T + 1, B)).to(dev)
    mask_t = (torch.arange(T, device=dev)[:, None] < lens[None, :]).float().contiguous()
    h0 = cuda(0.5 * rng.randn(B, H))
    g_t = cuda(rng.randn(T, B, H))
    hs = {rev: gru_fwd_plain(xg_t, mask_t, p["uh"], bh, h0, reverse=rev)
          for rev in (False, True)}
    return (xg_t, mask_t, p["uh"], bh, h0, hs[False], g_t), x, hs[True]


def gru_bwd_grid_times(torch, np, dev):
    """gru_bwd's whole call alone through the wrapper, cold (L2 flushed)
    and warm (_grid_ms), at GRU_BWD_TIMED, with each grid's device ms a
    call from torch.profiler (warm); through the wrapper of whichever
    vag_nmt_tpu_torch is first on sys.path (its only device work is the
    kernel's grids and the scratch it makes). {label: fields}."""
    from vag_nmt_tpu_torch.ops.gru_kernel import gru_bwd

    kw = {"hold": READOUT_HOLD, "warm_hold": READOUT_WARM_HOLD}
    out = {}
    for label, B, T, H in GRU_BWD_CASES:
        if label not in GRU_BWD_TIMED:
            continue
        args, _, _ = _gru_bwd_case(torch, np, dev, B, T, H)

        def call():
            return gru_bwd(*args, impl="kernel")

        cold, warm = _grid_ms(torch, call, **kw)
        out[label] = {"B": B, "T": T, "H": H, "grid_ms": cold,
                      "grid_warm_ms": warm,
                      "grids_warm_ms": _profile_grids(torch, call, 5)}
        print(f"gru_bwd grids {label}: " + json.dumps(out[label]))
    return out


def _gru_bwd_bound(B, T, H):
    """(bound ms, by, fp32 bound ms) of one call: the three products
    (recompute, dhg @ Uh^T, h_prev^T dhg) as three TF32 products each at
    the TF32 peak; bytes: xg, mask, uh, bh, h0, hs, g in, dxg, dh0, duh,
    dbh out, once. The fp32 bound runs the products on the fp32 cores."""
    from vag_nmt_tpu_torch.core.flops import H100_PEAK_TF32_FLOPS

    flops = 3 * 2.0 * T * B * H * 3 * H
    nbytes = 4.0 * (2 * T * B * 3 * H + T * B + H * 3 * H + 3 * H + 2 * B * H
                    + 2 * T * B * H + H * 3 * H + 3 * H)
    bound_ms, bound_by = _bound(3 * flops, nbytes, H100_PEAK_TF32_FLOPS)
    return bound_ms, bound_by, _bound(flops, nbytes)[0]


def phase_gru_bwd(torch, np, dev):
    """gru_bwd against gru_bwd_plain at GRU_BWD_CASES, both directions:
    every output within GRU_BWD_RTOL, dxg 0 at masked steps, a second call
    bit for bit; then the whole call timed alone (gru_bwd_grid_times)
    beside cuDNN's backward, and through the wrapper at training's shape."""
    from vag_nmt_tpu_torch.ops.gru_kernel import (_device_limits, gru_bwd,
                                                  gru_bwd_plain, gru_bwd_plan)

    errs, abs_err = {}, 0.0
    for label, B, T, H in GRU_BWD_CASES:
        fwd_args, _, hs_rev = _gru_bwd_case(torch, np, dev, B, T, H)
        plan = gru_bwd_plan(B, H, *_device_limits(dev))
        for reverse in (False, True):
            args = fwd_args[:5] + ((hs_rev if reverse else fwd_args[5]),
                                   fwd_args[6])
            got = gru_bwd(*args, reverse=reverse, impl="kernel")
            again = gru_bwd(*args, reverse=reverse, impl="kernel")
            want = gru_bwd_plain(*args, reverse=reverse)
            torch.cuda.synchronize()
            for name, a, b in zip(("dxg", "duh", "dbh", "dh0"), got, want):
                err = _rel_err(a, b)
                errs[name] = max(errs.get(name, 0.0), err)
                abs_err = max(abs_err, float((a - b).abs().max()))
                if not err <= GRU_BWD_RTOL:
                    raise AssertionError(f"gru_bwd {label} reverse={reverse} "
                                         f"{name}: relative err {err}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"gru_bwd {label} reverse={reverse}: a "
                                     "second call differs")
            mask_t = args[1]
            masked = (mask_t == 0)[:, :, None].expand(T, B, 3 * H)
            if masked.any() and float(got[0][masked].abs().max()) != 0.0:
                raise AssertionError(f"gru_bwd {label}: dxg is not 0 at masked "
                                     "steps")
        q = plan.product
        print(f"gru_bwd {label} (B={B}, T={T}, H={H}): ok, both directions, "
              f"plan ctas={q.ctas} tile={q.tile_rows}x{q.tile_cols} "
              f"smem={plan.smem_bytes} l2_floats={plan.l2_floats}")
    print(f"gru_bwd relative errors: {json.dumps(errs)}")

    grids = gru_bwd_grid_times(torch, np, dev)
    B, T, H = TRAIN_B, TRAIN_T, 512
    args, x, _ = _gru_bwd_case(torch, np, dev, B, T, H)
    ms = _time_ms(torch, lambda: gru_bwd(*args, impl="kernel"), reps=20)
    plain_ms = _time_ms(torch, lambda: gru_bwd_plain(*args), reps=10)
    # Yardstick only (the port never calls it): cuDNN's GRU forward +
    # backward minus its forward at the same (T, B, E, H), TF32 off; it also
    # does the input projection's backward.
    cudnn = torch.nn.GRU(GRU_E, H).to(dev)
    xr = x.clone().requires_grad_(True)
    gy = torch.randn(T, B, H, device=dev)

    def fwd_bwd():
        y, _ = cudnn(xr)
        y.backward(gy)

    with torch.no_grad():
        cudnn_fwd_ms = _time_ms(torch, lambda: cudnn(x), reps=20)
    library_ms = _time_ms(torch, fwd_bwd, reps=20) - cudnn_fwd_ms
    bound_ms, bound_by, fp32_ms = _gru_bwd_bound(B, T, H)
    tr = grids["train"]
    print(f"gru_bwd (one direction, B={B}, T={T}): wrapper_ms={ms:.4f} "
          f"grid_ms={tr['grid_ms']:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
          f"fp32_bound_ms={fp32_ms:.4f}")
    return {"name": "gru_bwd", "route": "cuda",
            "source": "vag_nmt_tpu_torch/csrc/gru_bwd.cu",
            "replaces": "vag_nmt_tpu/ops/pallas_gru.py:180",
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "grid_ms": tr["grid_ms"],
            "grid_warm_ms": tr["grid_warm_ms"],
            "shapes": {k: {**v, "bound_ms": _gru_bwd_bound(v["B"], v["T"], v["H"])[0]}
                       for k, v in grids.items()}}


def _dec_scan_shapes():
    """Phase 7's cases (label, B, T, Tt, H, A, C, R): training's (64, 24)
    bucket at m30k_ende_vag's full width, ikea_vag training's longest
    bucket (64, 128, 128), a ragged batch at widths that are no multiples
    of 4 (every operand 4 bytes off a 16-byte boundary: the 4-byte copy
    paths), a single target step, and a decoder twice m30k_ende_vag's width
    (H = A = 1024, C = 2048, R = 512: 54 MB of recurrent weights, more than
    the SMs' shared memory holds, so the plan keeps some phases' weight
    slices in L2)."""
    import vag_nmt_tpu_torch as vt

    def widths(name):
        m = vt.preset(name).model
        return (m.dec_hidden_dim, m.attn_dim, m.ctx_dim, m.emb_dim)

    full = widths("m30k_ende_vag")
    return (("train", TRAIN_B, TRAIN_T, TRAIN_T, *full),
            ("ikea", 64, 128, 128, *widths("ikea_vag")),
            ("ragged", 37, 13, 9, 94, 90, 190, 62),
            ("tt1", TRAIN_B, TRAIN_T, 1, *full),
            ("wide", TRAIN_B, TRAIN_T, 8, 1024, 1024, 2048, 512))


DEC_SCAN_TIMED = ("train", "ikea", "wide")   # phase 7's cases timed as grids


def _dec_scan_case(torch, np, dev, B, T, Tt, H, A, C, R, seed=7,
                   misaligned=False):
    """Decoder-scan inputs (ty + b, xg1, s0, ctx, ctx_proj + ba, mask),
    weights at 1/sqrt(fan-in) scale with random biases, and a cotangent g_t;
    source lengths from 1 to T (the first row full)."""
    rng = np.random.RandomState(seed)

    def cuda(*shape, scale=0.5):
        x = torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32)).to(dev)
        return _misaligned(torch, x) if misaligned else x

    H3 = 3 * H
    weights = (cuda(H, H3, scale=H ** -0.5), cuda(H3, scale=0.1),
               cuda(H, A, scale=H ** -0.5), cuda(A, scale=A ** -0.5),
               cuda(C, H3, scale=C ** -0.5), cuda(H3, scale=0.1),
               cuda(H, H3, scale=H ** -0.5), cuda(H3, scale=0.1),
               cuda(H, R, scale=H ** -0.5), cuda(C, R, scale=C ** -0.5))
    lens = rng.randint(1, T + 1, B)
    lens[0] = T
    mask = torch.from_numpy((np.arange(T)[None] < lens[:, None]).astype(
        np.float32)).to(dev)
    if misaligned:
        mask = _misaligned(torch, mask)
    inputs = (cuda(Tt, B, R), cuda(Tt, B, H3), cuda(B, H), cuda(B, T, C),
              cuda(B, T, A), mask)
    return inputs, weights, cuda(Tt, B, R, scale=1.0)


def _dec_scan_work(kind, B, T, Tt, H, A, C, R):
    """One call's (product flops, attention flops, fp32 bytes, floats of
    them that travel as bf16 in the bf16 instances): the products per step
    and time-parallel, the attention's energies (add, tanh, multiply-add by
    va, and in the backward the da, dq and dva terms) and its dot products
    with ctx; bytes: weights, inputs and outputs once."""
    H3, rows = 3 * H, Tt * B
    w_mat = 2 * H * H3 + H * A + C * H3 + H * R + C * R
    w_floats = w_mat + A + 3 * H3
    res_floats = rows * (R + 2 * H + C + T + A + 3 * H3) + B * H
    inp_floats = rows * (R + H3) + B * H + B * T * (C + A + 1)
    half = w_mat + rows * H3 + B * T * C          # matrices, xg, ctx
    if kind == "fwd":
        gemm = 2.0 * rows * (H * H3 + H * A + H * H3 + C * H3 + (C + H) * R)
        att = rows * T * (4.0 * A + 2.0 * C)
        nbytes = 4.0 * (w_floats + inp_floats + res_floats)
    else:
        gemm = (2.0 * rows * (H3 * C + H3 * H + A * H + H3 * H)       # carry
                + 2.0 * rows * R * (H + C)                            # dpre @ .T
                + 2.0 * rows * (2 * H * H3 + H * A + C * H3 + (H + C) * R)
                + 2.0 * rows * T * C)                                 # dctx
        att = rows * T * (2.0 * C + 12.0 * A)
        nbytes = 4.0 * (2 * w_floats + inp_floats + 2 * res_floats + rows * R
                        + B * T * (C + A))
        half *= 2                                   # and their grads
    return gemm, att, nbytes, half


def _dec_scan_bound(kind, B, T, Tt, H, A, C, R):
    """(bound ms, by, fp32 bound ms) of one call (_dec_scan_work): the
    products as three TF32 products on the tensor cores at the TF32 peak,
    the attention on the fp32 cores. The fp32 bound runs the products on
    the fp32 cores too."""
    from vag_nmt_tpu_torch.core.flops import (H100_HBM_BYTES_PER_S,
                                              H100_PEAK_FP32_FLOPS,
                                              H100_PEAK_TF32_FLOPS)

    gemm, att, nbytes, _ = _dec_scan_work(kind, B, T, Tt, H, A, C, R)
    t_ops = (3 * gemm / H100_PEAK_TF32_FLOPS + att / H100_PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    fp32_ms = max((gemm + att) / H100_PEAK_FP32_FLOPS * 1e3, t_bytes)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", fp32_ms


def _dec_scan_bf16_bound(kind, B, T, Tt, H, A, C, R):
    """Kernels 4 and 5's bf16 instances: the products once at the bf16
    tensor rate, the attention on the fp32 cores; the matrices, xg, ctx
    (and in the backward their grads) at 2 bytes."""
    from vag_nmt_tpu_torch.core.flops import (H100_HBM_BYTES_PER_S,
                                              H100_PEAK_BF16_FLOPS,
                                              H100_PEAK_FP32_FLOPS)

    gemm, att, nbytes, half = _dec_scan_work(kind, B, T, Tt, H, A, C, R)
    t_ops = (gemm / H100_PEAK_BF16_FLOPS + att / H100_PEAK_FP32_FLOPS) * 1e3
    t_bytes = (nbytes - 2.0 * half) / H100_HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def dec_scan_grid_times(torch, np, dev):
    """Kernels 4 and 5, each whole call alone through the wrapper, cold (L2
    flushed) and warm (_grid_ms), at phase 7's timed cases, with each grid's
    device ms a call from torch.profiler (warm); through the wrappers of
    whichever vag_nmt_tpu_torch is first on sys.path."""
    from vag_nmt_tpu_torch.ops.dec_scan import (dec_scan_bwd, dec_scan_fwd,
                                                dec_scan_fwd_plain)

    kw = {"hold": READOUT_HOLD, "warm_hold": READOUT_WARM_HOLD}
    out = {}
    for label, *shape in _dec_scan_shapes():
        if label not in DEC_SCAN_TIMED:
            continue
        inputs, weights, g_t = _dec_scan_case(torch, np, dev, *shape)
        want = dec_scan_fwd_plain(*inputs, weights)
        xg_t, ctx, ctxp, mask = inputs[1], inputs[3], inputs[4], inputs[5]
        calls = {"fwd": lambda: dec_scan_fwd(*inputs, weights, impl="kernel"),
                 "bwd": lambda: dec_scan_bwd(want, xg_t, ctx, ctxp, mask,
                                             weights, g_t, impl="kernel")}
        row = {"B": shape[0], "T": shape[1], "Tt": shape[2]}
        for kind, call in calls.items():
            cold, warm = _grid_ms(torch, call, **kw)
            row[kind] = {"grid_ms": cold, "grid_warm_ms": warm,
                         "grids_warm_ms": _profile_grids(torch, call, 5)}
        out[label] = row
        print(f"dec_scan grids {label}: " + json.dumps(row))
    return out


def _dec_scan_phases(torch, call, kind, Tt, reps=5):
    """Device ms of each phase of one call's recurrence (median of reps),
    from its barrier stamps (the wrapper's `timers`: thread 0 of CTA 0
    reads the global timer after each grid sync; the launch is the same
    with or without them), and the recurrence's whole grid."""
    names = (("hg1_gru1", "q_hg2", "attention", "xg2_gru2") if kind == "fwd"
             else ("dc_dst", "attention_bwd", "dstq_gru1", "ds_gru2"))
    runs = []
    for _ in range(reps):
        timers = torch.zeros(4 * Tt + 2, dtype=torch.int64, device="cuda")
        call(timers)
        torch.cuda.synchronize()
        d = [x / 1e6 for x in (timers[1:] - timers[:-1]).tolist()]
        ph = {"weights" if kind == "fwd" else "weights_gru2_first": d[0]}
        for i, name in enumerate(names):
            ph[name] = sum(d[1 + 4 * s + i] for s in range(Tt))
        ph["recurrence"] = sum(d)
        runs.append(ph)
    return {k: _median([r[k] for r in runs]) for k in runs[0]}


def phase_dec_scan(torch, np, dev):
    """dec_scan_fwd / dec_scan_bwd against their plain versions at phase 7's
    cases (_dec_scan_shapes): the readout, every residual and all 15 grads
    within DEC_SCAN_RTOL, a second call bit for bit as the first; then both
    calls timed alone (dec_scan_grid_times) with each phase's device ms
    (_dec_scan_phases) at the timed cases, and through the wrapper at
    training's shape."""
    from vag_nmt_tpu_torch.ops.dec_scan import (
        RESIDUALS, dec_scan_bwd, dec_scan_bwd_plain, dec_scan_fwd,
        dec_scan_fwd_plain, dec_scan_plan, tanh_fast_probe)
    from vag_nmt_tpu_torch.ops.gru_kernel import _device_limits

    names = ("dty", "dxg1", "ds0", "dctx", "dctx_proj", "duh1", "dbh1", "dua",
             "dva", "dwi2", "dbi2", "duh2", "dbh2", "dws", "dwc")
    fwd_abs = bwd_abs = 0.0
    for label, *shape in _dec_scan_shapes():
        inputs, weights, g_t = _dec_scan_case(
            torch, np, dev, *shape, misaligned=label == "ragged")
        xg_t, ctx, ctxp, mask = inputs[1], inputs[3], inputs[4], inputs[5]
        got = dec_scan_fwd(*inputs, weights, impl="kernel")
        again = dec_scan_fwd(*inputs, weights, impl="kernel")
        want = dec_scan_fwd_plain(*inputs, weights)
        gk = dec_scan_bwd(want, xg_t, ctx, ctxp, mask, weights, g_t, impl="kernel")
        gk2 = dec_scan_bwd(want, xg_t, ctx, ctxp, mask, weights, g_t, impl="kernel")
        gp = dec_scan_bwd_plain(want, xg_t, ctx, ctxp, mask, weights, g_t)
        torch.cuda.synchronize()
        errs = {k: _rel_err(got[k], want[k]) for k in RESIDUALS}
        errs.update({n: _rel_err(a, b) for n, a, b in zip(names, gk, gp)})
        bad = {k: v for k, v in errs.items() if not v <= DEC_SCAN_RTOL}
        if bad:
            raise AssertionError(f"dec_scan {label} {shape}: relative errors {bad}")
        if not all(torch.equal(got[k], again[k]) for k in RESIDUALS):
            raise AssertionError(f"dec_scan_fwd {label}: a second call differs")
        if not all(torch.equal(a, b) for a, b in zip(gk, gk2)):
            raise AssertionError(f"dec_scan_bwd {label}: a second call differs")
        fwd_abs = max([fwd_abs] + [float((got[k] - want[k]).abs().max())
                                   for k in RESIDUALS])
        bwd_abs = max([bwd_abs] + [float((a - b).abs().max())
                                   for a, b in zip(gk, gp)])
        print(f"dec_scan {label} (B, T, Tt, H, A, C, R)={tuple(shape)}: ok, "
              f"max relative err fwd {max(errs[k] for k in RESIDUALS):.3g}, "
              f"bwd {json.dumps({n: float(f'{errs[n]:.3g}') for n in names})}")

    # the energies' tanh_fast against tanhf over their range
    x = torch.linspace(-12.0, 12.0, 1 << 22, device=dev)
    fast, ref = tanh_fast_probe(x)
    tanh_err = float((fast - ref).abs().max())
    print(f"dec_scan tanh_fast vs tanhf on the card: max abs diff {tanh_err:.3g} "
          f"over [-12, 12] (bound 4.8e-7)")
    if not tanh_err <= 4.8e-7:
        raise AssertionError(f"tanh_fast is {tanh_err} off tanhf")

    grids = dec_scan_grid_times(torch, np, dev)
    shapes, fp32 = {}, {}
    for label, *shape in _dec_scan_shapes():
        if label not in DEC_SCAN_TIMED:
            continue
        B, T, Tt, H, A, C, R = shape
        inputs, weights, g_t = _dec_scan_case(torch, np, dev, *shape)
        want = dec_scan_fwd_plain(*inputs, weights)
        xg_t, ctx, ctxp, mask = inputs[1], inputs[3], inputs[4], inputs[5]
        plan = dec_scan_plan(B, T, H, A, C, R, *_device_limits(dev))
        row = {}
        for kind, call in (
                ("fwd", lambda tm: dec_scan_fwd(*inputs, weights, impl="kernel",
                                                timers=tm)),
                ("bwd", lambda tm: dec_scan_bwd(want, xg_t, ctx, ctxp, mask,
                                                weights, g_t, impl="kernel",
                                                timers=tm))):
            bound_ms, bound_by, fp32_ms = _dec_scan_bound(kind, *shape)
            kp = getattr(plan, kind)
            row[kind] = {**grids[label][kind],
                         "phases_ms": _dec_scan_phases(torch, call, kind, Tt),
                         "bound_ms": bound_ms, "bound_by": bound_by}
            # the plan is computed, not measured: printed, not in the
            # kernels line
            plan_of = {"ctas": kp.ctas, "att_parts": kp.att_parts,
                       "smem_bytes": kp.smem_bytes, "l2_floats": kp.l2_floats,
                       "products": [p.launch_args() for p in kp.products]}
            print(f"dec_scan_{kind} {label} (B={B}, T={T}, Tt={Tt}): "
                  + json.dumps(row[kind]) + f" fp32_bound_ms={fp32_ms:.4f} "
                  f"plan={json.dumps(plan_of)}")
            fp32[label, kind] = fp32_ms
        shapes[label] = row

    inputs, weights, g_t = _dec_scan_case(torch, np, dev, *_dec_scan_shapes()[0][1:])
    want = dec_scan_fwd_plain(*inputs, weights)
    xg_t, ctx, ctxp, mask = inputs[1], inputs[3], inputs[4], inputs[5]
    out = []
    for kind, fn, plain, err, line in (
            ("fwd", lambda: dec_scan_fwd(*inputs, weights, impl="kernel"),
             lambda: dec_scan_fwd_plain(*inputs, weights), fwd_abs, 165),
            ("bwd", lambda: dec_scan_bwd(want, xg_t, ctx, ctxp, mask, weights,
                                         g_t, impl="kernel"),
             lambda: dec_scan_bwd_plain(want, xg_t, ctx, ctxp, mask, weights,
                                        g_t), bwd_abs, 286)):
        ms = _time_ms(torch, fn, reps=10)
        plain_ms = _time_ms(torch, plain, reps=5)
        tr = shapes["train"][kind]
        print(f"dec_scan_{kind} (B={TRAIN_B}, T=Tt={TRAIN_T}): wrapper_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} grid_ms={tr['grid_ms']:.4f} "
              f"bound_ms={tr['bound_ms']:.4f} ({tr['bound_by']}) "
              f"fp32_bound_ms={fp32['train', kind]:.4f}")
        out.append({"name": f"dec_scan_{kind}", "route": "cuda",
                    "source": f"vag_nmt_tpu_torch/csrc/dec_scan_{kind}.cu",
                    "replaces": f"vag_nmt_tpu/ops/pallas_dec_scan.py:{line}",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": tr["bound_ms"], "bound_by": tr["bound_by"],
                    "library_ms": None, "grid_ms": tr["grid_ms"],
                    "grid_warm_ms": tr["grid_warm_ms"],
                    "tanh_fast_max_abs_err": tanh_err,
                    "shapes": {k: v[kind] for k, v in shapes.items()}})
    return out


# Phase 8b: the bf16-stream instances of kernels 2-5 (builds *_bf16) against
# their plain versions on bf16 streams at the training shapes: kernels 2
# and 3 at (B, T) = (64, 24) and (64, 128), H = 512; kernels 4 and 5 at
# (B, T, Tt) = (64, 24, 24) at m30k_ende_vag's widths and (64, 128, 128) at
# ikea_vag's. Bounds (stated): the bf16 states and dxg within
# BF16_STATE_ATOL (both sides sum the same exact products of bf16 values in
# other orders, so a value next to a bf16 rounding boundary may round one
# ulp, 2^-8 of |x| < 1, the other way); every other output within
# BF16_RTOL of its scale (_rel_err), the weight grads being rounded to
# bf16 once.
BF16_GRU_SHAPES = (("train", TRAIN_B, TRAIN_T), ("long", 64, 128))
BF16_STATE_ATOL = 1.6e-2
BF16_RTOL = 2e-2


def _bf16_dec_scan_case(torch, np, dev, shape, seed=7):
    """Phase 7's decoder-scan case with the streams the bf16 path gives
    the kernels: xg_t, ctx and the six matrices in bf16."""
    from vag_nmt_tpu_torch.ops.dec_scan import MATRICES, WEIGHTS

    inputs, weights, g_t = _dec_scan_case(torch, np, dev, *shape, seed=seed)
    bf = torch.bfloat16
    inputs = (inputs[0], inputs[1].to(bf), inputs[2], inputs[3].to(bf),
              inputs[4], inputs[5])
    weights = tuple(w.to(bf) if n in MATRICES else w
                    for n, w in zip(WEIGHTS, weights))
    return inputs, weights, g_t


def _gru_fwd_bf16_bound(B, T, H):
    """Kernel 2's bf16 instance: its products h @ Uh on bf16 operands at
    the bf16 tensor rate; bytes with the streams (xg in, hs out) and Uh in
    bf16, the mask, bh and h0 in fp32."""
    from vag_nmt_tpu_torch.core.flops import H100_PEAK_BF16_FLOPS

    flops = 2.0 * T * B * H * 3 * H
    nbytes = (2.0 * (T * B * 3 * H + T * B * H + H * 3 * H)
              + 4.0 * (T * B + 3 * H + B * H))
    return _bound(flops, nbytes, H100_PEAK_BF16_FLOPS)


def _gru_bwd_bf16_bound(B, T, H):
    """Kernel 3's bf16 instance: its three products at the bf16 tensor
    rate; bytes with the streams (xg, hs, g in, dxg out) and Uh in bf16."""
    from vag_nmt_tpu_torch.core.flops import H100_PEAK_BF16_FLOPS

    flops = 3 * 2.0 * T * B * H * 3 * H
    nbytes = (2.0 * (2 * T * B * 3 * H + 2 * T * B * H + H * 3 * H)
              + 4.0 * (T * B + 3 * H + 2 * B * H + H * 3 * H + 3 * H))
    return _bound(flops, nbytes, H100_PEAK_BF16_FLOPS)


def phase_bf16_kernels(torch, np, dev):
    """The bf16 instances of kernels 2-5 against their plain versions on
    bf16 streams (the bounds above), kernel 4 also in its replay from the
    saved bf16 states and kernel 5 on the replay's residuals, a second call
    bit for bit as the first, each whole call timed alone cold and warm;
    returns their rows of the kernels line (launches from the bf16 training
    run)."""
    from vag_nmt_tpu_torch.ops.dec_scan import (RESIDUALS, dec_scan_bwd,
                                                dec_scan_bwd_plain,
                                                dec_scan_fwd,
                                                dec_scan_fwd_plain)
    from vag_nmt_tpu_torch.ops.gru_kernel import (gru_bwd, gru_bwd_plain,
                                                  gru_fwd, gru_fwd_plain)

    bf = torch.bfloat16
    kw = {"hold": READOUT_HOLD, "warm_hold": READOUT_WARM_HOLD}
    rows = {n: {"shapes": {}, "max_abs_err": 0.0} for n in
            ("gru_fwd", "gru_bwd", "dec_scan_fwd", "dec_scan_bwd")}
    for label, B, T in BF16_GRU_SHAPES:
        x, p, xg32, mask_t, h0 = _gru_case(torch, np, dev, B, T, seed=12)
        xg_t = xg32.to(bf)
        H = GRU_H
        g_t = torch.from_numpy(np.random.RandomState(13).randn(T, B, H).astype(
            np.float32)).to(dev).to(bf)
        for reverse in (False, True):
            hk = gru_fwd(xg_t, mask_t, p["uh"], p["bh"], h0, reverse=reverse,
                         impl="kernel")
            hk2 = gru_fwd(xg_t, mask_t, p["uh"], p["bh"], h0, reverse=reverse,
                          impl="kernel")
            hp = gru_fwd_plain(xg_t, mask_t, p["uh"], p["bh"], h0,
                               reverse=reverse)
            args = (xg_t, mask_t, p["uh"], p["bh"], h0, hp, g_t)
            gk = gru_bwd(*args, reverse=reverse, impl="kernel")
            gk2 = gru_bwd(*args, reverse=reverse, impl="kernel")
            gp = gru_bwd_plain(*args, reverse=reverse)
            torch.cuda.synchronize()
            if hk.dtype != bf or gk[0].dtype != bf:
                raise AssertionError("gru bf16: streams not bf16")
            e = float((hk.float() - hp.float()).abs().max())
            if not e <= BF16_STATE_ATOL:
                raise AssertionError(f"gru_fwd bf16 {label} reverse={reverse}: "
                                     f"max abs err {e}")
            rows["gru_fwd"]["max_abs_err"] = max(rows["gru_fwd"]["max_abs_err"], e)
            errs = {"dxg": float((gk[0].float() - gp[0].float()).abs().max())}
            errs.update({n: _rel_err(a, b) for n, a, b in
                         zip(("duh", "dbh", "dh0"), gk[1:], gp[1:])})
            if not (errs["dxg"] <= BF16_STATE_ATOL and
                    max(errs[n] for n in ("duh", "dbh", "dh0")) <= BF16_RTOL):
                raise AssertionError(f"gru_bwd bf16 {label} reverse={reverse}: "
                                     f"{errs}")
            rows["gru_bwd"]["max_abs_err"] = max(
                [rows["gru_bwd"]["max_abs_err"]]
                + [float((a.float() - b.float()).abs().max())
                   for a, b in zip(gk, gp)])
            if not (torch.equal(hk, hk2) and all(torch.equal(a, b)
                                                 for a, b in zip(gk, gk2))):
                raise AssertionError(f"gru bf16 {label}: a second call differs")
        fwd = lambda: gru_fwd(xg_t, mask_t, p["uh"], p["bh"], h0, impl="kernel")
        hp = gru_fwd_plain(xg_t, mask_t, p["uh"], p["bh"], h0)
        args = (xg_t, mask_t, p["uh"], p["bh"], h0, hp, g_t)
        bwd = lambda: gru_bwd(*args, impl="kernel")
        # yardstick only (never called by the port): cuDNN's GRU in bf16,
        # whose carry is bf16 too: not the same function
        cudnn = torch.nn.GRU(GRU_E, H).to(dev).to(bf)
        xb = x.to(bf)
        gy = g_t
        with torch.no_grad():
            cudnn_fwd = _grid_ms(torch, lambda: cudnn(xb), **kw)
        xr = xb.clone().requires_grad_(True)

        def cudnn_fwd_bwd():
            y, _ = cudnn(xr)
            y.backward(gy)

        cudnn_fb_ms = _time_ms(torch, cudnn_fwd_bwd, reps=10)
        for name, call, plain, bnd, lib in (
                ("gru_fwd", fwd, lambda: gru_fwd_plain(xg_t, mask_t, p["uh"],
                                                       p["bh"], h0),
                 _gru_fwd_bf16_bound(B, T, H), cudnn_fwd[0]),
                ("gru_bwd", bwd, lambda: gru_bwd_plain(*args),
                 _gru_bwd_bf16_bound(B, T, H), cudnn_fb_ms - cudnn_fwd[0])):
            cold, warm = _grid_ms(torch, call, **kw)
            f = {"B": B, "T": T, "H": H, "grid_ms": cold, "grid_warm_ms": warm,
                 "bound_ms": bnd[0], "bound_by": bnd[1],
                 "library_ms": lib,
                 "library": "cuDNN nn.GRU in bf16 (bf16 carry: not the same "
                            "function)"}
            if label == "train":
                f["ms"] = _time_ms(torch, call, reps=20)
                f["plain_ms"] = _time_ms(torch, plain, reps=5)
            rows[name]["shapes"][label] = f
            print(f"{name} bf16 {label} (B={B}, T={T}): " + json.dumps(f))

    names = ("dty", "dxg1", "ds0", "dctx", "dctx_proj", "duh1", "dbh1", "dua",
             "dva", "dwi2", "dbi2", "duh2", "dbh2", "dws", "dwc")
    for label, *shape in _dec_scan_shapes():
        if label not in ("train", "ikea"):
            continue
        inputs, weights, g_t = _bf16_dec_scan_case(torch, np, dev, shape)
        xg_t, ctx, ctxp, mask = inputs[1], inputs[3], inputs[4], inputs[5]
        got = dec_scan_fwd(*inputs, weights, impl="kernel")
        again = dec_scan_fwd(*inputs, weights, impl="kernel")
        want = dec_scan_fwd_plain(*inputs, weights)
        # the backward's replay from the saved bf16 states, and the
        # backward on the replay's residuals (as DecoderScan runs them)
        states = torch.cat([inputs[2][None], want["s"][1:].to(bf).float()])
        rk = dec_scan_fwd(*inputs, weights, impl="kernel", states=states)
        rp = dec_scan_fwd_plain(*inputs, weights, states)
        gk = dec_scan_bwd(rp, xg_t, ctx, ctxp, mask, weights, g_t, impl="kernel")
        gk2 = dec_scan_bwd(rp, xg_t, ctx, ctxp, mask, weights, g_t, impl="kernel")
        gp = dec_scan_bwd_plain(rp, xg_t, ctx, ctxp, mask, weights, g_t)
        # what the fp32 carry's residuals would give instead (not the
        # reference's numerics): the size of the replay's effect
        carry = dec_scan_bwd_plain(want, xg_t, ctx, ctxp, mask, weights, g_t)
        torch.cuda.synchronize()
        errs = {k: _rel_err(got[k], want[k]) for k in RESIDUALS}
        errs.update({f"replay_{k}": _rel_err(rk[k], rp[k]) for k in RESIDUALS})
        errs.update({n: _rel_err(a.float(), b.float())
                     for n, a, b in zip(names, gk, gp)})
        effect = max(float((a.float() - b.float()).abs().max())
                     / max(1e-30, float(b.float().abs().max()))
                     for a, b in zip(carry, gp))
        print(f"dec_scan bf16 {label}: the fp32 carry's residuals move the "
              f"grads by up to {effect:.3g} of each grad's scale against "
              "the replay's")
        bad = {k: v for k, v in errs.items() if not v <= BF16_RTOL}
        if bad:
            raise AssertionError(f"dec_scan bf16 {label}: relative errors {bad}")
        if (gk[1].dtype, gk[3].dtype, gk[5].dtype) != (bf, bf, bf):
            raise AssertionError("dec_scan_bwd bf16: dxg1, dctx, duh1 not bf16")
        if not (all(torch.equal(got[k], again[k]) for k in RESIDUALS)
                and all(torch.equal(a, b) for a, b in zip(gk, gk2))):
            raise AssertionError(f"dec_scan bf16 {label}: a second call differs")
        rows["dec_scan_fwd"]["max_abs_err"] = max(
            [rows["dec_scan_fwd"]["max_abs_err"]]
            + [float((got[k] - want[k]).abs().max()) for k in RESIDUALS]
            + [float((rk[k] - rp[k]).abs().max()) for k in RESIDUALS])
        rows["dec_scan_bwd"]["max_abs_err"] = max(
            [rows["dec_scan_bwd"]["max_abs_err"]]
            + [float((a.float() - b.float()).abs().max()) for a, b in zip(gk, gp)])
        print(f"dec_scan bf16 {label}: ok, relative errors "
              + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))
        for kind, call, plain in (
                ("fwd", lambda: dec_scan_fwd(*inputs, weights, impl="kernel"),
                 lambda: dec_scan_fwd_plain(*inputs, weights)),
                ("bwd", lambda: dec_scan_bwd(rp, xg_t, ctx, ctxp, mask,
                                             weights, g_t, impl="kernel"),
                 lambda: dec_scan_bwd_plain(rp, xg_t, ctx, ctxp, mask,
                                            weights, g_t))):
            cold, warm = _grid_ms(torch, call, **kw)
            bnd = _dec_scan_bf16_bound(kind, *shape)
            f = {"B": shape[0], "T": shape[1], "Tt": shape[2], "grid_ms": cold,
                 "grid_warm_ms": warm, "bound_ms": bnd[0], "bound_by": bnd[1],
                 "grids_warm_ms": _profile_grids(torch, call, 5)}
            timed = ((lambda tm: dec_scan_fwd(*inputs, weights, impl="kernel",
                                              timers=tm)) if kind == "fwd" else
                     (lambda tm: dec_scan_bwd(rp, xg_t, ctx, ctxp, mask,
                                              weights, g_t, impl="kernel",
                                              timers=tm)))
            f["phases_ms"] = _dec_scan_phases(torch, timed, kind, shape[2])
            if kind == "fwd":
                f["replay_grid_ms"], f["replay_grid_warm_ms"] = _grid_ms(
                    torch, lambda: dec_scan_fwd(*inputs, weights, impl="kernel",
                                                states=states), **kw)
            if label == "train":
                f["ms"] = _time_ms(torch, call, reps=10)
                f["plain_ms"] = _time_ms(torch, plain, reps=3)
            rows[f"dec_scan_{kind}"]["shapes"][label] = f
            print(f"dec_scan_{kind} bf16 {label}: " + json.dumps(f))

    out = []
    for name, src, line in (("gru_fwd", "gru_fwd", "pallas_gru.py:114"),
                            ("gru_bwd", "gru_bwd", "pallas_gru.py:180"),
                            ("dec_scan_fwd", "dec_scan_fwd", "pallas_dec_scan.py:165"),
                            ("dec_scan_bwd", "dec_scan_bwd", "pallas_dec_scan.py:286")):
        r = rows[name]
        tr = r["shapes"]["train"]
        out.append({"name": f"{name}_bf16", "route": "cuda",
                    "source": f"vag_nmt_tpu_torch/csrc/{src}.cu (-DVAG_BF16=1)",
                    "replaces": f"vag_nmt_tpu/ops/{line}",
                    "max_abs_err": r["max_abs_err"], "ms": tr["ms"],
                    "plain_ms": tr["plain_ms"], "bound_ms": tr["bound_ms"],
                    "bound_by": tr["bound_by"],
                    "library_ms": tr.get("library_ms"),
                    "grid_ms": tr["grid_ms"], "grid_warm_ms": tr["grid_warm_ms"],
                    "shapes": r["shapes"]})
    return out


def phase_main(torch, np, dev):
    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.ops.gru_kernel import gru_fwd
    from vag_nmt_tpu_torch.ops.readout_topk import readout_topk_rows

    cfg, params, examples, vocab, img_table = _main_corpus(torch, np, dev)

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


# Phase 8c: training in bf16 (model.compute_dtype="bfloat16", the
# reference's training regime) beside phase 8's fp32 run: the same corpus,
# preset and steps through train_loop. Kernels against plain, first from
# the same params (the init) on each of the N_COMPARE_STEPS batches, which
# run other length buckets: loss, grad norm and the clipped grads (the norm
# of their difference over theirs) within BF16_TRAIN_RTOL, each param's
# grads within BF16_RTOL of its largest (only the sums' order differs, and
# a bf16 rounding of an activation may go one ulp, 2^-8, the other way).
# Then N_COMPARE_STEPS steps in turn from the init: every loss within
# BF16_TRAIN_RTOL, the later grad norms within BF16_NORM_RTOL: Adam's first
# step moves a param by lr * g / (|g| + eps), so where a grad changed sign
# between the two runs their params part by up to 2 lr, and the norms drift
# further apart each step. On an H100 80GB HBM3: from the init, the grads
# 4.7e-4 to 8.1e-4 apart, every batch; after step 1, 2136 of 16.7M grad
# elements of opposite sign and 97 params more than lr apart; the norms
# 1e-6, 4.3e-3, 4.5e-4, 5.6e-3, 1.09e-2 apart over five steps.
BF16_TRAIN_RTOL = 1e-3
BF16_NORM_RTOL = 5e-2


def _bf16_backward_per_batch(torch, vt, cfg, plain_cfg, state0, batches,
                             table):
    """One step from ``state0`` on each batch through the kernels and
    through the plain versions: loss, grad norm and the clipped grads
    (Adam's first moment after one step, (1 - b1) times the clipped grad)
    within BF16_TRAIN_RTOL, each leaf's max |difference| within BF16_RTOL
    of its max |grad|. Prints each batch's target shape and relative
    differences (grads: the norm of the difference over theirs, and the
    largest leaf's max |difference| over its max |grad|), and for the first
    batch the grad elements whose sign differs between the two and the
    elements of the params after the step that differ by more than lr."""
    from vag_nmt_tpu_torch.train.state import tree_leaves

    def flat(tree):
        return torch.cat([x.flatten() for x in tree_leaves(tree)])

    step_k = vt.make_train_step(cfg, with_img_table=True)
    step_p = vt.make_train_step(plain_cfg, with_img_table=True)
    lr = float(state0.lr)
    for i, b in enumerate(batches):
        sk, ak = step_k(state0, b, table)
        sp, ap = step_p(state0, b, table)
        rel = {k: float((ak[k] - ap[k]).abs() / ap[k].abs())
               for k in ("loss", "grad_norm")}
        mk, mp = flat(sk.mu), flat(sp.mu)
        rel["grads"] = float((mk - mp).norm() / mp.norm())
        rel["grads_leaf_max"] = max(
            float((a - c).abs().max() / c.abs().max())
            for a, c in zip(tree_leaves(sk.mu), tree_leaves(sp.mu))
            if float(c.abs().max()) > 0)
        print(f"bf16 backward from the init, batch {i} (tgt "
              f"{tuple(b['tgt'].shape)}): kernels vs plain relative "
              + json.dumps({k: float(f"{v:.3g}") for k, v in rel.items()})
              + f" (tolerance {BF16_TRAIN_RTOL}, grads_leaf_max {BF16_RTOL})")
        if i == 0:
            flips = int(((mk > 0) & (mp < 0) | (mk < 0) & (mp > 0)).sum())
            dp = (flat(sk.params) - flat(sp.params)).abs()
            print(f"bf16 step 1: {flips} of {mk.numel()} grad elements change "
                  f"sign between kernels and plain; {int((dp > lr).sum())} "
                  f"params differ by more than lr = {lr:g} after the step "
                  f"(largest {float(dp.max()) / lr:.3g} lr)")
        if not (max(rel["loss"], rel["grad_norm"], rel["grads"]) <= BF16_TRAIN_RTOL
                and rel["grads_leaf_max"] <= BF16_RTOL):
            raise AssertionError(f"bf16 backward, batch {i}: kernels and plain "
                                 f"differ: {rel}")


def phase_train_bf16(torch, np, dev):
    """train_loop at compute_dtype="bfloat16" on phase 8's corpus and
    preset: steps/s, target tokens/s, the first and last loss (it must
    fall), each kernel's launches and grids a step read from this run
    alone, and the bf16 instances' launches (every one of kernels 2-5 must
    run in bf16, none in fp32; a replay of the forward scan for each
    backward one); then one step from the init on each of the first
    N_COMPARE_STEPS batches through the kernels and through the plain
    versions (_bf16_backward_per_batch); then N_COMPARE_STEPS steps through the
    kernels and through the plain versions; then two steps with
    VAG_GRU_STREAM=fp32, which must run the fp32 instances only. Returns
    (bf16 launches by instance, launches, grids, a profiled closure)."""
    import os
    from pathlib import Path

    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.core.config import SPECIALS
    from vag_nmt_tpu_torch.data.batching import BucketBatcher
    from vag_nmt_tpu_torch.data.vocab import Vocab
    from vag_nmt_tpu_torch.train.loop import _step_rows

    cfg = vt.preset("m30k_ende_vag").replace(
        model=dict(compute_dtype="bfloat16"),
        train=dict(eval_every_steps=N_TRAIN_STEPS,
                   log_every_steps=N_TRAIN_STEPS - 1))
    m = cfg.model
    train = _train_corpus(np, m, N_TRAIN_PAIRS, seed=8)
    dev_set = _train_corpus(np, m, N_DEV_PAIRS, seed=9)
    vocab = Vocab(list(SPECIALS) + [f"t{i}" for i in range(m.tgt_vocab_size - 4)])
    refs = [" ".join(vocab.itos[t] for t in ex.tgt) for ex in dev_set]
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_train_bf16"
    shutil.rmtree(out_dir, ignore_errors=True)
    wrappers = _cli_wrappers()
    scans = ("gru_fwd", "gru_bwd", "dec_scan_fwd", "dec_scan_bwd")

    def zero():
        for fn in wrappers.values():
            fn.launches = fn.grids = 0
        for n in scans:
            wrappers[n].bf16_launches = 0
        wrappers["dec_scan_fwd"].replays = 0

    zero()
    t0 = time.perf_counter()
    final = vt.train_loop(cfg, str(out_dir), train, dev_set, vocab, refs,
                          max_steps=N_TRAIN_STEPS, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in wrappers.items() if fn.launches}
    grids = {n: fn.grids for n, fn in wrappers.items() if fn.grids}
    bf16 = {f"{n}_bf16": wrappers[n].bf16_launches for n in scans}
    replays = wrappers["dec_scan_fwd"].replays
    recs = [json.loads(line) for line in open(out_dir / "metrics.jsonl")]
    rows = [r for r in recs if r["tag"] == "train"]
    first, last = rows[0], rows[-1]
    if final["steps"] != N_TRAIN_STEPS or last["step"] != N_TRAIN_STEPS:
        raise AssertionError(f"bf16 train_loop ran {final['steps']} steps")
    saved = json.loads((out_dir / cfg.train.checkpoint_dir
                        / "meta_last.json").read_text())
    if saved.get("compute_dtype") != "bfloat16":
        raise AssertionError("the bf16 run dir does not record its dtype")
    # every training scan in bf16: as many bf16 forward scans as backward
    # ones (the dev eval's fp32 decode adds gru_fwd's other launches)
    for n in scans:
        want = launches["gru_bwd"] if n == "gru_fwd" else launches[n]
        if not bf16[f"{n}_bf16"] or bf16[f"{n}_bf16"] != want:
            raise AssertionError(f"bf16 training: {n} launched {launches[n]} "
                                 f"times, {bf16[f'{n}_bf16']} in bf16")
    # each backward scan replays the forward from the saved bf16 states
    if replays != launches["dec_scan_bwd"]:
        raise AssertionError(f"bf16 training: {replays} replays for "
                             f"{launches['dec_scan_bwd']} backward scans")
    batcher = BucketBatcher(train, cfg.data.batch_size, cfg.data.length_buckets,
                            seed=cfg.data.shuffle_seed, image_ids=True,
                            img_dim=m.img_feat_dim, compact=True)
    batches, epoch = [], 0
    while len(batches) < N_TRAIN_STEPS:
        batches += list(_step_rows(batcher.epoch_stacked(
            epoch, cfg.train.steps_per_dispatch), 0))
        epoch += 1
    batches = batches[:N_TRAIN_STEPS]
    tokens = sum(float((((b["tgt_len"] >= 0) * (b["tgt_len"] + 1))
                        * b["sample_mask"]).sum()) for b in batches[1:])
    step_s = last["step_time_s"]
    losses = (first["loss"], last["loss"])
    print(f"train path bf16 (kernels): wall_s={wall_s:.2f} "
          f"steps_per_sec={1.0 / step_s:.3f} "
          f"tgt_tokens_per_sec={tokens / (step_s * (N_TRAIN_STEPS - 1)):.1f} "
          f"first_loss={first['loss']:.5f} last_loss={last['loss']:.5f} "
          f"dev_bleu={final.get('dev_bleu')} launches={launches} "
          f"launches_per_step={json.dumps({n: v / N_TRAIN_STEPS for n, v in launches.items()})} "
          f"grids_per_step={sum(grids.values()) / N_TRAIN_STEPS:.2f} "
          f"bf16_instance_launches={bf16} dec_scan_fwd_replays={replays}")
    if not all(np.isfinite(losses)) or not last["loss"] < first["loss"]:
        raise AssertionError(f"bf16 loss did not fall: {losses}")
    shutil.rmtree(out_dir, ignore_errors=True)

    state0 = vt.create_train_state(
        cfg, torch.Generator().manual_seed(cfg.train.seed), device=dev)
    table = vt.build_img_table(train, m.img_feat_dim, device=dev)
    plain_cfg = cfg.replace(model=dict(gru_impl="xla", dec_scan_impl="xla"))
    _bf16_backward_per_batch(torch, vt, cfg, plain_cfg, state0,
                             batches[:N_COMPARE_STEPS], table)

    def run(c, bs):
        step = vt.make_train_step(c, with_img_table=True)
        st, out = state0, []
        for b in bs:
            st, aux = step(st, b, table)
            out.append(torch.stack([aux["loss"], aux["grad_norm"]]))
        return torch.stack(out).cpu(), st

    got, st_end = run(cfg, batches[:N_COMPARE_STEPS])
    want, _ = run(plain_cfg, batches[:N_COMPARE_STEPS])
    rel = ((got - want).abs() / want.abs())
    first, losses, norms = (float(rel[0].max()), float(rel[:, 0].max()),
                            float(rel[1:, 1].max()))
    print(f"train bf16 kernels vs plain over {N_COMPARE_STEPS} steps: losses "
          f"{got[:, 0].tolist()} vs {want[:, 0].tolist()}, grad norms "
          f"{got[:, 1].tolist()} vs {want[:, 1].tolist()}, relative diff: "
          f"first step {first:.3g}, losses {losses:.3g} (tolerance "
          f"{BF16_TRAIN_RTOL}), later grad norms {norms:.3g} (tolerance "
          f"{BF16_NORM_RTOL})")
    if not (first <= BF16_TRAIN_RTOL and losses <= BF16_TRAIN_RTOL
            and norms <= BF16_NORM_RTOL):
        raise AssertionError("bf16 kernel and plain training differ: "
                             f"{first}, {losses}, {norms}")

    zero()
    os.environ["VAG_GRU_STREAM"] = "fp32"
    try:
        run(cfg, batches[:2])
    finally:
        os.environ.pop("VAG_GRU_STREAM", None)
    fp32_stream = {n: (wrappers[n].launches, wrappers[n].bf16_launches)
                   for n in scans}
    print(f"train bf16 with VAG_GRU_STREAM=fp32 (2 steps): (launches, bf16 "
          f"instance launches) {json.dumps(fp32_stream)}")
    if any(b or not a for a, b in fp32_stream.values()):
        raise AssertionError("VAG_GRU_STREAM=fp32 did not run the fp32 "
                             "instances alone")

    step = vt.make_train_step(cfg, with_img_table=True)

    def profiled():
        st = st_end
        for b in batches[N_COMPARE_STEPS:N_COMPARE_STEPS + N_PROFILE_STEPS]:
            st, _ = step(st, b, table)
        return N_PROFILE_STEPS

    return bf16, launches, grids, profiled


def _split_cases(torch, np, dev):
    """Exactness cases of the split top-K kernels (6, 8 and 9) beyond the
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


# phase_dec_step's ragged shape (B, K, T, H, A, C, R): widths and batch
# that fill no tile, an empty depth split; and its shape of widths that
# are no multiples of 4, whose rows the kernel copies 4 bytes at a time.
DEC_STEP_RAGGED = (12, 3, 13, 96, 96, 192, 64)
DEC_STEP_ODD = (12, 3, 13, 94, 90, 190, 62)


def _misaligned(torch, x):
    """x's values in a contiguous tensor that starts 4 bytes past a 16-byte
    boundary (the kernels' 16-byte copies need aligned rows)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _dec_step_full(K: int = 5, B: int = 128):
    """(B, K, T, H, A, C, R) at the full width of m30k_ende_vag, T = 32."""
    import vag_nmt_tpu_torch as vt

    m = vt.preset("m30k_ende_vag").model
    return (B, K, 32, m.dec_hidden_dim, m.attn_dim, m.ctx_dim, m.emb_dim)


def _dec_step_bound(B, K, T, H, A, C, R, weights):
    """Kernel 7's bound (ms, by, the fp32 bound ms): its four products run
    as three TF32 products each on the tensor cores (3xTF32) at the TF32
    peak, the attention's energies (add, tanh, multiply-add by va) and
    context multiply-adds on the fp32 cores; its bytes are the weights and
    inputs read once and s', t written once. Without the tensor cores the
    products would run at the fp32 peak (the fp32 bound)."""
    from vag_nmt_tpu_torch.core.flops import (H100_HBM_BYTES_PER_S,
                                              H100_PEAK_FP32_FLOPS,
                                              H100_PEAK_TF32_FLOPS)

    N = B * K
    gemm = 2.0 * N * (H * 3 * H + H * (A + 3 * H) + C * (3 * H + R) + H * R)
    att = N * T * (4.0 * A + 2.0 * C)
    nbytes = 4.0 * (sum(w.numel() for w in weights) + N * (3 * H + R)
                    + N * H + B * T * (C + A + 1) + N * (H + R))
    t_ops = (3 * gemm / H100_PEAK_TF32_FLOPS + att / H100_PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    fp32_ms = max((gemm + att) / H100_PEAK_FP32_FLOPS * 1e3, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, fp32_ms


def _profile_grids(torch, run, calls: int, exclude=()):
    """Device ms per call of each kernel name that run() enqueues (called
    ``calls`` times under torch.profiler), names in ``exclude`` left out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in exclude:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return out


def dec_step_grid_times(torch, np, dev):
    """Kernel 7's whole call, its device work alone, cold (L2 flushed) and
    warm (_grid_ms) through the wrapper, at full width, (B, K, T) = (128,
    5, 32); beside it the four products through torch.mm in fp32 (TF32
    off), the GEMM share of the same work, and an empty device op; and each
    grid's device ms a call from torch.profiler, cold (each call after the
    flush, whose own kernels are left out) and warm. Through the wrapper of
    whichever vag_nmt_tpu_torch is first on sys.path."""
    from vag_nmt_tpu_torch.ops.dec_step import dec_step

    shape = _dec_step_full()
    B, K, T, H, A, C, R = shape
    N = B * K
    inputs, weights = _dec_step_case(torch, np, dev, *shape, seed=12)
    kw = {"hold": READOUT_HOLD, "warm_hold": READOUT_WARM_HOLD}
    call = lambda: dec_step(*inputs, weights, impl="kernel")  # noqa: E731
    cold, warm = _grid_ms(torch, call, **kw)
    floor_ms = _grid_ms(torch, lambda: torch.cuda._sleep(0))[0]
    # the four products at the call's shapes: s @ uh1, s~ @ w_s, c @ w_c,
    # s' @ ws (s stands in for s~ and s')
    s = inputs[1]
    c = torch.from_numpy(np.random.RandomState(13).randn(N, C).astype(
        np.float32)).to(dev)
    prods = [(s, weights[0]), (s, weights[2]), (c, weights[5]), (s, weights[7])]
    outs = [torch.empty((N, w.shape[1]), dtype=torch.float32, device=dev)
            for _, w in prods]

    def gemms():
        for (a, w), o in zip(prods, outs):
            torch.mm(a, w, out=o)

    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        addmm = _grid_ms(torch, gemms, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def flushed():
        flush.sum()
        torch.cuda._sleep(HOLD_CYCLES)

    def cold_call():
        flushed()
        call()

    exclude = set(_profile_grids(torch, flushed, 1))
    bound_ms, bound_by, fp32_ms = _dec_step_bound(*shape, weights)
    out = {"B": B, "K": K, "T": T, "H": H, "A": A, "C": C, "R": R,
           "grid_ms": cold, "grid_warm_ms": warm,
           "addmm_grid_ms": addmm[0], "addmm_grid_warm_ms": addmm[1],
           "grid_floor_ms": floor_ms,
           "grids_cold_ms": _profile_grids(torch, cold_call, 20, exclude),
           "grids_warm_ms": _profile_grids(torch, call, 20),
           "bound_ms": bound_ms, "bound_by": bound_by, "fp32_bound_ms": fp32_ms,
           "grid_bound_share": bound_ms / cold}
    print(f"dec_step grid (B={B}, K={K}, T={T}): " + json.dumps(out))
    return out


def phase_dec_step(torch, np, dev):
    """dec_step against dec_step_plain at full width, at a ragged shape, at
    widths that are no multiples of 4, at the ragged shape with every input
    and weight 4 bytes off a 16-byte boundary, at K = 1 and at B = 1
    (DEC_STEP_RTOL), a second call bit for bit as the first; then the call
    timed alone (dec_step_grid_times) and through the wrapper."""
    from vag_nmt_tpu_torch.ops.dec_step import dec_step, dec_step_plain

    full = _dec_step_full()
    cases = {"full": full, "ragged": DEC_STEP_RAGGED, "odd": DEC_STEP_ODD,
             "misaligned": DEC_STEP_RAGGED, "k1": _dec_step_full(K=1),
             "b1": _dec_step_full(B=1)}
    max_abs = 0.0
    for label, shape in cases.items():
        inputs, weights = _dec_step_case(torch, np, dev, *shape, seed=11)
        if label == "misaligned":
            inputs, weights = ([_misaligned(torch, x) for x in xs]
                               for xs in (inputs, weights))
        got = dec_step(*inputs, weights, impl="kernel")
        again = dec_step(*inputs, weights, impl="kernel")
        want = dec_step_plain(*inputs, weights)
        torch.cuda.synchronize()
        errs = {n: _rel_err(a, b) for n, a, b in zip(("s_new", "t"), got, want)}
        if not max(errs.values()) <= DEC_STEP_RTOL:
            raise AssertionError(f"dec_step {label} {shape}: relative errors {errs}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"dec_step {label} {shape}: a second call differs")
        max_abs = max([max_abs] + [float((a - b).abs().max())
                                   for a, b in zip(got, want)])
        print(f"dec_step {label} (B, K, T, H, A, C, R)={shape}: ok, relative "
              f"errors {json.dumps(errs)}")

    grid = dec_step_grid_times(torch, np, dev)
    inputs, weights = _dec_step_case(torch, np, dev, *full, seed=12)
    ms = _time_ms(torch, lambda: dec_step(*inputs, weights, impl="kernel"))
    plain_ms = _time_ms(torch, lambda: dec_step_plain(*inputs, weights))
    print(f"dec_step (B, K, T)={full[:3]}: wrapper_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} grid_ms={grid['grid_ms']:.4f} "
          f"bound_ms={grid['bound_ms']:.4f} ({grid['bound_by']})")
    return {"name": "dec_step", "route": "cuda",
            "source": "vag_nmt_tpu_torch/csrc/dec_step.cu",
            "replaces": "vag_nmt_tpu/ops/pallas_dec_step.py:106",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": grid["bound_ms"], "bound_by": grid["bound_by"],
            "library_ms": None,
            **{f: grid[f] for f in ("grid_ms", "grid_warm_ms", "addmm_grid_ms",
                                    "addmm_grid_warm_ms", "grid_floor_ms",
                                    "grids_cold_ms")}}


def _ids_up_to_near_ties(torch, what, t, w, b, got, want) -> int:
    """Kernel 1's top-K ids (R, K) against the plain version's: equal, but
    in rows where they differ the two id lists must hold the same values to
    within READOUT_RTOL when the logits are taken in float64 (the kernel's
    3xTF32 products and the plain fp32 GEMM round differently, so two
    candidates closer than that may trade places). Returns the rows that
    differ."""
    rows = (got != want).any(1).nonzero().flatten()
    if rows.numel() == 0:
        return 0
    lg = t[rows].double() @ w.double() + b.double()   # (rows, V) in float64
    a = torch.gather(lg, 1, got[rows].long())
    c = torch.gather(lg, 1, want[rows].long())
    if not torch.allclose(a, c, rtol=READOUT_RTOL, atol=0.0):
        raise AssertionError(f"{what}: ids differ beyond near ties in rows "
                             f"{rows.tolist()[:8]}")
    print(f"{what}: {rows.numel()} rows differ only among candidates within "
          f"{READOUT_RTOL} of each other (float64 logits)")
    return int(rows.numel())


def _with_tile_rerun(torch, shallow, depth, live, tile_rows):
    """The plain result of a shallow-slot call with the per-step recovery
    as the kernel computes it. The plain version recovers a flagged row at
    depth K only if it is live; the kernel reruns whole row tiles of
    ``tile_rows`` rows (those holding a flagged live row) at depth K, so a
    flagged FROZEN row in such a tile comes out at depth K too (_combine
    discards its outputs). Returns the shallow plain result with those
    rows taken from the depth-K plain result, and how many they are."""
    flagged = shallow[3] > 0
    tile = torch.arange(flagged.numel(), device=flagged.device) // tile_rows
    marked = torch.zeros(int(tile[-1]) + 1, dtype=torch.bool,
                         device=flagged.device)
    marked[tile[flagged & live]] = True
    pick = flagged & ~live & marked[tile]
    return ((torch.where(pick[:, None], depth[0], shallow[0]),
             torch.where(pick[:, None], depth[1], shallow[1]),
             shallow[2], shallow[3]), int(pick.sum()))


# Phase 2b: the K-capped kernels (1, 6, 8, 9, 7) at beam sizes past 8
# (kernels 1 and 7 through their MAX_K = 16 instance), beside K = 5 (the
# beam-5 instance), and past 16: kernels 1, 6, 8 and 9 in passes of 16
# (ops/topk.k_plan), kernel 7 with its attention in groups of 16 beams.
# WIDE_OVER_V puts K above V, where every top-K wrapper raises.
WIDE_BEAMS = (5, 12, 16, 20, 32)
WIDE_OVER_V = (20, 16)          # (K, V)
WIDE_B, WIDE_E, WIDE_V = 128, 256, 8000


def phase_wide_beams(torch, np, dev):
    """At each K of WIDE_BEAMS: kernel 1 at (R = 128 K, E = 256, V = 8000)
    at depth K, at slot depth 3 with the per-step recovery (1') and through
    fused_readout_topk against the plain version (ids exact, or among
    candidates within READOUT_RTOL of each other in float64; values to
    READOUT_RTOL; exact on integer inputs); kernels 6, 8, 9 at (128, K,
    8000) exactly; kernel 7 at (128, K, 32) full width within
    DEC_STEP_RTOL; each grid timed alone, cold and warm, with the passes
    (or beam groups) each wrapper counted. Then K above V through each
    top-K wrapper: ValueError from the kernel route, and no launch.
    {K: fields}."""
    from vag_nmt_tpu_torch.ops import dec_step as ds
    from vag_nmt_tpu_torch.ops import readout_topk as rt
    from vag_nmt_tpu_torch.ops import topk

    B, E, V = WIDE_B, WIDE_E, WIDE_V
    counted = {"readout_topk": rt.readout_topk_rows, "beam_topk": topk.beam_topk,
               "legacy_topk_blocks": topk.legacy_topk_blocks,
               "legacy_topk_rows": topk.legacy_topk_rows}
    out = {}
    for K in WIDE_BEAMS:
        rng = np.random.RandomState(300 + K)
        R = B * K
        before = {n: fn.passes for n, fn in counted.items()}
        groups0 = ds.dec_step.beam_groups

        def cuda(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        t = cuda(np.tanh(rng.randn(R, E)).astype(np.float32))
        w = cuda((0.05 * rng.randn(E, V)).astype(np.float32))
        b = cuda((0.1 * rng.randn(V)).astype(np.float32))
        scores = cuda(rng.randn(B, K).astype(np.float32))
        fin = cuda(rng.rand(B, K) < 0.2)
        live = ~fin.reshape(-1)
        f = {"K": K, "instance": topk.instance("readout_topk", K),
             "passes": topk.k_plan(K)[1]}
        got = rt.readout_topk_rows(t, w, b, K, impl="kernel")
        want = rt.readout_topk_rows_plain(t, w, b, K)
        sgot = rt.readout_topk_rows(t, w, b, K, slots=3, recover_live=live,
                                    impl="kernel")
        swant = rt.readout_topk_rows_plain(t, w, b, K, slots=3,
                                           recover_live=live)
        fk = rt.fused_readout_topk(t, w, b, scores, fin, impl="kernel")
        fp = rt.fused_readout_topk(t, w, b, scores, fin, impl="plain")
        torch.cuda.synchronize()
        swant, f["tile_rerun_rows"] = _with_tile_rerun(torch, swant, want, live,
                                                       rt._ROW_TILE)
        err, f["near_tie_rows"] = 0.0, 0
        for label, g, p in (("depth K", got, want), ("slots 3", sgot, swant)):
            f["near_tie_rows"] += _ids_up_to_near_ties(
                torch, f"readout_topk K={K} {label}", t, w, b, g[1], p[1])
            for a, c in zip((g[0], g[2]), (p[0], p[2])):
                if not torch.allclose(a, c, rtol=READOUT_RTOL, atol=0.0):
                    raise AssertionError(f"readout_topk K={K} {label}: off by "
                                         f"{float((a - c).abs().max())}")
                err = max(err, float((a - c).abs().max()))
        if not torch.equal(sgot[3], swant[3]):
            raise AssertionError(f"readout_topk K={K} slots 3: viol differs")
        if not torch.allclose(fk[0], fp[0], rtol=READOUT_RTOL, atol=0.0):
            raise AssertionError(f"fused_readout_topk K={K}: values differ")
        # integer inputs: every logit exact, so the ids are too (depth K,
        # and the shallow slots with their flags and recovery)
        ti = cuda(rng.randint(-3, 4, (R, E)).astype(np.float32))
        wi = cuda(rng.randint(-3, 4, (E, V)).astype(np.float32))
        bi = cuda(rng.randint(-3, 4, V).astype(np.float32))
        di = rt.readout_topk_rows_plain(ti, wi, bi, K)
        for kw in ({}, {"slots": 3, "recover_live": live}):
            gi = rt.readout_topk_rows(ti, wi, bi, K, impl="kernel", **kw)
            pi = rt.readout_topk_rows_plain(ti, wi, bi, K, **kw)
            if kw:
                pi, _ = _with_tile_rerun(torch, pi, di, live, rt._ROW_TILE)
            if not (torch.equal(gi[0], pi[0]) and torch.equal(gi[1], pi[1])
                    and torch.allclose(gi[2], pi[2], rtol=READOUT_RTOL, atol=0.0)
                    and (not kw or torch.equal(gi[3], pi[3]))):
                raise AssertionError(f"readout_topk K={K} integer {kw.keys()}: "
                                     "top-K not exact or lse off")
        kw = {"hold": READOUT_HOLD, "warm_hold": READOUT_WARM_HOLD}
        f["readout_topk"] = dict(zip(("grid_ms", "grid_warm_ms"), _grid_ms(
            torch, lambda: rt.readout_topk_rows(t, w, b, K, impl="kernel"),
            **kw)), max_abs_err=err, R=R,
            bound_ms=_readout_bound(R, E, V, K, slots=False)[0])
        f["readout_topk"]["slots3_grid_ms"], _ = _grid_ms(
            torch, lambda: rt.readout_topk_rows(t, w, b, K, slots=3,
                                                impl="kernel"), **kw)

        logits = cuda((3.0 * rng.randn(B, K, V)).astype(np.float32))
        fin2 = cuda(rng.rand(B, K) < 0.2)
        for name, fn, plain in (
                ("beam_topk", topk.beam_topk, topk.beam_topk_plain),
                ("legacy_topk_blocks", topk.legacy_topk_blocks,
                 topk.legacy_topk_blocks_plain),
                ("legacy_topk_rows", topk.legacy_topk_rows,
                 topk.legacy_topk_rows_plain)):
            g = fn(logits, scores, fin2, impl="kernel")
            p = plain(logits, scores, fin2)
            # integer logits: ties everywhere, still exact
            li = torch.round(logits)
            gi, pi = fn(li, scores, fin2, impl="kernel"), plain(li, scores, fin2)
            torch.cuda.synchronize()
            if not (torch.equal(g[0], p[0]) and torch.equal(g[1], p[1])
                    and torch.equal(gi[0], pi[0]) and torch.equal(gi[1], pi[1])):
                raise AssertionError(f"{name} K={K}: differs from plain")
            cfn, cargs, _, keep = topk.grid_call(name, logits, scores, fin2)
            cold, warm = _grid_ms(torch, lambda: cfn(*cargs))
            n = B * K * V
            f[name] = {"grid_ms": cold, "grid_warm_ms": warm,
                       "bound_ms": _bound(2.0 * n, 4.0 * n + 17.0 * B * K)[0]}
            if K > topk.MAX_K:
                # yardstick only (never called by the port): torch.topk on
                # the materialized candidates, each sentence's K*V
                cand = topk.candidates(logits, scores, fin2)
                f[name]["library_grid_ms"], f[name]["library_grid_warm_ms"] = \
                    _grid_ms(torch, lambda: torch.topk(cand, K, dim=1))
            del keep

        shape = _dec_step_full(K=K)
        inputs, weights = _dec_step_case(torch, np, dev, *shape, seed=K)
        got = ds.dec_step(*inputs, weights, impl="kernel")
        want = ds.dec_step_plain(*inputs, weights)
        torch.cuda.synchronize()
        errs = {n: _rel_err(a, c) for n, a, c in zip(("s_new", "t"), got, want)}
        if not max(errs.values()) <= DEC_STEP_RTOL:
            raise AssertionError(f"dec_step K={K}: relative errors {errs}")
        cold, warm = _grid_ms(torch, lambda: ds.dec_step(*inputs, weights,
                                                         impl="kernel"))
        f["dec_step"] = {"grid_ms": cold, "grid_warm_ms": warm,
                         "rel_err": max(errs.values()),
                         "bound_ms": _dec_step_bound(*shape, weights)[0]}
        f["counted_passes"] = {n: fn.passes - before[n]
                               for n, fn in counted.items()}
        f["counted_beam_groups"] = ds.dec_step.beam_groups - groups0
        more = K > topk.MAX_K
        if more != all(f["counted_passes"].values()) or \
                more != bool(f["counted_beam_groups"]):
            raise AssertionError(f"K={K}: passes / beam groups counted "
                                 f"{f['counted_passes']} "
                                 f"{f['counted_beam_groups']}")
        out[K] = f
        print(f"wide beams K={K}: ok " + json.dumps(f))

    K, V = WIDE_OVER_V
    rng = np.random.RandomState(400)
    t = torch.from_numpy(np.tanh(rng.randn(4 * K, 64)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(64, V).astype(np.float32)).to(dev)
    b = torch.zeros(V, device=dev)
    logits = torch.from_numpy(rng.randn(4, K, V).astype(np.float32)).to(dev)
    scores = torch.zeros((4, K), device=dev)
    fin = torch.zeros((4, K), dtype=torch.bool, device=dev)
    calls = {"readout_topk": functools.partial(rt.readout_topk_rows, t, w, b, K)}
    for name in ("beam_topk", "legacy_topk_blocks", "legacy_topk_rows"):
        calls[name] = functools.partial(getattr(topk, name), logits, scores, fin)
    launched = {name: counted[name].launches for name in calls}
    for name, call in calls.items():
        for impl in ("auto", "kernel"):
            try:
                call(impl=impl)
            except ValueError as e:
                if "outside 1.." not in str(e):
                    raise
            else:
                raise AssertionError(f"{name} K={K} > V={V} impl={impl}: no raise")
    if launched != {name: counted[name].launches for name in calls}:
        raise AssertionError(f"K={K} > V={V}: a kernel launched")
    print(f"wide beams K={K} > V={V}: every top-K kernel route raised "
          f"ValueError, no launch")
    return out


# Phase 3b: gru_fwd at widths the H = 512 plan does not cover, against the
# plain version within GRU_ATOL: H = 94 (zero-padded to 96), 1280 and 2048
# (Uh's slices in L2), B = 64 and the decode super chunk's 1024 rows.
GRU_WIDTHS = ((94, 64, 24), (1280, 64, 24), (2048, 64, 24), (2048, 1024, 32))


def phase_gru_widths(torch, np, dev):
    """gru_fwd at GRU_WIDTHS (both directions) against gru_fwd_plain, its
    plan, and at H = 2048 its grid alone cold and warm with its bound."""
    from vag_nmt_tpu_torch.ops.gru_kernel import (_device_limits, gru_fwd,
                                                  gru_fwd_plain, gru_fwd_plan,
                                                  padded_width)

    out = []
    for H, B, T in GRU_WIDTHS:
        rng = np.random.RandomState(H + B)

        def cuda(a):
            return torch.from_numpy(a.astype(np.float32)).to(dev)

        xg_t = cuda(rng.randn(T, B, 3 * H))
        uh = cuda(rng.randn(H, 3 * H) * (0.6 / np.sqrt(H)))
        bh = cuda(0.1 * rng.randn(3 * H))
        h0 = cuda(0.5 * rng.randn(B, H))
        lens = rng.randint(1, T + 1, B)
        lens[0] = T
        mask_t = cuda((np.arange(T)[:, None] < lens[None, :]))
        err = 0.0
        for reverse in (False, True):
            hk = gru_fwd(xg_t, mask_t, uh, bh, h0, reverse=reverse,
                         impl="kernel")
            hp = gru_fwd_plain(xg_t, mask_t, uh, bh, h0, reverse=reverse)
            torch.cuda.synchronize()
            err = max(err, float((hk - hp).abs().max()))
        if not err <= GRU_ATOL:
            raise AssertionError(f"gru_fwd H={H} (B={B}, T={T}): max abs "
                                 f"err {err}")
        plan = gru_fwd_plan(B, padded_width(H), *_device_limits(dev))
        f = {"H": H, "B": B, "T": T, "max_abs_err": err,
             "padded_H": padded_width(H),
             "plan": {"grid": list(plan.grid), "l2": plan.l2,
                      "row_block": plan.row_block,
                      "unit_block": plan.unit_block, "chunk": plan.chunk,
                      "passes": plan.passes, "smem_bytes": plan.smem_bytes}}
        if H == 2048:
            cold, warm = _grid_ms(torch, lambda: gru_fwd(
                xg_t, mask_t, uh, bh, h0, impl="kernel"))
            f["bound_ms"], f["bound_by"] = _bound(
                2.0 * T * B * H * 3 * H,
                4.0 * (T * B * 3 * H + T * B + H * 3 * H + 3 * H + B * H
                       + T * B * H))
            f["grid_ms"], f["grid_warm_ms"] = cold, warm
        out.append(f)
        print(f"gru_fwd width H={H} (B={B}, T={T}) both directions: ok "
              + json.dumps(f))
    return out


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
    each follow their own rule and differ; then both on the split cases of
    _split_cases (the boundary ties lie in one 512-block, where gen 1's
    order is the flat one)."""
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
    split_cases = _split_cases(torch, np, dev)
    for name, fn, plain, _, _ in kernels:
        _split_exactness(torch, name, fn, plain, split_cases)

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


def _slots_case(torch, np, dev, kind, R, E, V, seed, bf16=False):
    """Readout inputs whose logits are exact in fp32 whatever the order of
    the sums (multiples of 1/512 below 2^14 / 512), so the kernel and the
    plain version see the same values: ties, watermarks and flags alike;
    "collision" puts every row's five best logits in one kernel lane. With
    bf16, t and w in bf16 (their values are exact there)."""
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

    op = torch.bfloat16 if bf16 else torch.float32
    return cuda(t).to(op), cuda(w).to(op), cuda(b), mask


# Phase 13's shapes (R, V) at E=256: the ikea beam step, and a last row
# tile part full at a V that puts W's rows off 16-byte boundaries.
READOUT_SLOTS_SHAPES = ((640, 16000), (35, 8003))


def _readout_slots_checks(torch, np, dev, R, E, V, K, bf16=False):
    """Phase 13's checks at one shape (phase_readout_slots), on the bf16
    instance with bf16; returns the largest lse error against the plain
    version."""
    from vag_nmt_tpu_torch.ops import readout_topk as rt

    lanes = rt.kernel_lanes(R, V)
    if len(set(lanes[list(LANE_COLLISION)].tolist())) != 1:
        raise AssertionError("LANE_COLLISION ids do not share a kernel lane")
    live = torch.ones(R, dtype=torch.bool, device=dev)
    flagged, max_err = {}, 0.0
    for kind in ("exact", "collision", "ban"):
        t, w, b, mask = _slots_case(torch, np, dev, kind, R, E, V, seed=13,
                                    bf16=bf16)
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
            what = (f"readout_topk{'_bf16' if bf16 else ''} slots={sk} "
                    f"{kind} (R={R}, V={V})")
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
        print(f"readout_topk slots {kind} (R={R}, V={V}): ok, flagged rows "
              f"{ {sk: flagged[(kind, sk)] for sk in READOUT_SLOTS} }")
    return max_err


def phase_readout_slots(torch, np, dev):
    """Kernel 1's shallow-slot watermark mode at E=256 and each (R, V) of
    READOUT_SLOTS_SHAPES for each slot depth of READOUT_SLOTS, against its
    plain version under the kernel's own lane map and against the depth-K
    kernel: every row's viol as the plain version's; vals, ids, lse as the
    plain version's (exact logits) and, on every row that is not flagged,
    bit for bit as depth K's; the per-step recovery equal to depth K on
    every row and its counter; then, at the first shape, the deferred live
    flag, which all-frozen rows never arm."""
    from vag_nmt_tpu_torch.ops import readout_topk as rt

    E, K = 256, 5
    max_err = 0.0
    for R, V in READOUT_SLOTS_SHAPES:
        max_err = max(max_err, _readout_slots_checks(torch, np, dev, R, E, V, K))
    R, V = READOUT_SLOTS_SHAPES[0]
    live = torch.ones(R, dtype=torch.bool, device=dev)
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
    bound_ms, bound_by = _readout_bound(R, E, V, K, slots=True)
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
    _recovery_marks(torch, envs["b"], run, out["b"][0])
    for mode in ("a", "b", "f", "g", "h"):
        phase_profile(torch, f"ikea ({mode}) (beam steps)",
                      lambda: _with_env(envs[mode], run)[1]["beam_loop_steps"])
    pick = {"legacy_topk_blocks": ("f", "legacy_topk_blocks"),
            "legacy_topk_rows": ("g", "legacy_topk_rows"),
            "readout_topk_slots": ("b", "readout_topk")}
    return ({k: out[mode][1][w] for k, (mode, w) in pick.items()},
            {k: out[mode][2][w] for k, (mode, w) in pick.items()})


# Row groups of the per-step recovery's marks counted by _recovery_marks:
# the kernel's 64-row tiles and a 32-row alternative.
RECOVERY_GROUPS = (32, 64)


def _recovery_marks(torch, env, run, hyps_b):
    """Mode (b) once more, counting at each per-step recovery the flagged
    live rows, and for each group size of RECOVERY_GROUPS the groups of
    rows that hold one (the kernel marks its 64-row tiles) and the rows
    those groups rerun at depth K. Prints the totals and raises if the
    audited run's recoveries or hypotheses are not (b)'s."""
    from vag_nmt_tpu_torch.ops import readout_topk as rt

    orig = rt.readout_topk_rows
    counts = []

    def counted(t, w, b, k, mask=None, *, slots=0, recover_live=None,
                impl="auto"):
        out = orig(t, w, b, k, mask, slots=slots, recover_live=recover_live,
                   impl=impl)
        if recover_live is not None and len(out) == 4:
            fix = ((out[3] > 0) & recover_live.bool()).to(torch.int64)
            R = fix.shape[0]
            c = [fix.sum(), fix.amax()]
            for g in RECOVERY_GROUPS:
                n = -(-R // g)
                marks = torch.nn.functional.pad(fix, (0, n * g - R)).view(n, g).amax(1)
                rows = (R - g * torch.arange(n, device=fix.device)).clamp(max=g)
                c += [marks.sum(), (marks * rows).sum(),
                      torch.tensor(n, device=fix.device),
                      torch.tensor(R, device=fix.device)]
            counts.append(torch.stack(c))
        return out

    # the kernel's wrapper counts launches; the recovery counter is looked
    # up on the module's readout_topk_rows, here counted
    counted.launches, counted.grids, counted.recoveries = 0, 0, None
    counted.bf16_launches, counted.passes = 0, 0
    rt.readout_topk_rows = counted
    try:
        hyps, _ = _with_env(env, run)
    finally:
        rt.readout_topk_rows = orig
    tot = torch.stack(counts).sum(0).tolist()
    rec = counted.recoveries
    if hyps != hyps_b or rec is None or rec.tolist() != tot[:2]:
        raise AssertionError(f"ikea (b): the audited run differs ({tot[:2]} "
                             f"recoveries counted, {rec} by the kernel)")
    marks = {"calls": len(counts), "flagged_live_rows": tot[0],
             "calls_with_a_flag": tot[1]}
    for i, g in enumerate(RECOVERY_GROUPS):
        marked, rows, groups, all_rows = tot[2 + 4 * i: 6 + 4 * i]
        marks[f"groups{g}"] = {"marked": marked, "of": groups,
                               "rows_rerun": rows, "of_rows": all_rows}
    print("ikea (b) recovery marks: " + json.dumps(marks))


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


# Phase 15: the port's command line on a synthetic Multi30k data directory
# at m30k_ende_vag's width (V = 8000 both sides, 2048-wide features).
CLI_SPLITS = {"train": (2048, 21), "val": (64, 22), "test2016": (512, 23),
              "test2017": (256, 24)}
CLI_TRAIN_STEPS = 20
CLI_BEAMS = (5, 12, 20)


def _cli_wrappers():
    """Every counted kernel wrapper, by kernel name."""
    from vag_nmt_tpu_torch.ops import dec_scan, dec_step, gru_kernel, topk
    from vag_nmt_tpu_torch.ops.readout_topk import readout_topk_rows

    return {"readout_topk": readout_topk_rows, "gru_fwd": gru_kernel.gru_fwd,
            "gru_bwd": gru_kernel.gru_bwd, "dec_scan_fwd": dec_scan.dec_scan_fwd,
            "dec_scan_bwd": dec_scan.dec_scan_bwd,
            "beam_topk": topk.beam_topk, "dec_step": dec_step.dec_step,
            "legacy_topk_blocks": topk.legacy_topk_blocks,
            "legacy_topk_rows": topk.legacy_topk_rows}


def _cli_command(torch, argv, env=None):
    """cli.main(argv) with every kernel's launch count set to 0 before and
    read after: (launches, the last line it printed, seconds). Beside each
    kernel's launches, its bf16 instance's (``<name>_bf16``) and its passes
    above 16 beams (``<name>_passes``) where it counts them."""
    import contextlib
    import io
    import os

    from vag_nmt_tpu_torch import cli

    wrappers = _cli_wrappers()
    extra = ("bf16_launches", "passes")
    for fn in wrappers.values():
        fn.launches = 0
        for a in extra:
            if hasattr(fn, a):
                setattr(fn, a, 0)
    out = io.StringIO()
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    for k, fn in wrappers.items():
        for a, suffix in zip(extra, ("bf16", "passes")):
            if getattr(fn, a, 0):
                launches[f"{k}_{suffix}"] = getattr(fn, a)
    lines = out.getvalue().strip().splitlines()
    return launches, (lines[-1] if lines else ""), secs


def _write_cli_data(np, d, m, splits):
    """A Multi30k-layout data directory: {split}.{en,de} of Zipf tokens
    (vocab units "s<i>" / "t<i>"), vocab.{en,de}.json, {split}_features.npy
    with its .align.json, preprocess.json."""
    from vag_nmt_tpu_torch.core.config import SPECIALS
    from vag_nmt_tpu_torch.data.features import save_features
    from vag_nmt_tpu_torch.data.vocab import Vocab

    src_v = Vocab(list(SPECIALS) + [f"s{i}" for i in range(4, m.src_vocab_size)])
    tgt_v = Vocab(list(SPECIALS) + [f"t{i}" for i in range(4, m.tgt_vocab_size)])
    src_v.save(str(d / "vocab.en.json"))
    tgt_v.save(str(d / "vocab.de.json"))
    for split, (n, seed) in splits.items():
        exs = _train_corpus(np, m, n, seed)
        src = [" ".join(src_v.itos[t] for t in ex.src) for ex in exs]
        (d / f"{split}.en").write_text("".join(s + "\n" for s in src))
        (d / f"{split}.de").write_text("".join(
            " ".join(tgt_v.itos[t] for t in ex.tgt) + "\n" for ex in exs))
        save_features(str(d / f"{split}_features.npy"),
                      np.stack([ex.img for ex in exs]), corpus_lines=src)
    (d / "preprocess.json").write_text(json.dumps(
        {"tokenizer": "simple", "lower": True, "truecase": False}))


def phase_cli(torch, np, dev, preset="m30k_ende_vag", splits=None):
    """The port's command line in this process (cli.main) on a synthetic
    Multi30k data directory at full m30k_ende_vag width: train
    CLI_TRAIN_STEPS steps (a dev eval at the last), translate test2016 at
    each beam of CLI_BEAMS through the kernels and with --impl plain (the
    share of identical hypotheses against MIN_IDENTICAL_SHARE), translate
    --nbest 3, score --meteor, retrieval and translate-text; each command's
    launches of each kernel read from it alone. ``preset`` and
    ``splits`` (CLI_SPLITS) size it, ``dev`` is where it runs (a CPU
    rehearsal launches no kernel and checks none). {command: fields}."""
    from pathlib import Path

    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.data.vocab import Vocab

    splits = splits or CLI_SPLITS
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    data, run = root / "data", root / "run"
    data.mkdir(parents=True)
    m = vt.preset(preset).model
    _write_cli_data(np, data, m, splits)
    out = {}

    def command(label, argv, need=(), env=None):
        launches, last, secs = _cli_command(
            torch, argv + ["--device", dev.type], env)
        missing = [k for k in need if dev.type == "cuda" and not launches.get(k)]
        if missing:
            raise AssertionError(f"cli {label}: {missing} never launched "
                                 f"({launches})")
        out[label] = {"launches": launches, "seconds": secs}
        print(f"cli {label}: {secs:.2f} s, launches {json.dumps(launches)}")
        return last

    res = json.loads(command("train", [
        "train", "--preset", preset, "--data-dir", str(data),
        "--out-dir", str(run), "--set", "data.dataset=multi30k",
        "--max-steps", str(CLI_TRAIN_STEPS),
        "--set", f"train.eval_every_steps={CLI_TRAIN_STEPS}",
        "--set", "train.log_every_steps=10"],
        need=("gru_fwd", "gru_bwd", "dec_scan_fwd", "dec_scan_bwd",
              "readout_topk")))
    if res["steps"] != CLI_TRAIN_STEPS or "dev_bleu" not in res:
        raise AssertionError(f"cli train: {res}")
    ref = str(data / "test2016.de")
    base = ["translate", "--data-dir", str(data), "--checkpoint", str(run),
            "--split", "test2016"]
    for beam in CLI_BEAMS:
        hyps = {}
        for impl in ("auto", "plain"):
            path = root / f"hyp_b{beam}_{impl}.txt"
            need = ("gru_fwd", "readout_topk") if impl == "auto" else ()
            if impl == "auto" and beam > 16:     # kernel 1 in passes
                need += ("readout_topk_passes",)
            st = json.loads(command(f"translate beam {beam} {impl}", base + [
                "--beam", str(beam), "--impl", impl, "--output", str(path)],
                need=need))
            if impl == "plain" and out[f"translate beam {beam} plain"][
                    "launches"]:
                raise AssertionError("cli translate --impl plain launched "
                                     "kernels")
            hyps[impl] = path.read_text().splitlines()
            out[f"translate beam {beam} {impl}"]["sentences_per_sec"] = \
                st["sentences_per_sec"]
        n = splits["test2016"][0]
        if len(hyps["auto"]) != n or not any(hyps["auto"]):
            raise AssertionError(f"cli translate beam {beam}: malformed output")
        share = sum(a == b for a, b in zip(hyps["auto"], hyps["plain"])) / n
        out[f"translate beam {beam} auto"]["identical_share"] = share
        print(f"cli translate beam {beam}: identical hypotheses kernels vs "
              f"plain {share:.4f} (threshold {MIN_IDENTICAL_SHARE})")
        if share < MIN_IDENTICAL_SHARE:
            raise AssertionError(f"cli beam {beam}: only {share:.4f} identical")
    nbest = root / "nbest.txt"
    command("translate nbest 3", base + ["--nbest", "3", "--output", str(nbest)],
            need=("gru_fwd", "readout_topk"))
    rows = [ln.split(" ||| ") for ln in nbest.read_text().splitlines()]
    if len(rows) != 3 * splits["test2016"][0] or any(
            len(r) != 3 for r in rows):
        raise AssertionError("cli translate --nbest 3: malformed n-best list")
    scores = json.loads(command("score", [
        "score", "--hyp", str(root / "hyp_b5_auto.txt"), "--ref", ref,
        "--meteor", "--lang", "de"]))
    if not (0.0 <= scores["bleu"] <= 100.0 and 0.0 <= scores["meteor"] <= 1.0):
        raise AssertionError(f"cli score: {scores}")
    out["score"].update(bleu=scores["bleu"], meteor=scores["meteor"])
    rec = json.loads(command("retrieval", [
        "retrieval", "--data-dir", str(data), "--checkpoint", str(run),
        "--split", "test2017"], need=("gru_fwd",)))
    if not all(0.0 <= v <= splits["test2017"][0] for v in rec.values()):
        raise AssertionError(f"cli retrieval: {rec}")
    out["retrieval"]["recall"] = rec
    lines = (data / "test2017.en").read_text().splitlines()[:128]
    (root / "raw.txt").write_text("".join(s + "\n" for s in lines))
    command("translate-text", [
        "translate-text", "--checkpoint", str(run), "--input",
        str(root / "raw.txt"), "--output", str(root / "raw_hyp.txt")],
        need=("gru_fwd", "readout_topk"))
    if len((root / "raw_hyp.txt").read_text().splitlines()) != len(lines):
        raise AssertionError("cli translate-text: line count")
    command("translate-text dec_step", [
        "translate-text", "--checkpoint", str(run), "--input",
        str(root / "raw.txt"), "--output", str(root / "raw_hyp7.txt")],
        need=("gru_fwd", "readout_topk", "dec_step"),
        env={"VAG_DEC_STEP": "on"})
    # bf16 training (the reference's regime), then that run decoded at fp32
    run16 = root / "run_bf16"
    res = json.loads(command("train bf16", [
        "train", "--preset", preset, "--data-dir", str(data),
        "--out-dir", str(run16), "--set", "data.dataset=multi30k",
        "--max-steps", str(CLI_TRAIN_STEPS),
        "--set", f"train.eval_every_steps={CLI_TRAIN_STEPS}",
        "--set", "train.log_every_steps=10",
        "--set", "model.compute_dtype=bfloat16"],
        need=("gru_fwd_bf16", "gru_bwd_bf16", "dec_scan_fwd_bf16",
              "dec_scan_bwd_bf16", "readout_topk")))
    saved = json.loads((run16 / "config.json").read_text())
    if res["steps"] != CLI_TRAIN_STEPS or \
            saved["model"]["compute_dtype"] != "bfloat16":
        raise AssertionError(f"cli train bf16: {res}")
    path = root / "hyp_bf16_run.txt"
    command("translate bf16 run", [
        "translate", "--data-dir", str(data), "--checkpoint", str(run16),
        "--split", "test2016", "--output", str(path)],
        need=("gru_fwd", "readout_topk"))
    if any(k.endswith("_bf16") for k in out["translate bf16 run"]["launches"]):
        raise AssertionError("the bf16 run's decode ran a bf16 instance")
    if len(path.read_text().splitlines()) != splits["test2016"][0]:
        raise AssertionError("cli translate of the bf16 run: line count")
    # ... and in bf16: kernels 1b and 2b only, the output well formed
    path = root / "hyp_bf16_run_bf16.txt"
    command("translate bf16 run bf16", [
        "translate", "--data-dir", str(data), "--checkpoint", str(run16),
        "--split", "test2016", "--output", str(path),
        "--set", "decode.compute_dtype=bfloat16"],
        need=("gru_fwd_bf16", "readout_topk_bf16"))
    got = out["translate bf16 run bf16"]["launches"]
    if dev.type == "cuda" and (
            got.get("readout_topk") != got.get("readout_topk_bf16")
            or got.get("gru_fwd") != got.get("gru_fwd_bf16")):
        raise AssertionError(f"cli translate bf16: an fp32 instance ran: {got}")
    hyp16 = path.read_text().splitlines()
    stoi = Vocab.load(str(data / "vocab.de.json")).stoi
    if len(hyp16) != splits["test2016"][0] or any(
            u not in stoi for line in hyp16 for u in line.split()):
        raise AssertionError("cli translate bf16: malformed output")
    train_need = ("gru_fwd", "gru_bwd", "dec_scan_fwd", "dec_scan_bwd",
                  "readout_topk")

    def host_command(label, argv):
        # preprocess and make-toy write files only: no --device
        launches, last, secs = _cli_command(torch, argv)
        out[label] = {"launches": launches, "seconds": secs}
        print(f"cli {label}: {secs:.2f} s: {last}")

    # make-toy -> train -> translate at full width (the toy task's
    # features at the preset's width)
    toy, toy_run = root / "toy", root / "toy_run"
    host_command("make-toy", ["make-toy", "--out-dir", str(toy),
                              "--img-dim", str(m.img_feat_dim)])
    res = json.loads(command("train toy", [
        "train", "--preset", preset, "--data-dir", str(toy), "--out-dir",
        str(toy_run), "--set", "data.dataset=toy", "--max-steps",
        str(CLI_TRAIN_STEPS), "--set",
        f"train.eval_every_steps={CLI_TRAIN_STEPS}"], need=train_need))
    if res["steps"] != CLI_TRAIN_STEPS or "dev_bleu" not in res:
        raise AssertionError(f"cli train toy: {res}")
    path = root / "hyp_toy.txt"
    command("translate toy", [
        "translate", "--data-dir", str(toy), "--checkpoint", str(toy_run),
        "--split", "test", "--output", str(path)],
        need=("gru_fwd", "readout_topk"))
    if len(path.read_text().splitlines()) != 50:
        raise AssertionError("cli translate toy: line count")
    # raw text -> preprocess (Moses, lowercase, BPE) -> train, then raw
    # lines through translate-text (preprocess.json replayed)
    raw, pre, pre_run = root / "raw", root / "pre", root / "pre_run"
    _write_raw_multi30k(np, raw, m, CLI_RAW_SPLITS)
    host_command("preprocess", [
        "preprocess", "--raw-dir", str(raw), "--out-dir", str(pre),
        "--splits", ",".join(CLI_RAW_SPLITS), "--bpe-merges",
        str(CLI_BPE_MERGES)])
    res = json.loads(command("train preprocessed", [
        "train", "--preset", preset, "--data-dir", str(pre), "--out-dir",
        str(pre_run), "--set", "data.dataset=multi30k", "--max-steps",
        str(CLI_TRAIN_STEPS), "--set",
        f"train.eval_every_steps={CLI_TRAIN_STEPS}"], need=train_need))
    if res["steps"] != CLI_TRAIN_STEPS or "dev_bleu" not in res:
        raise AssertionError(f"cli train preprocessed: {res}")
    n_tgt = len(Vocab.load(str(pre / "vocab.de.json")))
    out["train preprocessed"]["tgt_vocab"] = n_tgt
    command("translate-text raw", [
        "translate-text", "--checkpoint", str(pre_run), "--input",
        str(raw / "test2017.en"), "--output", str(root / "raw_pre_hyp.txt")],
        need=("gru_fwd", "readout_topk"))
    if len((root / "raw_pre_hyp.txt").read_text().splitlines()) != \
            CLI_RAW_SPLITS["test2017"]:
        raise AssertionError("cli translate-text raw: line count")
    print("cli: " + json.dumps({k: v for k, v in out.items()}))
    shutil.rmtree(root, ignore_errors=True)
    return out


# Phase 15's raw corpus: Multi30k's layout and split names, sentences of
# Zipf words from a made-up lexicon of each language (capitals,
# punctuation, clitics, accented letters), for the preprocess command.
CLI_RAW_SPLITS = {"train": 2048, "val": 64, "test2016": 128, "test2017": 64}
CLI_BPE_MERGES = 4000


def _write_raw_multi30k(np, d, m, splits):
    """Raw {split}.{en,de} text and {split}_features.npy (no sidecar: the
    features are aligned by row count)."""
    d.mkdir(parents=True)
    rng = np.random.RandomState(41)
    letters = {"en": "abcdefghijklmnopqrstuvwxyz",
               "de": "abcdefghijklmnopqrstuvwxyzäöüß"}
    lex = {lang: ["".join(rng.choice(list(al), rng.randint(2, 11)))
                  for _ in range(3000)] for lang, al in letters.items()}
    p = 1.0 / np.arange(1, 3001)
    p /= p.sum()
    for split, n in splits.items():
        for lang in ("en", "de"):
            rows = []
            for _ in range(n):
                words = [lex[lang][i] for i in
                         rng.choice(3000, int(np.clip(rng.normal(12, 4), 3, 30)),
                                    p=p)]
                words[0] = words[0].capitalize()
                if len(words) > 6 and rng.rand() < 0.4:
                    words[3] += ","
                if lang == "en" and rng.rand() < 0.2:
                    words[1] += "'s"
                rows.append(" ".join(words) + rng.choice([".", ".", "!", "?"]))
            (d / f"{split}.{lang}").write_text("".join(r + "\n" for r in rows),
                                               encoding="utf-8")
        np.save(str(d / f"{split}_features.npy"),
                np.abs(rng.randn(n, m.img_feat_dim)).astype(np.float32))


# Phase 16: a run the JAX package wrote (tests/goldens/jax_run_toy, checked
# in by tests/test_torch_jax_run.py), decoded on the card: the JAX
# package's fixed-seed beam-3 golden (tests/goldens/beam_toy.json).
def phase_jax_run(torch, np, dev):
    """Translator.from_run-style load of the checked-in JAX run (the
    port's msgpack reader, the weight bridge) onto the card, then the
    golden's 24 examples decoded at beam 3 through the kernels: the share
    of hypotheses equal to the JAX package's golden, against
    MIN_IDENTICAL_SHARE, and kernels 1 and 2 launched."""
    from pathlib import Path

    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.data.batching import Example
    from vag_nmt_tpu_torch.data.datasets import toy_vocab
    from vag_nmt_tpu_torch.ops.gru_kernel import gru_fwd
    from vag_nmt_tpu_torch.ops.readout_topk import readout_topk_rows
    from vag_nmt_tpu_torch.train.checkpoint import load_checkpoint

    goldens = Path(__file__).resolve().parent / "tests" / "goldens"
    run = goldens / "jax_run_toy"
    cfg = vt.Config.from_json((run / "config.json").read_text())
    state, meta = load_checkpoint(str(run / cfg.train.checkpoint_dir), "best",
                                  device=dev, cfg=cfg.model)
    rng = np.random.RandomState(13)      # the golden's examples
    m = cfg.model
    exs = [Example(src=list(rng.randint(4, m.src_vocab_size,
                                        rng.randint(3, 14))),
                   img=rng.randn(m.img_feat_dim).astype(np.float32), index=i)
           for i in range(24)]
    gru_fwd.launches = readout_topk_rows.launches = 0
    hyps, _ = vt.translate_corpus(state.params, cfg, exs, toy_vocab(),
                                  beam_size=3, de_bpe=False, device=dev)
    launches = {"gru_fwd": gru_fwd.launches,
                "readout_topk": readout_topk_rows.launches}
    golden = json.loads((goldens / "beam_toy.json").read_text())
    share = sum(a == b for a, b in zip(hyps, golden)) / len(golden)
    print(f"jax run (step {state.step}, meta {json.dumps(meta)}): identical "
          f"to the JAX golden {share:.4f} (threshold {MIN_IDENTICAL_SHARE}), "
          f"launches {json.dumps(launches)}")
    if share < MIN_IDENTICAL_SHARE or min(launches.values()) < 1:
        raise AssertionError("jax run decode on the card")
    return {"identical_share": share, "launches": launches}


# ---- bf16 decode (phases 17-21) --------------------------------------------
# Phase 17: kernel 1b, the bf16 instances of kernel 1 (readout_topk_bf16,
# readout_topk_k16_bf16: t and W bf16, b and the outputs fp32, the products
# bf16 x bf16 summed in fp32), as the bf16 decode and VAG_FRT_GEMM_DTYPE=bf16
# give them: at R = 640, E = 256, V = 8000 and 16000, K = 5 (depth K; slots
# 1 and 3 with their flags, the per-step recovery and a lane collision);
# at K = 12 and 16 (the k16 build) and K = 20 (its passes of 16) at B = 128
# sentences; at phase 2's ragged shapes (V = 8003, E = 250: rows copied a
# value at a time). Values and lse within READOUT_RTOL; ids exact on integer
# inputs, on random rows but among candidates within READOUT_RTOL of each
# other in float64. The fp32 instance and torch.addmm in bf16 (the GEMM
# alone, bf16 out) are timed in the same call.
READOUT_BF16_V = (8000, 16000)
READOUT_BF16_BEAMS = (12, 16, 20)


def _readout_bf16_bound(R: int, E: int, V: int, K: int, slots: bool):
    """Kernel 1b's bound (ms, by): 2REV operations at the bf16 tensor rate;
    t and W read once at 2 bytes, b at 4, the top-K, lse (and viol) written
    once."""
    from vag_nmt_tpu_torch.core.flops import H100_PEAK_BF16_FLOPS

    nbytes = (2.0 * (R * E + E * V) + 4.0 * V + 8.0 * R * K
              + (8.0 if slots else 4.0) * R)
    return _bound(2.0 * R * E * V, nbytes, H100_PEAK_BF16_FLOPS)


def _readout_bf16_inputs(torch, np, dev, kind, R, E, V, seed):
    """(t, w) in bf16 and b in fp32: small integers (every product and sum
    exact in fp32) or random values rounded to bf16."""
    rng = np.random.RandomState(seed)
    if kind == "integer":
        t, w = rng.randint(-3, 4, (R, E)), rng.randint(-3, 4, (E, V))
        b = rng.randint(-3, 4, V)
    else:
        t, w = np.tanh(rng.randn(R, E)), 0.05 * rng.randn(E, V)
        b = 0.1 * rng.randn(V)

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return (cuda(t).to(torch.bfloat16).contiguous(),
            cuda(w).to(torch.bfloat16).contiguous(), cuda(b))


def _check_readout_bf16(torch, what, t, w, b, K, integer):
    """Kernel 1b at depth K against its plain version (and a second call
    bit for bit); returns (largest abs error, rows differing among near
    ties)."""
    from vag_nmt_tpu_torch.ops import readout_topk as rt

    n0 = rt.readout_topk_rows.bf16_launches
    kv, ki, kl = rt.readout_topk_rows(t, w, b, K, impl="kernel")
    again = rt.readout_topk_rows(t, w, b, K, impl="kernel")
    pv, pi, pl = rt.readout_topk_rows_plain(t, w, b, K)
    torch.cuda.synchronize()
    if rt.readout_topk_rows.bf16_launches - n0 != 2:
        raise AssertionError(f"{what}: the bf16 instance did not launch")
    err = 0.0
    for name, a, c in (("vals", kv, pv), ("lse", kl, pl)):
        if not torch.allclose(a, c, rtol=READOUT_RTOL, atol=0.0):
            raise AssertionError(f"{what}: {name} off by "
                                 f"{float((a - c).abs().max())}")
        err = max(err, float((a - c).abs().max()))
    if integer:
        if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
            raise AssertionError(f"{what}: integer inputs not exact")
        near = 0
    else:
        near = _ids_up_to_near_ties(torch, what, t, w, b, ki, pi)
    if not all(torch.equal(x, y) for x, y in zip(again, (kv, ki, kl))):
        raise AssertionError(f"{what}: a second call differs")
    return err, near


def phase_readout_bf16(torch, np, dev):
    """Phase 17 (above). Returns kernel 1b's row of the kernels line."""
    from vag_nmt_tpu_torch.ops import readout_topk as rt

    E, K, R = 256, 5, 640
    max_err, near = 0.0, {}
    for V in READOUT_BF16_V:
        for kind in ("integer", "random"):
            t, w, b = _readout_bf16_inputs(torch, np, dev, kind, R, E, V, V + 3)
            e, near[f"{kind} V={V}"] = _check_readout_bf16(
                torch, f"readout_topk_bf16 {kind} (R={R}, V={V})", t, w, b, K,
                kind == "integer")
            max_err = max(max_err, e)
        max_err = max(max_err, _readout_slots_checks(torch, np, dev, R, E, V,
                                                     K, bf16=True))
        print(f"readout_topk_bf16 (R={R}, E={E}, V={V}): depth K, slots "
              f"{READOUT_SLOTS} and the per-step recovery ok")
    # phase 2's ragged shapes: rows of W (V = 8003) and of t (E = 250) off
    # 16-byte boundaries, copied a value at a time; a part-full row tile
    for Rr, Er, Vr in ((35, 256, 8003), (35, 250, 8003)):
        for kind in ("integer", "random"):
            t, w, b = _readout_bf16_inputs(torch, np, dev, kind, Rr, Er, Vr, Er)
            e, near[f"{kind} E={Er} V={Vr}"] = _check_readout_bf16(
                torch, f"readout_topk_bf16 {kind} (R={Rr}, E={Er}, V={Vr})",
                t, w, b, K, kind == "integer")
            max_err = max(max_err, e)
        print(f"readout_topk_bf16 (R={Rr}, E={Er}, V={Vr}): ok")
    for Kw in READOUT_BF16_BEAMS:
        Rw = WIDE_B * Kw
        for kind in ("integer", "random"):
            t, w, b = _readout_bf16_inputs(torch, np, dev, kind, Rw, E, 8000, Kw)
            p0 = rt.readout_topk_rows.passes
            e, near[f"{kind} K={Kw}"] = _check_readout_bf16(
                torch, f"readout_topk_bf16 {kind} (K={Kw})", t, w, b, Kw,
                kind == "integer")
            max_err = max(max_err, e)
            if (rt.readout_topk_rows.passes > p0) != (Kw > 16):
                raise AssertionError(f"readout_topk_bf16 K={Kw}: passes")
        print(f"readout_topk_bf16 K={Kw} (R={Rw}, V=8000): ok")
    # a mixed operand set raises before any launch
    t, w, b = _readout_bf16_inputs(torch, np, dev, "random", R, E, 8000, 1)
    n0 = rt.readout_topk_rows.launches
    for tt, ww in ((t, w.float()), (t.float(), w)):
        try:
            rt.readout_topk_rows(tt, ww, b, K, impl="kernel")
        except ValueError:
            continue
        raise AssertionError("readout_topk took a mixed bf16/fp32 operand set")
    if rt.readout_topk_rows.launches != n0:
        raise AssertionError("readout_topk launched on a mixed operand set")

    # times: kernel 1b's whole call alone, cold and warm, beside the fp32
    # instance on the same values and torch.addmm in bf16
    kw = {"hold": READOUT_HOLD, "warm_hold": READOUT_WARM_HOLD}
    grids = {}
    for V in READOUT_BF16_V:
        t, w, b = _readout_bf16_inputs(torch, np, dev, "random", R, E, V, V + 7)
        b[list(READOUT_CLEAR_IDS)] += 100.0     # slots 1 flags no row
        live = torch.ones(R, dtype=torch.uint8, device=dev)
        if int(rt.readout_topk_rows(t, w, b, K, slots=1, impl="kernel")[3].sum()):
            raise AssertionError(f"readout_topk_bf16 grid case V={V}: rows flagged")
        t32, w32 = t.float(), w.float()
        g = {"R": R, "E": E, "V": V, "K": K}
        for label, fn in (
                ("grid", lambda: rt.readout_topk_rows(t, w, b, K, impl="kernel")),
                ("slots1_grid", lambda: rt.readout_topk_rows(
                    t, w, b, K, slots=1, impl="kernel")),
                ("recovery_grid", lambda: rt.readout_topk_rows(
                    t, w, b, K, slots=1, recover_live=live, impl="kernel")),
                ("fp32_grid", lambda: rt.readout_topk_rows(
                    t32, w32, b, K, impl="kernel"))):
            g[f"{label}_ms"], g[f"{label}_warm_ms"] = _grid_ms(torch, fn, **kw)
        b16 = b.to(torch.bfloat16)
        logits = torch.empty((R, V), dtype=torch.bfloat16, device=dev)
        g["addmm_bf16_grid_ms"], g["addmm_bf16_grid_warm_ms"] = _grid_ms(
            torch, lambda: torch.addmm(b16, t, w, out=logits))
        g["bound_ms"], g["bound_by"] = _readout_bf16_bound(R, E, V, K, False)
        g["wrapper_ms"] = _time_ms(torch, lambda: rt.readout_topk_rows(
            t, w, b, K, impl="kernel"))
        g["plain_ms"] = _time_ms(torch, lambda: rt.readout_topk_rows_plain(
            t, w, b, K))
        # kernel 1b' (slots 1): its plain version and its bound
        g["slots1_plain_ms"] = _time_ms(
            torch, lambda: rt.readout_topk_rows_plain(t, w, b, K, slots=1))
        g["slots1_bound_ms"], _ = _readout_bf16_bound(R, E, V, K, True)
        grids[V] = g
        print(f"readout_topk_bf16 grid (R={R}, E={E}, V={V}): " + json.dumps(g))
    g = grids[READOUT_BF16_V[0]]
    print(f"readout_topk_bf16: rows differing among near ties {json.dumps(near)}")
    return {"name": "readout_topk_bf16", "route": "cuda",
            "source": "vag_nmt_tpu_torch/csrc/readout_topk.cu",
            "replaces": "vag_nmt_tpu/ops/pallas_readout_topk.py:113",
            "max_abs_err": max_err, "ms": g["grid_ms"], "plain_ms": g["plain_ms"],
            "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
            "library_ms": None, "grids_by_v": grids, "near_tie_rows": near,
            **{f: g[f] for f in ("grid_warm_ms", "slots1_grid_ms",
                                 "recovery_grid_ms", "fp32_grid_ms",
                                 "addmm_bf16_grid_ms", "wrapper_ms",
                                 "slots1_plain_ms", "slots1_bound_ms")}}


# Phase 18: kernel 7b, the bf16 instances of kernel 7 (dec_step_bf16,
# dec_step_k16_bf16: s, ctx, uh1, w_s, w_c, ws bf16; gy, ctxpb, mask, the
# biases, va and t fp32; s~, c and s' rounded to bf16 once each) at full
# width (B, K, T) = (128, 5, 32), at K = 12 (the k16 build) and K = 20 (its
# beam groups), at the ragged shape: the bf16 states within
# BF16_STATE_ATOL, t within BF16_RTOL of its scale; a second call bit for
# bit; at widths that are no multiples of 8 (rows copied a value at a
# time); timed beside the fp32 instance and the four products through
# torch.mm in bf16.
DEC_STEP_BF16_BEAMS = (5, 12, 20)


def _dec_step_bf16_case(torch, np, dev, shape, seed):
    """Phase 10's dec_step case with the operands a bf16 decode gives the
    kernel: s, ctx and the four matrices rounded to bf16."""
    from vag_nmt_tpu_torch.ops.dec_step import MATRICES, WEIGHTS

    inputs, weights = _dec_step_case(torch, np, dev, *shape, seed=seed)
    bf = torch.bfloat16
    gy, s, ctx, ctxpb, mask = inputs
    weights = tuple(w.to(bf) if n in MATRICES else w
                    for n, w in zip(WEIGHTS, weights))
    return (gy, s.to(bf), ctx.to(bf), ctxpb, mask), weights


def _dec_step_bf16_bound(B, K, T, H, A, C, R, weights):
    """Kernel 7b's bound (ms, by): its four products at the bf16 tensor
    rate, the attention on the fp32 cores; bytes with s, ctx, the matrices
    and s' at 2 bytes."""
    from vag_nmt_tpu_torch.core.flops import (H100_HBM_BYTES_PER_S,
                                              H100_PEAK_BF16_FLOPS,
                                              H100_PEAK_FP32_FLOPS)

    N = B * K
    gemm = 2.0 * N * (H * 3 * H + H * (A + 3 * H) + C * (3 * H + R) + H * R)
    att = N * T * (4.0 * A + 2.0 * C)
    nbytes = (sum(w.numel() * w.element_size() for w in weights)
              + 4.0 * N * (3 * H + R) + 2.0 * N * H + B * T * (2.0 * C + 4.0 * A + 4.0)
              + 2.0 * N * H + 4.0 * N * R)
    t_ops = (gemm / H100_PEAK_BF16_FLOPS + att / H100_PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_dec_step_bf16(torch, np, dev):
    """Phase 18 (above). Returns kernel 7b's row of the kernels line."""
    from vag_nmt_tpu_torch.ops.dec_step import dec_step, dec_step_plain

    bf = torch.bfloat16
    cases = {f"k{K}": _dec_step_full(K=K) for K in DEC_STEP_BF16_BEAMS}
    cases["ragged"] = DEC_STEP_RAGGED
    cases["odd"] = DEC_STEP_ODD      # rows copied a value at a time
    max_abs, errs_all = 0.0, {}
    for label, shape in cases.items():
        inputs, weights = _dec_step_bf16_case(torch, np, dev, shape, seed=31)
        n0 = dec_step.bf16_launches
        got = dec_step(*inputs, weights, impl="kernel")
        again = dec_step(*inputs, weights, impl="kernel")
        want = dec_step_plain(*inputs, weights)
        torch.cuda.synchronize()
        if dec_step.bf16_launches - n0 != 2 or got[0].dtype != bf or \
                got[1].dtype != torch.float32:
            raise AssertionError(f"dec_step_bf16 {label}: not the bf16 instance")
        errs = {"s_new": float((got[0].float() - want[0].float()).abs().max()),
                "t": _rel_err(got[1], want[1])}
        if not (errs["s_new"] <= BF16_STATE_ATOL and errs["t"] <= BF16_RTOL):
            raise AssertionError(f"dec_step_bf16 {label} {shape}: {errs}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"dec_step_bf16 {label}: a second call differs")
        max_abs = max(max_abs, errs["s_new"],
                      float((got[1] - want[1]).abs().max()))
        errs_all[label] = errs
        print(f"dec_step_bf16 {label} (B, K, T, H, A, C, R)={shape}: ok, "
              f"errors {json.dumps(errs)}")
    inputs, weights = _dec_step_bf16_case(torch, np, dev, _dec_step_full(), 32)
    try:
        dec_step(inputs[0], inputs[1].float(), *inputs[2:], weights,
                 impl="kernel")
    except ValueError:
        pass
    else:
        raise AssertionError("dec_step took a mixed bf16/fp32 operand set")

    full = _dec_step_full()
    B, K, T, H, A, C, R = full
    N = B * K
    kw = {"hold": READOUT_HOLD, "warm_hold": READOUT_WARM_HOLD}
    in32 = (inputs[0], inputs[1].float(), inputs[2].float(), *inputs[3:])
    w32 = tuple(w.float() for w in weights)
    g = {"B": B, "K": K, "T": T, "H": H, "A": A, "C": C, "R": R}
    g["grid_ms"], g["grid_warm_ms"] = _grid_ms(
        torch, lambda: dec_step(*inputs, weights, impl="kernel"), **kw)
    g["fp32_grid_ms"], g["fp32_grid_warm_ms"] = _grid_ms(
        torch, lambda: dec_step(*in32, w32, impl="kernel"), **kw)
    s = inputs[1]
    c = torch.from_numpy(np.random.RandomState(13).randn(N, C).astype(
        np.float32)).to(dev).to(bf)
    prods = [(s, weights[0]), (s, weights[2]), (c, weights[5]), (s, weights[7])]
    outs = [torch.empty((N, w.shape[1]), dtype=bf, device=dev) for _, w in prods]

    def gemms():
        for (a, w), o in zip(prods, outs):
            torch.mm(a, w, out=o)

    g["mm_bf16_grid_ms"], g["mm_bf16_grid_warm_ms"] = _grid_ms(torch, gemms, **kw)
    g["bound_ms"], g["bound_by"] = _dec_step_bf16_bound(*full, weights)
    g["wrapper_ms"] = _time_ms(torch, lambda: dec_step(*inputs, weights,
                                                       impl="kernel"))
    g["plain_ms"] = _time_ms(torch, lambda: dec_step_plain(*inputs, weights))
    print(f"dec_step_bf16 grid (B={B}, K={K}, T={T}): " + json.dumps(g))
    return {"name": "dec_step_bf16", "route": "cuda",
            "source": "vag_nmt_tpu_torch/csrc/dec_step.cu",
            "replaces": "vag_nmt_tpu/ops/pallas_dec_step.py:106",
            "max_abs_err": max_abs, "ms": g["grid_ms"], "plain_ms": g["plain_ms"],
            "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
            "library_ms": None, "errors": errs_all,
            **{f: g[f] for f in ("grid_warm_ms", "fp32_grid_ms",
                                 "fp32_grid_warm_ms", "mm_bf16_grid_ms",
                                 "mm_bf16_grid_warm_ms", "wrapper_ms")}}


# Phase 19: kernel 2b (gru_fwd_bf16) at the decode encoders' shapes, (B, T)
# = (1024, 32) m30k and (512, 120) ikea_vag, both directions, against its
# plain version within BF16_STATE_ATOL (phase 8b's tolerance; the two take
# the gate math in one order, so their states differ only where the
# products' fp32 sums round apart: the share of identical elements is
# printed), a second call bit for bit; its grid cold
# and warm beside the fp32 instance's on the same values, and its bound at
# the bf16 rate.
GRU_BF16_DECODE_SHAPES = (("decode", 1024, 32), ("ikea", 512, 120))


def phase_gru_bf16_decode(torch, np, dev):
    """Phase 19 (above). {label: fields}."""
    from vag_nmt_tpu_torch.ops.gru_kernel import gru_fwd, gru_fwd_plain

    bf = torch.bfloat16
    kw = {"hold": READOUT_HOLD, "warm_hold": READOUT_WARM_HOLD}
    out = {}
    for label, B, T in GRU_BF16_DECODE_SHAPES:
        _, p, xg32, mask_t, h0 = _gru_case(torch, np, dev, B, T, seed=19)
        xg_t = xg32.to(bf)
        err = 0.0
        for reverse in (False, True):
            n0 = gru_fwd.bf16_launches
            hk = gru_fwd(xg_t, mask_t, p["uh"], p["bh"], h0, reverse=reverse,
                         impl="kernel")
            hk2 = gru_fwd(xg_t, mask_t, p["uh"], p["bh"], h0, reverse=reverse,
                          impl="kernel")
            hp = gru_fwd_plain(xg_t, mask_t, p["uh"], p["bh"], h0,
                               reverse=reverse)
            torch.cuda.synchronize()
            if gru_fwd.bf16_launches - n0 != 2 or hk.dtype != bf:
                raise AssertionError(f"gru_fwd_bf16 {label}: not the bf16 instance")
            e = float((hk.float() - hp.float()).abs().max())
            if not e <= BF16_STATE_ATOL:
                raise AssertionError(f"gru_fwd_bf16 {label} reverse={reverse}: "
                                     f"max abs err {e}")
            if not torch.equal(hk, hk2):
                raise AssertionError(f"gru_fwd_bf16 {label}: a second call differs")
            err = max(err, e)
            same = float((hk == hp).float().mean())
        cold, warm = _grid_ms(torch, lambda: gru_fwd(
            xg_t, mask_t, p["uh"], p["bh"], h0, impl="kernel"), **kw)
        c32, w32 = _grid_ms(torch, lambda: gru_fwd(
            xg32, mask_t, p["uh"], p["bh"], h0, impl="kernel"), **kw)
        bound_ms, bound_by = _gru_fwd_bf16_bound(B, T, GRU_H)
        out[label] = {"B": B, "T": T, "max_abs_err": err,
                      "identical_share": same, "grid_ms": cold,
                      "grid_warm_ms": warm, "fp32_grid_ms": c32,
                      "fp32_grid_warm_ms": w32, "bound_ms": bound_ms,
                      "bound_by": bound_by}
        print(f"gru_fwd_bf16 decode shape {label}: " + json.dumps(out[label]))
    return out


# Phase 20: the bf16 decode (decode.compute_dtype="bfloat16", the params
# cast to bf16 once a call) of phase 4's corpus and model, three ways in
# one run: through the kernels, plain, and fp32 through the kernels. Kernel
# 1b launches once a beam step and kernel 2b twice an encoder pass, the fp32
# kernels 1 and 2 never; hypotheses through the kernels equal the plain
# path's for MIN_IDENTICAL_SHARE, and the share split between the encoder
# (kernel 2b alone) and the readout (kernel 1b alone); the kernel run under
# the profiler. Then:
# VAG_DEC_STEP=on (kernel 7b once a beam step), VAG_FRT_GEMM_DTYPE=bf16 in
# the fp32 decode (1b, not 1), VAG_ATTN_E_DTYPE=fp32 in the bf16 decode, the
# unfused bf16 step (kernel 6 once a beam step), and Translator with
# decode.compute_dtype=bfloat16 on raw lines.
def _main_corpus(torch, np, dev):
    """Phase 4's model, corpus, vocab and feature table."""
    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.core.config import SPECIALS
    from vag_nmt_tpu_torch.data.batching import Example
    from vag_nmt_tpu_torch.data.vocab import Vocab

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
    return cfg, params, examples, vocab, img_table


def _decode_counts():
    """The decode kernels' wrappers: {name: (wrapper, counter attribute)},
    the bf16 instances under <name>_bf16."""
    from vag_nmt_tpu_torch.ops import dec_step, gru_kernel, topk
    from vag_nmt_tpu_torch.ops.readout_topk import readout_topk_rows

    out = {}
    for name, fn in (("readout_topk", readout_topk_rows),
                     ("gru_fwd", gru_kernel.gru_fwd),
                     ("dec_step", dec_step.dec_step),
                     ("beam_topk", topk.beam_topk)):
        out[name] = (fn, "launches")
        if hasattr(fn, "bf16_launches"):
            out[f"{name}_bf16"] = (fn, "bf16_launches")
    return out


def _counted(run):
    """run() with every decode kernel's launch count set to 0 before it and
    read after it: (run's result, {name: launches}); fp32 instances under
    <name>_fp32."""
    counts = _decode_counts()
    for fn, attr in counts.values():
        setattr(fn, attr, 0)
    res = run()
    n = {name: getattr(fn, attr) for name, (fn, attr) in counts.items()}
    for name in ("readout_topk", "gru_fwd", "dec_step"):
        n[f"{name}_fp32"] = n[name] - n[f"{name}_bf16"]
    return res, n


def _decode_split(torch, run, plain_hyps, passes):
    """Where the bf16 decode's hypotheses part from the plain path's: run()
    once with the encoder's GRU scan through kernel 2b and the readout
    plain, once the other way round (the two entry points rebound to a
    fixed impl, every launch counted); {label: share of hypotheses as the
    plain path's}."""
    from vag_nmt_tpu_torch.models import model as model_mod
    from vag_nmt_tpu_torch.ops import gru as gru_mod

    real_scan, real_frt = gru_mod.gru_scan, model_mod.fused_readout_topk
    out = {}
    for label, enc, ro in (("encoder_kernel", "kernel", "plain"),
                           ("readout_kernel", "plain", "kernel")):
        gru_mod.gru_scan = (lambda *a, impl="auto", **k:
                            real_scan(*a, impl=enc, **k))
        model_mod.fused_readout_topk = (lambda *a, impl="auto", **k:
                                        real_frt(*a, impl=ro, **k))
        try:
            (hyps, st), n = _counted(run)
        finally:
            gru_mod.gru_scan = real_scan
            model_mod.fused_readout_topk = real_frt
        want = ((2 * passes, 0) if enc == "kernel"
                else (0, st["beam_loop_steps"]))
        if (n["gru_fwd_bf16"], n["readout_topk_bf16"]) != want or \
                n["gru_fwd_fp32"] or n["readout_topk_fp32"]:
            raise AssertionError(f"bf16 decode split {label}: launches {n}")
        out[label] = sum(a == b for a, b in zip(hyps, plain_hyps)) / N_SENT
    return out


def phase_bf16_decode(torch, np, dev):
    """Phase 20 (above). Returns ({kernel: launches on its bf16 path},
    fields)."""
    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.decode.translate import super_chunks
    from vag_nmt_tpu_torch.train.state import tree_leaves

    cfg32, params, examples, vocab, img_table = _main_corpus(torch, np, dev)
    cfg16 = cfg32.replace(decode=dict(compute_dtype="bfloat16"))
    B = cfg32.decode.decode_batch_size
    passes = super_chunks(-(-N_SENT // B), B)[0]

    def run(cfg, impl="auto", exs=examples):
        return vt.translate_corpus(params, cfg, exs, vocab,
                                   img_table=img_table, impl=impl)

    run(cfg16, exs=examples[:128])            # warm-up
    torch.cuda.synchronize()
    (hyps16, st16), n16 = _counted(lambda: run(cfg16))
    steps = st16["beam_loop_steps"]
    f = {"bf16": {"sentences_per_sec": st16["sentences_per_sec"],
                  "beam_loop_steps": steps, "launches": n16,
                  "encoder_passes": passes}}
    print(f"bf16 decode (kernels): " + json.dumps(f["bf16"]))
    if n16["readout_topk_bf16"] != steps or n16["readout_topk_fp32"]:
        raise AssertionError(f"bf16 decode: kernel 1b launched "
                             f"{n16['readout_topk_bf16']} for {steps} beam "
                             f"steps, kernel 1 {n16['readout_topk_fp32']}")
    if n16["gru_fwd_bf16"] != 2 * passes or n16["gru_fwd_fp32"]:
        raise AssertionError(f"bf16 decode: kernel 2b launched "
                             f"{n16['gru_fwd_bf16']} for {passes} encoder "
                             f"passes, kernel 2 {n16['gru_fwd_fp32']}")
    if len(hyps16) != N_SENT or not any(hyps16):
        raise AssertionError("bf16 decode: malformed hypotheses")
    (hyps16p, st16p), np16 = _counted(lambda: run(cfg16, "plain"))
    if any(np16.values()):
        raise AssertionError(f"bf16 decode (plain) launched kernels: {np16}")
    share = sum(a == b for a, b in zip(hyps16, hyps16p)) / N_SENT
    (hyps32, st32), n32 = _counted(lambda: run(cfg32))
    if n32["readout_topk_bf16"] or n32["gru_fwd_bf16"]:
        raise AssertionError(f"fp32 decode ran a bf16 instance: {n32}")
    f["bf16_plain"] = {"sentences_per_sec": st16p["sentences_per_sec"],
                       "identical_share": share}
    f["fp32"] = {"sentences_per_sec": st32["sentences_per_sec"],
                 "beam_loop_steps": st32["beam_loop_steps"],
                 "share_as_bf16": sum(a == b for a, b in zip(hyps16, hyps32))
                 / N_SENT}
    print(f"bf16 decode (plain): {json.dumps(f['bf16_plain'])}; fp32 "
          f"(kernels): {json.dumps(f['fp32'])}; identical hypotheses bf16 "
          f"kernels vs plain {share:.4f} (threshold {MIN_IDENTICAL_SHARE})")
    f["split"] = _decode_split(torch, lambda: run(cfg16), hyps16p, passes)
    print(f"bf16 decode split: " + json.dumps(f["split"]))
    if share < MIN_IDENTICAL_SHARE:
        raise AssertionError(f"bf16 decode: only {share:.4f} identical")
    phase_profile(torch, "decode bf16 (beam steps)",
                  lambda: run(cfg16)[1]["beam_loop_steps"])

    def mode(label, cfg, env, check):
        (hyps, st), n = _counted(lambda: _with_env(env, lambda: run(cfg)))
        s = st["beam_loop_steps"]
        f[label] = {"sentences_per_sec": st["sentences_per_sec"],
                    "beam_loop_steps": s, "launches": n,
                    "share_as_bf16": sum(a == b for a, b in zip(hyps, hyps16))
                    / N_SENT}
        print(f"bf16 decode {label}: " + json.dumps(f[label]))
        if not check(n, s):
            raise AssertionError(f"bf16 decode {label}: launches {n} for {s} "
                                 "beam steps")
        if len(hyps) != N_SENT or not any(hyps):
            raise AssertionError(f"bf16 decode {label}: malformed hypotheses")

    mode("dec_step", cfg16, {"VAG_DEC_STEP": "on"},
         lambda n, s: n["dec_step_bf16"] == s and not n["dec_step_fp32"]
         and n["readout_topk_bf16"] == s)
    mode("frt_gemm_bf16", cfg32, {"VAG_FRT_GEMM_DTYPE": "bf16"},
         lambda n, s: n["readout_topk_bf16"] == s and not n["readout_topk_fp32"]
         and n["gru_fwd_fp32"] == 2 * passes)
    mode("attn_e_fp32", cfg16, {"VAG_ATTN_E_DTYPE": "fp32"},
         lambda n, s: n["readout_topk_bf16"] == s)
    mode("unfused", cfg16, {"VAG_READOUT_TOPK": "unfused"},
         lambda n, s: n["beam_topk"] == s and not n["readout_topk"]
         and n["gru_fwd_bf16"] == 2 * passes)
    # Translator with decode.compute_dtype=bfloat16: its params cast once
    # at construction, raw lines of vocab units through kernels 1b and 2b
    tr = vt.Translator(cfg16, params, None, vocab, vocab, device=dev)
    if {x.dtype for x in tree_leaves(tr.params)} != {torch.bfloat16}:
        raise AssertionError("Translator (bf16 decode): params not cast")
    lines = [" ".join(vocab.itos[t] for t in ex.src if t < len(vocab.itos))
             for ex in examples[:256]]
    out, n = _counted(lambda: tr.translate(lines))
    f["translator"] = {"lines": len(out), "launches": n}
    print(f"bf16 decode Translator: " + json.dumps(f["translator"]))
    if len(out) != len(lines) or not n["readout_topk_bf16"] or \
            n["readout_topk_fp32"] or not n["gru_fwd_bf16"]:
        raise AssertionError(f"Translator (bf16 decode): launches {n}")
    launches = {"readout_topk_bf16": n16["readout_topk_bf16"],
                "gru_fwd_bf16": n16["gru_fwd_bf16"],
                "dec_step_bf16": f["dec_step"]["launches"]["dec_step_bf16"]}
    return launches, f


# Phase 21: the bucketed path (translate_corpus(fused=False): BucketBatcher
# in example order, one encode and one beam search a batch) on phase 4's
# corpus, fp32 and bf16, against the fused path's hypotheses (at least
# MIN_BUCKETED_SHARE identical: the batches' composition differs, and the
# encoder and the step run at other batch sizes), kernels 1 and 2 (1b and
# 2b in bf16) once a beam step and twice a batch; then VAG_SUPER_CHUNK=0
# (one encoder pass a decode chunk) and =256 against the default, kernel 2
# twice an encoder pass.
MIN_BUCKETED_SHARE = 0.99
SUPER_CHUNK_VALUES = ("0", "256")


def phase_bucketed(torch, np, dev):
    """Phase 21 (above). Returns fields."""
    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.decode.translate import super_chunks

    cfg32, params, examples, vocab, img_table = _main_corpus(torch, np, dev)
    B = cfg32.decode.decode_batch_size
    f = {}
    for label, cfg in (("fp32", cfg32), ("bf16", cfg32.replace(
            decode=dict(compute_dtype="bfloat16")))):
        sfx = "_bf16" if label == "bf16" else "_fp32"

        def run(fused, cfg=cfg):
            return vt.translate_corpus(params, cfg, examples, vocab,
                                       img_table=img_table, fused=fused)

        (hf, stf), _ = _counted(lambda: run(True))
        (hb, stb), n = _counted(lambda: run(False))
        same = sum(a == b for a, b in zip(hf, hb))
        f[label] = {"identical": same, "sentences": N_SENT,
                    "fused_sentences_per_sec": stf["sentences_per_sec"],
                    "bucketed_sentences_per_sec": stb["sentences_per_sec"],
                    "batches": stb["n_chunks"],
                    "beam_loop_steps": stb["beam_loop_steps"], "launches": n}
        print(f"bucketed decode {label}: {same} of {N_SENT} hypotheses as the "
              f"fused path's; " + json.dumps(f[label]))
        if same < MIN_BUCKETED_SHARE * N_SENT:
            raise AssertionError(f"bucketed {label}: only {same} identical")
        if n[f"readout_topk{sfx}"] != stb["beam_loop_steps"] or \
                n[f"gru_fwd{sfx}"] != 2 * stb["n_chunks"] or \
                n["readout_topk"] != n[f"readout_topk{sfx}"]:
            raise AssertionError(f"bucketed {label}: launches {n}")
    (h0, st0), n0 = _counted(lambda: vt.translate_corpus(
        params, cfg32, examples, vocab, img_table=img_table))
    f["super_chunk"] = {"default": {"launches": n0["gru_fwd"]}}
    for v in SUPER_CHUNK_VALUES:
        (h, st), n = _counted(lambda: _with_env(
            {"VAG_SUPER_CHUNK": v}, lambda: vt.translate_corpus(
                params, cfg32, examples, vocab, img_table=img_table)))
        passes = _with_env({"VAG_SUPER_CHUNK": v},
                           lambda: super_chunks(-(-N_SENT // B), B)[0])
        same = sum(a == b for a, b in zip(h, h0))
        f["super_chunk"][v] = {"identical": same, "encoder_passes": passes,
                               "gru_fwd": n["gru_fwd"],
                               "sentences_per_sec": st["sentences_per_sec"]}
        print(f"VAG_SUPER_CHUNK={v}: " + json.dumps(f["super_chunk"][v]))
        if n["gru_fwd"] != 2 * passes or same < MIN_BUCKETED_SHARE * N_SENT:
            raise AssertionError(f"VAG_SUPER_CHUNK={v}: {f['super_chunk'][v]}")
    if n0["gru_fwd"] != 2 * super_chunks(-(-N_SENT // B), B)[0]:
        raise AssertionError(f"default super chunks: gru_fwd {n0['gru_fwd']}")
    return f


# Phase 22: data parallelism on one card. Two ranks of this script
# (``--dp-worker``), each a process of its own on the one card under gloo
# (the backend rule: ranks sharing a card), spawned after the parent built
# every kernel, so the ranks only load them. (a) DP_STEPS training steps
# of the full-width m30k_ende_vag model (batch 64, 32 a rank, dropout 0.3)
# through make_train_step(mesh=) against the same steps in this process at
# B = 64: step 1's loss within DP_LOSS1_RTOL, the reduced grads (step 1's
# Adam first moment over 1 - b1, the clip undone) within DP_GRAD_RTOL (the
# norm of the difference over the norm), the later losses within
# DP_LOSS_RTOL, the params within the reference DP test's rtol / atol, the
# ranks' params bit-identical. (b) Phase 4's corpus through
# translate_corpus(mesh=): at least DP_MIN_SHARE of the hypotheses the
# single process's (cuBLAS may pick other algorithms at half the rows,
# which can flip a near tie), then streaming and two-phase on
# DP_SMALL_CORPUS sentences. Kernels 2-5 (training) and 1-2 (decode) are
# counted on each rank from its own run of the path. (c) train and
# translate through python -m torch.distributed.run on the card (NCCL
# where the host has a card for each rank). (d) where two cards are
# visible, (a) and (b) again under NCCL, a rank a card. Two ranks
# time-sharing one card are no scaling figure.
DP_WORLD = 2
DP_STEPS = 5
DP_LOSS1_RTOL, DP_GRAD_RTOL, DP_LOSS_RTOL = 1e-5, 1e-5, 1e-4
DP_PARAM_RTOL, DP_PARAM_ATOL = 2e-3, 2e-4
DP_MIN_SHARE = 0.99
DP_SMALL_CORPUS = 256
DP_SPAWN_TIMEOUT_S = 420
DP_CLI_SPLITS = {"train": (1024, 31), "val": (64, 32), "test2016": (256, 33),
                 "test2017": (64, 34)}
DP_CLI_STEPS = 20


def _dp_root():
    from pathlib import Path

    return Path(__file__).resolve().parent / "build" / "chip_smoke_dp"


def _dp_train_setup(torch, np, dev, preset="m30k_ende_vag", mesh=None):
    """Phase 8's corpus and batch stream at ``preset``'s width: (cfg, the
    first DP_STEPS batches, the feature table, the seed's init; under a
    mesh with a model axis, this rank's vocab slices of it)."""
    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.data.batching import BucketBatcher
    from vag_nmt_tpu_torch.parallel.sharding import shard_tree
    from vag_nmt_tpu_torch.train.loop import _step_rows
    from vag_nmt_tpu_torch.train.state import state_from_params

    cfg = vt.preset(preset)
    m = cfg.model
    train = _train_corpus(np, m, N_TRAIN_PAIRS, seed=8)
    batcher = BucketBatcher(train, cfg.data.batch_size, cfg.data.length_buckets,
                            seed=cfg.data.shuffle_seed, image_ids=True,
                            img_dim=m.img_feat_dim, compact=True)
    batches = list(_step_rows(batcher.epoch_stacked(
        0, cfg.train.steps_per_dispatch), 0))[:DP_STEPS]
    table = vt.build_img_table(train, m.img_feat_dim, device=dev)
    state0 = state_from_params(cfg, shard_tree(
        vt.init_params(m, torch.Generator().manual_seed(cfg.train.seed),
                       device=dev), mesh))
    return cfg, batches, table, state0


def _dp_train_run(torch, np, dev, mesh, preset="m30k_ende_vag",
                  steps=DP_STEPS, keep=()):
    """``steps`` steps at ``preset`` (mesh=None: this process alone):
    {losses, the reduced grads of step 1 (flat, host), the params after
    the last step and after each step of ``keep`` (flat, host; a model
    axis's slices gathered), the sha256 of the leaves every rank holds
    whole, the training kernels' launches, step times}."""
    import hashlib

    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.parallel.sharding import (gather_tree,
                                                     sharded_leaves, tp_mesh)
    from vag_nmt_tpu_torch.train.state import tree_leaves

    cfg, batches, table, state = _dp_train_setup(torch, np, dev, preset, mesh)
    def flat(tree):
        full = gather_tree(tree, mesh)
        return torch.cat([x.reshape(-1) for x in tree_leaves(full)]).cpu()

    step = vt.make_train_step(cfg, mesh=mesh, with_img_table=True)
    wrappers = _cli_wrappers()
    names = ("gru_fwd", "gru_bwd", "dec_scan_fwd", "dec_scan_bwd")
    for n in names:
        wrappers[n].launches = 0
    losses, times, grads, at = [], [], None, {}
    for i, b in enumerate(batches[:steps]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state, b, table)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(aux["loss"]))
        if i == 0:
            # mu = (1 - b1) * clipped grads; undo the clip
            norm = float(aux["grad_norm"])
            scale = min(1.0, cfg.train.grad_clip_norm / norm)
            grads = flat(state.mu) / (1.0 - cfg.train.adam_b1) / scale
        if i + 1 in keep:
            at[i + 1] = flat(state.params)
    launches = {n: wrappers[n].launches for n in names}
    whole = [x for x, s in zip(tree_leaves(state.params),
                               sharded_leaves(state.params))
             if not (tp_mesh(mesh) and s)]
    rep = torch.cat([x.reshape(-1) for x in whole]).cpu()
    return {"losses": losses, "grads": grads, "params": flat(state.params),
            "params_at": at,
            "sha256": hashlib.sha256(rep.numpy().tobytes()).hexdigest(),
            "launches": launches, "step_s": times}


# Decode modes of phases 22 and 23: (corpus: "full" = phase 4's 1024
# sentences, "small" = its first DP_SMALL_CORPUS; cfg.decode updates;
# environment; the kernels the mode must launch).
DECODE_RUN_MODES = {
    "chunked": ("full", {}, {}, ("readout_topk", "gru_fwd")),
    "chunked_small": ("small", {}, {}, ("readout_topk", "gru_fwd")),
    "streaming": ("small", {"streaming": "on"}, {}, ("readout_topk", "gru_fwd")),
    "two_phase": ("small", {"two_phase": "on"}, {}, ("readout_topk", "gru_fwd")),
    "bf16": ("small", {"compute_dtype": "bfloat16"}, {},
             ("readout_topk_bf16", "gru_fwd_bf16")),
    "unfused": ("small", {}, {"VAG_READOUT_TOPK": "unfused"},
                ("beam_topk", "gru_fwd")),
    "greedy": ("small", {"beam_size": 1}, {}, ("gru_fwd",)),
}


def _dp_decode_run(torch, np, dev, mesh, modes=("chunked", "streaming",
                                                "two_phase")):
    """Phase 4's corpus through translate_corpus (mesh=None: this process
    alone) in each of ``modes`` (DECODE_RUN_MODES): {mode: (hypotheses,
    stats, the decode kernels' launches, the slice merges' count and
    sha256 over their outputs' bytes in order)}. Under a model axis the
    params are this rank's vocab slices of phase 4's."""
    import hashlib

    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.ops import readout_topk as rt
    from vag_nmt_tpu_torch.parallel.sharding import shard_tree

    cfg, params, examples, vocab, img_table = _main_corpus(torch, np, dev)
    params = shard_tree(params, mesh)
    out = {}
    for mode in modes:
        corpus, upd, env, _ = DECODE_RUN_MODES[mode]
        n = N_SENT if corpus == "full" else DP_SMALL_CORPUS
        c = cfg.replace(decode=upd) if upd else cfg
        digest, merges = hashlib.sha256(), [0]
        orig = rt._merge_slices

        def merge(*a, **k):
            res = orig(*a, **k)
            merges[0] += 1
            for x in res:
                digest.update(x.cpu().numpy().tobytes())
            return res

        rt._merge_slices = merge
        try:
            (hyps, st), k = _counted(lambda: _with_env(
                env, lambda: vt.translate_corpus(
                    params, c, examples[:n], vocab, img_table=img_table[:n],
                    mesh=mesh)))
        finally:
            rt._merge_slices = orig
        torch.cuda.synchronize()
        out[mode] = (hyps, st, k, merges[0], digest.hexdigest())
    return out


def _tp_step_split(torch, np, dev, mesh):
    """The split of a beam step of the chunked decode of phase 4's first
    DP_SMALL_CORPUS sentences under a model axis: before each call of
    its two collectives (the embedding rows' gather, ``vocab_embed``, and
    the slices' merge) the card is drained (torch.cuda.synchronize, timed
    apart: the queued kernels, a sharing rank's included), then the call
    is timed (host copies, gloo's exchange, the wait for the peer). ms a
    beam step: drain, embed_gather, merge, the rest (the host's own), and
    the calls."""
    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.models import layers
    from vag_nmt_tpu_torch.ops import readout_topk as rt
    from vag_nmt_tpu_torch.parallel.sharding import shard_tree

    cfg, params, examples, vocab, img_table = _main_corpus(torch, np, dev)
    params = shard_tree(params, mesh)
    n = DP_SMALL_CORPUS
    acc = {"drain": 0.0, "embed_gather": 0.0, "merge": 0.0}
    calls = {"embed_gather": 0, "merge": 0}

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*a, **k)
            acc["drain"] += t1 - t0
            acc[name] += time.perf_counter() - t1
            calls[name] += 1
            return out
        return run

    orig = layers.vocab_embed, rt._merge_slices
    layers.vocab_embed = timed("embed_gather", orig[0])
    rt._merge_slices = timed("merge", orig[1])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st = vt.translate_corpus(params, cfg, examples[:n], vocab,
                                    img_table=img_table[:n], mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        layers.vocab_embed, rt._merge_slices = orig
    steps = st["beam_loop_steps"]
    out = {f"{k}_ms": v / steps * 1e3 for k, v in acc.items()}
    out["step_ms"] = wall / steps * 1e3
    out["rest_ms"] = out["step_ms"] - sum(v / steps * 1e3
                                          for v in acc.values())
    out.update(beam_loop_steps=steps, calls=calls)
    return out


def _dp_worker(torch, np, argv) -> int:
    """One rank of phases 22 and 23: ``--dp-worker <spec> <rank> <world>
    <store> <out>``; spec (JSON): {"n_model", "train": {"preset",
    "steps"} or null, "decode": [modes], "split": whether to take
    ``_tp_step_split``}."""
    import torch.distributed as dist

    from vag_nmt_tpu_torch.parallel import init_distributed, make_mesh

    spec, rank, world, store, out = argv
    spec = json.loads(spec)
    dev = init_distributed(None, init_method=f"file://{store}")
    mesh = make_mesh(n_model=spec["n_model"])
    res = {"device": str(dev), "backend": mesh.backend,
           "card": torch.cuda.get_device_name(dev),
           "place": (mesh.data_index, mesh.model_index)}
    if spec["train"]:
        res["train"] = _dp_train_run(torch, np, dev, mesh, **spec["train"])
    if spec["decode"]:
        with torch.inference_mode():
            res["decode"] = _dp_decode_run(torch, np, dev, mesh,
                                           spec["decode"])
            if spec.get("split"):
                res["split"] = _tp_step_split(torch, np, dev, mesh)
    torch.save(res, f"{out}.{rank}.pt")
    dist.destroy_process_group()
    return 0


def _mps_state() -> str:
    """Whether the CUDA MPS daemon's pipe directory is there (MPS lets two
    processes' kernels share the card's SMs at once; without it their
    contexts time-slice)."""
    import os

    pipe = os.environ.get("CUDA_MPS_PIPE_DIRECTORY", "/tmp/nvidia-mps")
    return f"MPS {'active' if os.path.exists(pipe) else 'not active'} " \
           f"(pipe directory {pipe})"


def _run_group(procs, logs, what, timeout):
    """Waits for every process; on the timeout kills each one's session
    (its children too) and raises; raises where any exits non-zero."""
    import os
    import signal

    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        raise AssertionError(f"{what}: no end within {timeout} s")
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = "\n".join(f"--- {what} process {i} ---\n"
                          + logs[i].read_text()[-4000:] for i in bad)
        raise AssertionError(f"{what}: process(es) {bad} failed\n{tails}")


def _dp_spawn(torch, spec, tag, cards, world=DP_WORLD):
    """Runs ``spec`` (``_dp_worker``'s) on ``world`` ranks of this script
    (each its own process and session, one intra-op thread, its log under
    build/); ``cards``: the CUDA_VISIBLE_DEVICES of the ranks ("0": one
    card shared). Returns each rank's results."""
    import os

    root = _dp_root()
    store, out = root / f"store_{tag}", root / f"out_{tag}"
    env0 = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                         "LOCAL_WORLD_SIZE")}
    procs, logs = [], []
    for r in range(world):
        env = dict(env0, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   CUDA_VISIBLE_DEVICES=cards, OMP_NUM_THREADS="1")
        logs.append(root / f"rank{r}_{tag}.log")
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dp-worker",
             json.dumps(spec), str(r), str(world), str(store), str(out)],
            cwd=str(Path(__file__).resolve().parent), env=env,
            stdout=open(logs[-1], "w"), stderr=subprocess.STDOUT,
            start_new_session=True))
    _run_group(procs, logs, f"ranks {tag}", DP_SPAWN_TIMEOUT_S)
    return [torch.load(f"{out}.{r}.pt", weights_only=False)
            for r in range(world)]


def _dp_check_train(torch, ranks, want, label, smi, loss_rtol=DP_LOSS_RTOL):
    """(a)'s checks of each rank's run against this process's ``want``
    (its params after as many steps as the ranks took); the measured
    values."""
    f = {"backend": ranks[0]["backend"],
         "devices": [r["device"] for r in ranks]}
    n = len(ranks[0]["train"]["losses"])
    w_loss = want["losses"][:n]
    w_params = want["params"] if n == len(want["losses"]) \
        else want["params_at"][n]
    for i, r in enumerate(ranks):
        got = r["train"]
        loss1 = abs(got["losses"][0] - w_loss[0]) / abs(w_loss[0])
        later = max((abs(a - b) / abs(b) for a, b in
                     zip(got["losses"][1:], w_loss[1:])), default=0.0)
        gerr = float((got["grads"] - want["grads"]).norm()
                     / want["grads"].norm())
        d = (got["params"] - w_params).abs()
        bound = DP_PARAM_ATOL + DP_PARAM_RTOL * w_params.abs()
        worst = float((d / bound).max())
        f[f"rank{i}"] = {"loss1_rel": loss1, "later_loss_rel": later,
                         "grad_rel": gerr, "param_err_over_tol": worst,
                         "launches": got["launches"],
                         "step_s": got["step_s"], "losses": got["losses"]}
        if not (loss1 <= DP_LOSS1_RTOL and gerr <= DP_GRAD_RTOL
                and later <= loss_rtol and worst <= 1.0):
            raise AssertionError(f"train {label} rank {i}: {f[f'rank{i}']}")
        if min(got["launches"].values()) <= 0:
            raise AssertionError(f"train {label} rank {i}: a training "
                                 f"kernel never launched {got['launches']}")
    if len({r["train"]["sha256"] for r in ranks}) != 1:
        raise AssertionError(f"train {label}: the replicated params differ "
                             "between the ranks")
    f["replicas_identical"] = True
    f["single_losses"] = w_loss
    f["single_step_s"] = want["step_s"][:n]
    print(f"train {label} [{smi}]: " + json.dumps(f))
    return f


def _dp_check_decode(ranks, single, label, smi):
    """(b)'s checks of each rank's decodes against this process's
    ``single`` (by mode; a small corpus against the first sentences of
    the full one where the mode has no run of its own): at least
    DP_MIN_SHARE identical, the mode's kernels launched, the ranks of a
    model group equal, their slice merges' checksums too, and under a
    model axis kernel 1 once a beam step. The measured values by mode."""
    f = {}
    for mode in ranks[0]["decode"]:
        base = mode if mode in single else "chunked"
        hyps, st = single[base][:2]
        want = N_SENT if DECODE_RUN_MODES[mode][0] == "full" \
            else DP_SMALL_CORPUS
        if len(hyps) < want:
            raise AssertionError(f"decode {label} {mode}: this process's "
                                 f"{base} run holds {len(hyps)} of {want}")
        g = {"single_sentences_per_sec": st["sentences_per_sec"]}
        groups = {}
        for i, r in enumerate(ranks):
            h, s, n, merges, digest = r["decode"][mode]
            share = sum(a == b for a, b in zip(h, hyps[:want])) / want
            g[f"rank{i}"] = {"identical_share": share, "launches": n,
                             "sentences_per_sec": s["sentences_per_sec"],
                             "rows_per_chunk": s["rows_per_chunk"],
                             "beam_loop_steps": s["beam_loop_steps"],
                             "merges": merges, "sentences": len(h)}
            if len(h) != want or share < DP_MIN_SHARE:
                raise AssertionError(f"decode {label} {mode} rank {i}: {g}")
            need = DECODE_RUN_MODES[mode][3]
            if min((n[k] for k in need), default=1) <= 0:
                raise AssertionError(f"decode {label} {mode} rank {i}: a "
                                     f"kernel never launched {n}")
            groups.setdefault(r["place"][0], []).append((h, digest, merges, n))
        tp = len(next(iter(groups.values()))) > 1
        for d, members in groups.items():
            if any(m[0] != members[0][0] for m in members):
                raise AssertionError(f"decode {label} {mode}: the model "
                                     f"ranks of data index {d} differ")
            if any(m[1] != members[0][1] for m in members):
                raise AssertionError(f"decode {label} {mode}: the merges' "
                                     f"checksums differ in data index {d}")
            if tp and "readout_topk" in DECODE_RUN_MODES[mode][3] and any(
                    m[3]["readout_topk"] != m[2] for m in members):
                raise AssertionError(f"decode {label} {mode}: kernel 1 "
                                     "launches != slice merges")
        if tp:
            g["merge_sha256"] = {str(d): m[0][1] for d, m in groups.items()}
        if any(r["decode"][mode][0] != ranks[0]["decode"][mode][0]
               for r in ranks):
            raise AssertionError(f"decode {label} {mode}: the ranks' "
                                 "hypotheses differ")
        if tp and len(groups) == 1 and "readout_topk" in \
                DECODE_RUN_MODES[mode][3]:
            steps = ranks[0]["decode"][mode][1]["beam_loop_steps"]
            if ranks[0]["decode"][mode][3] != steps:
                raise AssertionError(f"decode {label} {mode}: {steps} beam "
                                     "steps, kernel 1 launched "
                                     f"{ranks[0]['decode'][mode][3]} times")
        f[mode] = g
        print(f"decode {label} {mode} [{smi}]: " + json.dumps(g))
    return f


def _dp_cli(torch, np, smi, n_model=1):
    """(c) / (e): train DP_CLI_STEPS steps and translate test2016 under
    python -m torch.distributed.run --nproc-per-node DP_WORLD on the card
    (no --device: the card), each command with its own timeout; with a
    model axis (``--set mesh.model_axis``) also translate in this process
    from the rank-0 checkpoint, its hypotheses against the ranks'."""
    import os

    import vag_nmt_tpu_torch as vt

    root = _dp_root() / f"cli_{n_model}"
    data, run = root / "data", root / "run"
    data.mkdir(parents=True)
    _write_cli_data(np, data, vt.preset("m30k_ende_vag").model,
                    DP_CLI_SPLITS)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    f = {}

    def torchrun(label, argv):
        log = root / f"{label}.log"
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(DP_WORLD), "-m", "vag_nmt_tpu_torch",
             *argv], cwd=str(Path(__file__).resolve().parent), env=env,
            stdout=open(log, "w"), stderr=subprocess.STDOUT,
            start_new_session=True)
        _run_group([p], [log], f"torchrun {label}", DP_SPAWN_TIMEOUT_S)
        text = log.read_text()
        backends = sorted(set(
            ln.split("backend ")[1].split(",")[0] for ln in text.splitlines()
            if "[data parallel]" in ln and "backend " in ln))
        results = [ln for ln in text.splitlines() if ln.startswith("{")]
        f[label] = {"seconds": time.perf_counter() - t0, "backend": backends}
        if len(results) != 1 or len(backends) != 1:
            raise AssertionError(f"torchrun {label}: {len(results)} result "
                                 f"lines, backends {backends}:\n{text[-3000:]}")
        return json.loads(results[0])

    res = torchrun("train", [
        "train", "--preset", "m30k_ende_vag", "--data-dir", str(data),
        "--out-dir", str(run), "--set", "data.dataset=multi30k",
        "--max-steps", str(DP_CLI_STEPS),
        "--set", f"train.eval_every_steps={DP_CLI_STEPS}",
        "--set", "train.log_every_steps=10",
        "--set", f"mesh.model_axis={n_model}"])
    if res["steps"] != DP_CLI_STEPS or "dev_bleu" not in res:
        raise AssertionError(f"torchrun train: {res}")
    meta = json.loads((run / "checkpoints" / "meta_last.json").read_text())
    if meta["data_parallel"]["n_model"] != n_model:
        raise AssertionError(f"torchrun train: meta {meta['data_parallel']}")
    f["train"].update(dev_bleu=res["dev_bleu"],
                      data_parallel=meta["data_parallel"])
    hyp = root / "hyp.txt"
    tr = ["translate", "--data-dir", str(data), "--checkpoint", str(run),
          "--split", "test2016"]
    st = torchrun("translate", tr + ["--output", str(hyp)])
    lines = hyp.read_text().splitlines()
    if len(lines) != DP_CLI_SPLITS["test2016"][0] or not any(lines):
        raise AssertionError("torchrun translate: malformed output")
    f["translate"].update(sentences_per_sec=st["sentences_per_sec"],
                          rows_per_chunk=st["rows_per_chunk"])
    if n_model > 1:
        # the run's config holds its mesh: one process asks for none
        one = root / "one.txt"
        _, _, secs = _cli_command(torch, tr + ["--output", str(one), "--set",
                                               "mesh.model_axis=1"])
        ones = one.read_text().splitlines()
        share = sum(a == b for a, b in zip(lines, ones)) / len(ones)
        f["one_process"] = {"seconds": secs, "identical_share": share}
        if len(ones) != len(lines) or share < DP_MIN_SHARE:
            raise AssertionError(f"translate under the mesh against one "
                                 f"process: {f['one_process']}")
    print(f"cli (n_model {n_model}) [{smi}]: " + json.dumps(f))
    return f


DP_SPEC = {"n_model": 1, "train": {"preset": "m30k_ende_vag", "steps": DP_STEPS},
           "decode": ["chunked", "streaming", "two_phase"]}


def phase_data_parallel(torch, np, dev):
    """Phase 22 (above). Returns (fields, this process's decodes)."""
    smi = _smi()
    root = _dp_root()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    print(f"dp: {_mps_state()}; {torch.cuda.device_count()} card(s) visible")
    f = {"card": smi}
    t0 = time.perf_counter()
    ranks = _dp_spawn(torch, DP_SPEC, "one_card", "0")
    f["spawn_s"] = time.perf_counter() - t0
    if {r["backend"] for r in ranks} != {"gloo"}:
        raise AssertionError(f"one card, two ranks: backend "
                             f"{[r['backend'] for r in ranks]}, not gloo")
    want = _dp_train_run(torch, np, dev, None)
    f["train"] = _dp_check_train(torch, ranks, want, "dp one card (gloo)", smi)
    with torch.inference_mode():
        single = _dp_decode_run(torch, np, dev, None)
    f["decode"] = _dp_check_decode(ranks, single, "dp one card (gloo)", smi)
    f["cli"] = _dp_cli(torch, np, smi)
    if torch.cuda.device_count() >= DP_WORLD:
        nccl = _dp_spawn(torch, DP_SPEC, "nccl", ",".join(
            str(i) for i in range(DP_WORLD)))
        if {r["backend"] for r in nccl} != {"nccl"}:
            raise AssertionError(f"a card a rank: backend "
                                 f"{[r['backend'] for r in nccl]}")
        f["nccl"] = {
            "train": _dp_check_train(torch, nccl, want,
                                     "dp a card a rank (nccl)", smi),
            "decode": _dp_check_decode(nccl, single,
                                       "dp a card a rank (nccl)", smi)}
    else:
        f["nccl"] = (f"did not run: {torch.cuda.device_count()} card visible, "
                     f"NCCL needs a card for each of the {DP_WORLD} ranks")
        print(f"dp nccl: {f['nccl']}")
    print("dp: two ranks time-sharing one card; their times are no scaling "
          "figure")
    shutil.rmtree(root, ignore_errors=True)
    return f, single


# Phase 23: vocab-dim tensor parallelism (a mesh with a model axis) on
# the one card, phase 22's spawn and checks with the mesh shape as their
# parameter. (a) (1 x 2): DP_STEPS steps of m30k_scaled at full width (V =
# 8000, 4000 a slice; E = H = A = 512; 2 encoder layers; batch 64, dropout
# 0.3) against this process: step 1's loss within DP_LOSS1_RTOL, the later
# ones within TP_LOSS_RTOL, the reduced grads within DP_GRAD_RTOL, the
# slices gathered within the reference TP test's rtol / atol, the
# replicated leaves bit-identical on the ranks; kernels 2-5 on each rank.
# (b) (1 x 2): phase 4's corpus and weights (m30k_ende_vag), the chunked
# decode of its 1024 sentences, then bf16 (kernel 1b on a slice), the
# unfused structure (the logits gathered into whole rows for kernel 6)
# and greedy on its first DP_SMALL_CORPUS: at least DP_MIN_SHARE of the
# hypotheses this process's (the merged lse rounds apart from the
# one-pass lse, and random weights nearly tie), the ranks' slice merges
# equal by checksum, kernel 1 launched once a beam step on each rank;
# then the split of a beam step (_tp_step_split). (c) kernel 1 alone on
# slices (phase_tp_readout), also past 16 beams and in bf16 on integer
# inputs (TP_SLICE_EXACT). (d) (2 x 2), four ranks:
# TP_2X2_STEPS steps and the DP_SMALL_CORPUS chunked decode (the data
# all-reduce of slices, the model merge inside data rows). (e) torchrun
# train and translate with --set mesh.model_axis=2, and translate in this
# process from the run's checkpoint. (f) where two cards are visible,
# (a) and (b) under NCCL, a card a rank.
TP_PRESET = "m30k_scaled"
TP_LOSS_RTOL = 1e-5
TP_2X2_STEPS = 2
TP_SPEC = {"n_model": 2, "train": {"preset": TP_PRESET, "steps": DP_STEPS},
           "decode": ["chunked", "bf16", "unfused", "greedy"], "split": True}
TP_2X2_SPEC = {"n_model": 2, "train": {"preset": TP_PRESET,
                                       "steps": TP_2X2_STEPS},
               "decode": ["chunked_small"]}
# Kernel 1 on a slice of m30k's 8000 ids: the last of 2 (V = 4000, id_base
# 4000) and of 4 (V = 2000, id_base 6000), at R = 640, E = 256, K = 5.
TP_SLICE_V = ((4000, 4000), (2000, 6000))


def phase_tp_readout(torch, np, dev):
    """(c): kernel 1 on a vocab slice, ids written from id_base, at depth
    K and slots 1, against its plain version (ids + id_base and flags
    exactly, values, lse and lse's terms within READOUT_RTOL); its whole
    call cold and warm, the plain version's time and the bound at the
    slice width. {V: fields}."""
    from vag_nmt_tpu_torch.ops import readout_topk as rt

    R, E, K = 640, 256, 5
    out = {}
    for V, base in TP_SLICE_V:
        rng = np.random.RandomState(V + 11)
        t = torch.from_numpy(np.tanh(rng.randn(R, E)).astype(np.float32)).to(dev)
        w = torch.from_numpy((0.05 * rng.randn(E, V)).astype(np.float32)).to(dev)
        b = torch.from_numpy((0.1 * rng.randn(V)).astype(np.float32)).to(dev)
        err = 0.0
        for slots in (0, 1):
            got = rt.readout_topk_rows(t, w, b, K, slots=slots, impl="kernel",
                                       id_base=base)
            want = rt.readout_topk_rows_plain(t, w, b, K, slots=slots)
            torch.cuda.synchronize()
            if not torch.equal(got[1], want[1] + base):
                raise AssertionError(f"kernel 1 on a slice V={V} slots "
                                     f"{slots}: ids differ")
            if slots and not torch.equal(got[3], want[3]):
                raise AssertionError(f"kernel 1 on a slice V={V}: flags differ")
            pairs = [(got[0], want[0]), (got[2], want[2])]
            if not slots:
                # lse's terms M and S, which the slices' merge takes
                pairs += list(zip(
                    rt.readout_topk_rows(t, w, b, K, impl="kernel",
                                         id_base=base, lse_parts=True)[2].T,
                    rt.readout_topk_rows_plain(t, w, b, K,
                                               lse_parts=True)[2].T))
            for a, c in pairs:
                if not torch.allclose(a, c, rtol=READOUT_RTOL, atol=0.0):
                    raise AssertionError(f"kernel 1 on a slice V={V} slots "
                                         f"{slots}: values off by "
                                         f"{float((a - c).abs().max())}")
                err = max(err, float((a - c).abs().max()))
        kw = {"hold": READOUT_HOLD, "warm_hold": READOUT_WARM_HOLD}
        depth = _grid_ms(torch, lambda: rt.readout_topk_rows(
            t, w, b, K, impl="kernel", id_base=base), **kw)
        slots1 = _grid_ms(torch, lambda: rt.readout_topk_rows(
            t, w, b, K, slots=1, impl="kernel", id_base=base), **kw)
        plain_ms = _time_ms(torch, lambda: rt.readout_topk_rows_plain(t, w, b, K))
        bound_ms, bound_by = _readout_bound(R, E, V, K, slots=False)
        out[V] = {"R": R, "E": E, "V": V, "K": K, "id_base": base,
                  "grid_ms": depth[0], "grid_warm_ms": depth[1],
                  "slots1_grid_ms": slots1[0], "slots1_grid_warm_ms": slots1[1],
                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "max_abs_err": err}
        print(f"readout_topk on a slice (R={R}, E={E}, V={V}, id_base={base}): "
              + json.dumps(out[V]))
    for V, base, Kx, dtype in TP_SLICE_EXACT:
        _check_slice_exact(torch, np, dev, R, E, V, base, Kx, dtype)
    return out


# Kernel 1 on a slice in passes of 16 (K = 20) and its bf16 instance 1b
# (the key translations of the pass path and of the bf16 ring), on
# integer inputs (every logit exact, ties everywhere): (V, id_base, K,
# operand dtype).
TP_SLICE_EXACT = ((4000, 4000, 20, "fp32"), (4000, 4000, 5, "bf16"),
                  (4000, 4000, 20, "bf16"))


def _check_slice_exact(torch, np, dev, R, E, V, base, K, dtype):
    """Kernel 1 (1b in bf16) on integer t, W and b with id_base at depth K
    and at slots 1 against its plain version: ids (+ id_base), values and
    flags exactly, lse and its terms within READOUT_RTOL; the bf16
    instance and the passes counted as launched."""
    from vag_nmt_tpu_torch.ops import readout_topk as rt
    from vag_nmt_tpu_torch.ops import topk

    rng = np.random.RandomState(V + K)
    op = torch.bfloat16 if dtype == "bf16" else torch.float32

    def cuda(shape, to):
        return torch.from_numpy(rng.randint(-3, 4, shape).astype(
            np.float32)).to(dev).to(to).contiguous()

    t, w, b = cuda((R, E), op), cuda((E, V), op), cuda((V,), torch.float32)
    what = f"kernel 1 on a slice V={V} id_base={base} K={K} {dtype}"
    p0, h0 = rt.readout_topk_rows.passes, rt.readout_topk_rows.bf16_launches
    for slots in (0, 1):
        got = rt.readout_topk_rows(t, w, b, K, slots=slots, impl="kernel",
                                   id_base=base, lse_parts=not slots)
        want = rt.readout_topk_rows_plain(t, w, b, K, slots=slots,
                                          lse_parts=not slots)
        torch.cuda.synchronize()
        if not (torch.equal(got[1], want[1] + base)
                and torch.equal(got[0], want[0])):
            raise AssertionError(f"{what} slots {slots}: top-K not exact")
        if slots and not torch.equal(got[3], want[3]):
            raise AssertionError(f"{what}: flags differ")
        if not torch.allclose(got[2], want[2], rtol=READOUT_RTOL, atol=0.0):
            raise AssertionError(f"{what} slots {slots}: lse off by "
                                 f"{float((got[2] - want[2]).abs().max())}")
    if (rt.readout_topk_rows.passes > p0) != (topk.k_plan(K)[1] > 1):
        raise AssertionError(f"{what}: passes {rt.readout_topk_rows.passes - p0}")
    if (rt.readout_topk_rows.bf16_launches - h0) != (2 if op != torch.float32
                                                      else 0):
        raise AssertionError(f"{what}: the bf16 instance's launches")
    print(f"{what} (R={R}, E={E}): depth K and slots 1 exact")


def phase_tensor_parallel(torch, np, dev, single):
    """Phase 23 (above); ``single``: phase 22's decodes in this process.
    Returns fields."""
    smi = _smi()
    root = _dp_root()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    f = {"card": smi, "slices": phase_tp_readout(torch, np, dev)}
    ranks = _dp_spawn(torch, TP_SPEC, "tp_one_card", "0")
    if {r["backend"] for r in ranks} != {"gloo"}:
        raise AssertionError(f"tp one card: backend "
                             f"{[r['backend'] for r in ranks]}, not gloo")
    want = _dp_train_run(torch, np, dev, None, TP_PRESET, keep=(TP_2X2_STEPS,))
    f["train"] = _dp_check_train(torch, ranks, want, "tp 1x2 one card (gloo)",
                                 smi, TP_LOSS_RTOL)
    with torch.inference_mode():
        single = dict(single, **_dp_decode_run(torch, np, dev, None,
                                               ("bf16", "unfused", "greedy")))
    f["decode"] = _dp_check_decode(ranks, single, "tp 1x2 one card (gloo)",
                                   smi)
    st = single["chunked"][1]
    f["step_split"] = {f"rank{i}": r["split"] for i, r in enumerate(ranks)}
    f["step_split"]["one_process_step_ms"] = \
        st["elapsed_s"] / st["beam_loop_steps"] * 1e3
    print(f"tp 1x2 beam step split [{smi}]: " + json.dumps(f["step_split"]))
    four = _dp_spawn(torch, TP_2X2_SPEC, "tp_2x2", "0", world=4)
    f["mesh_2x2"] = {
        "train": _dp_check_train(torch, four, want, "tp 2x2 one card (gloo)",
                                 smi, TP_LOSS_RTOL),
        "decode": _dp_check_decode(four, single, "tp 2x2 one card (gloo)",
                                   smi)}
    f["cli"] = _dp_cli(torch, np, smi, n_model=2)
    if torch.cuda.device_count() >= DP_WORLD:
        nccl = _dp_spawn(torch, TP_SPEC, "tp_nccl", ",".join(
            str(i) for i in range(DP_WORLD)))
        if {r["backend"] for r in nccl} != {"nccl"}:
            raise AssertionError(f"tp a card a rank: backend "
                                 f"{[r['backend'] for r in nccl]}")
        f["nccl"] = {
            "train": _dp_check_train(torch, nccl, want,
                                     "tp a card a rank (nccl)", smi,
                                     TP_LOSS_RTOL),
            "decode": _dp_check_decode(nccl, single,
                                       "tp a card a rank (nccl)", smi)}
    else:
        f["nccl"] = (f"did not run: {torch.cuda.device_count()} card visible, "
                     f"NCCL needs a card for each of the {DP_WORLD} ranks")
        print(f"tp nccl: {f['nccl']}")
    f["phase_s"] = time.perf_counter() - t0
    print(f"tp: ranks time-sharing one card; their times are no scaling "
          f"figure; phase 23 took {f['phase_s']:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return f


# Phase 24: the host modules of the last slice. (a) init_params draws the
# same bits at one intra-op thread and at this process's count (phases 22
# and 23 also hold OMP_NUM_THREADS=1 ranks against this process through
# it). (b) ResNet50 from a seeded
# state dict in torchvision's format, written to a file and loaded from
# it: a batch of RESNET_BATCH seeded 3 x 224 x 224 inputs on the card,
# pool5 held against the CPU forward of the same module on its first
# RESNET_CPU_ROWS images within RESNET_RTOL of the largest value, and the
# card's images/s at that batch, warm, the median of RESNET_REPS timed
# calls. (c) where PIL imports, the extract-features command (cli.main)
# on EXTRACT_IMAGES PNGs with a corpus, its weights found under
# TORCH_HOME: the sidecar checked by load_features, its rows against the
# CPU forward on RESNET_CPU_ROWS of them. The weights are random: no
# figure here is a pretrained network's.
RESNET_BATCH = 32
RESNET_CPU_ROWS = 4
RESNET_REPS = 10
# fp32 on the card (cuDNN, TF32 off) against fp32 on the CPU, over the
# largest pool5 value: both sum 53 convolutions in their own orders.
RESNET_RTOL = 1e-4
EXTRACT_IMAGES = 64


def _resnet_state(torch, seed=24):
    """Random weights in torchvision's resnet50 format (fc included):
    He-normal convolutions, BN scales and running variances in [0.5,
    1.5), small shifts."""
    from vag_nmt_tpu_torch.data.extract_features import ResNet50

    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in ResNet50().state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64)
        elif v.dim() == 4:
            out[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
        elif k.endswith(("weight", "running_var")):
            out[k] = 0.5 + torch.rand(v.shape, generator=g)
        else:
            out[k] = 0.1 * torch.randn(v.shape, generator=g)
    out["fc.weight"] = 0.01 * torch.randn((1000, 2048), generator=g)
    out["fc.bias"] = torch.zeros(1000)
    return out


def _phase_resnet(torch, np, dev, weights):
    from vag_nmt_tpu_torch.data import extract_features as ef

    model = ef.load_resnet50(weights)
    cpu_model = ef.load_resnet50(weights)
    model = model.to(dev)
    g = torch.Generator().manual_seed(24)
    x = torch.randn((RESNET_BATCH, 3, 224, 224), generator=g)
    xd = x.to(dev)
    with torch.inference_mode():
        got = model(xd)
        torch.cuda.synchronize()
        want = cpu_model(x[:RESNET_CPU_ROWS])
        if tuple(got.shape) != (RESNET_BATCH, ef.POOL5_DIM) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"resnet50 pool5: shape {tuple(got.shape)}, "
                                 f"finite {bool(torch.isfinite(got).all())}")
        scale = float(want.abs().max())
        err = float((got[:RESNET_CPU_ROWS].cpu() - want).abs().max())
        if not err <= RESNET_RTOL * scale:
            raise AssertionError(f"resnet50 pool5 on the card against the "
                                 f"CPU: max abs err {err} over scale {scale} "
                                 f"> {RESNET_RTOL}")
        ms = _time_ms(torch, lambda: model(xd), reps=RESNET_REPS, warmup=3)
    flops = _conv_flops(torch, model, x[:1]) * RESNET_BATCH
    bound = flops / FP32_PEAK_FLOPS * 1e3
    return {"batch": RESNET_BATCH, "max_abs_err": err, "scale": scale,
            "rtol": RESNET_RTOL, "batch_ms": ms,
            "images_per_s": RESNET_BATCH / ms * 1e3,
            "conv_gflop": flops / 1e9, "fp32_bound_ms": bound,
            "bound_share": bound / ms,
            "tf32": bool(torch.backends.cudnn.allow_tf32)}


# The H100 SXM's published fp32 rate outside the tensor cores (TF32 is off).
FP32_PEAK_FLOPS = 67e12


def _conv_flops(torch, model, x):
    """2 x the multiply-adds of every convolution of one forward of x (on
    the CPU, counted from each output's shape by forward hooks)."""
    total = [0]

    def hook(mod, _, out):
        k = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
        total[0] += 2 * out.numel() * k

    cpu = type(model)()
    hooks = [m.register_forward_hook(hook) for m in cpu.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            cpu(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def _phase_extract_command(np, root, weights_state):
    """(c): False where PIL does not import, else the command's fields."""
    import os

    try:
        from PIL import Image
    except ImportError:
        return False
    from vag_nmt_tpu_torch import cli
    from vag_nmt_tpu_torch.data import extract_features as ef
    from vag_nmt_tpu_torch.data.features import load_features

    imgs = root / "imgs"
    imgs.mkdir()
    rng = np.random.RandomState(24)
    names = []
    for i in range(EXTRACT_IMAGES):
        w, h = int(rng.randint(160, 640)), int(rng.randint(160, 640))
        names.append(f"img_{i:03d}.png")
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
            imgs / names[-1])
    (root / "images.txt").write_text("\n".join(names) + "\n")
    lines = [f"a synthetic caption number {i}" for i in range(EXTRACT_IMAGES)]
    (root / "corpus.en").write_text("\n".join(lines) + "\n")
    home = root / "torch_home"
    (home / "hub" / "checkpoints").mkdir(parents=True)
    os.replace(root / "resnet50.pth",
               home / "hub" / "checkpoints" / ef.WEIGHTS_FILE)
    out = root / "feats.npy"
    old = os.environ.get("TORCH_HOME")
    os.environ["TORCH_HOME"] = str(home)
    try:
        t0 = time.perf_counter()
        cli.main(["extract-features", "--image-dir", str(imgs),
                  "--image-list", str(root / "images.txt"),
                  "--corpus", str(root / "corpus.en"), "--out", str(out)])
        command_s = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("TORCH_HOME", None)
        else:
            os.environ["TORCH_HOME"] = old
    feats = np.asarray(load_features(str(out), expected_rows=EXTRACT_IMAGES,
                                     corpus_lines=lines))
    if not np.isfinite(feats).all():
        raise AssertionError("extract-features wrote non-finite features")
    try:
        load_features(str(out), expected_rows=EXTRACT_IMAGES,
                      corpus_lines=lines[::-1])
        raise AssertionError("extract-features: a reordered corpus passed "
                             "the sidecar's checksum")
    except ValueError:
        pass
    want = ef.extract_resnet50_pool5(
        [str(imgs / n) for n in names[:RESNET_CPU_ROWS]], device="cpu",
        weights=weights_state)
    scale = float(np.abs(want).max())
    err = float(np.abs(feats[:RESNET_CPU_ROWS] - want).max())
    if not err <= RESNET_RTOL * scale:
        raise AssertionError(f"extract-features on the card against the CPU: "
                             f"max abs err {err} over scale {scale}")
    return {"images": EXTRACT_IMAGES, "command_s": command_s,
            "max_abs_err": err, "scale": scale,
            "sidecar": json.loads((root / "feats.npy.align.json").read_text())}


def phase_host_modules(torch, np, dev):
    """Phase 24 (above). Returns fields."""
    import vag_nmt_tpu_torch as vt
    from vag_nmt_tpu_torch.train.state import tree_leaves

    smi = _smi()
    t0 = time.perf_counter()
    m = vt.preset("m30k_ende_vag").model
    n = torch.get_num_threads()
    draws = {}
    for threads in (1, n):
        torch.set_num_threads(threads)
        try:
            draws[threads] = tree_leaves(vt.init_params(
                m, torch.Generator().manual_seed(0), device="cpu"))
        finally:
            torch.set_num_threads(n)
    if not all(torch.equal(a, b) for a, b in zip(draws[1], draws[n])):
        raise AssertionError(f"init_params differs at 1 and {n} threads")
    f = {"card": smi, "init_threads": [1, n], "init_identical": True}
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_host"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        state = _resnet_state(torch)
        torch.save(state, root / "resnet50.pth")
        f["resnet50"] = _phase_resnet(torch, np, dev, root / "resnet50.pth")
        print(f"host resnet50 [{smi}]: " + json.dumps(f["resnet50"]))
        f["extract_command"] = _phase_extract_command(np, root, state)
        print(f"host extract-features ran: {bool(f['extract_command'])}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    f["phase_s"] = time.perf_counter() - t0
    return f


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
        "readout_topk_ms": sum(us for name, us in kernels.items()
                               if "readout_topk" in name) / 1e3,
        "dec_step_ms": sum(us for name, us in kernels.items()
                           if "dec_step" in name) / 1e3,
        # kernel 8's grid (legacy_topk.cu's blocks_kernel)
        "legacy_topk_blocks_ms": sum(us for name, us in kernels.items()
                                     if "blocks_kernel" in name) / 1e3,
        # every grid of kernel 3 carries its name (gru_bwd_*)
        "gru_bwd_ms_per_step": sum(us for name, us in kernels.items()
                                   if "gru_bwd" in name) / 1e3
                               / max(1, steps),
        # every grid of kernels 4 and 5 carries its kernel's name
        "dec_scan_fwd_ms_per_step": sum(us for name, us in kernels.items()
                                        if "dec_scan_fwd" in name) / 1e3
                                    / max(1, steps),
        "dec_scan_bwd_ms_per_step": sum(us for name, us in kernels.items()
                                        if "dec_scan_bwd" in name) / 1e3
                                    / max(1, steps),
        "top_kernels_ms": [[name[:80], us / 1e3] for name, us in top]}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import numpy as np

    if sys.argv[1:2] == ["--dp-worker"]:       # a rank of phase 22 or 23
        return _dp_worker(torch, np, sys.argv[2:])
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
    if sys.argv[1:] == ["--readout-grids"]:
        # kernel 1's whole call alone at READOUT_GRID_V and nothing else,
        # the same way for another tree's kernel: {V: fields}.
        print(json.dumps({"readout_grids": readout_grid_times(torch, np, dev)}))
        return 0
    if sys.argv[1:] == ["--dec-scan-grids"]:
        # kernels 4 and 5, each whole call alone and each of its grids, and
        # nothing else, the same way for another tree's kernels: fields.
        print(json.dumps({"dec_scan_grids": dec_scan_grid_times(torch, np, dev)}))
        return 0
    if sys.argv[1:] == ["--gru-bwd-grids"]:
        # kernel 3's whole call alone and each of its grids at
        # GRU_BWD_TIMED, and nothing else, the same way for another tree's
        # kernel: {label: fields}.
        print(json.dumps({"gru_bwd_grids": gru_bwd_grid_times(torch, np, dev)}))
        return 0
    if sys.argv[1:] == ["--dec-step-grids"]:
        # kernel 7's whole call alone and each of its grids, and nothing
        # else, the same way for another tree's kernel: fields.
        print(json.dumps({"dec_step_grids": dec_step_grid_times(torch, np, dev)}))
        return 0
    print(f"build_s: {_build.build_all():.2f}")
    # ptxas's spill report of every build (-Xptxas -v): kernels that spill,
    # as {build: {kernel: [store bytes, load bytes]}}, and how many do not
    spills = {n: _build.spills(n) for n in sorted(_build._KERNELS)}
    print("ptxas spills: " + json.dumps({
        "spilling": {n: {k: v for k, v in sp.items() if v != (0, 0)}
                     for n, sp in spills.items()
                     if any(v != (0, 0) for v in sp.values())},
        "kernels_without_spills": sum(v == (0, 0) for sp in spills.values()
                                      for v in sp.values())}))
    t0 = time.perf_counter()
    decode_kernels = [phase_readout(torch, np, dev), phase_gru(torch, np, dev)]
    wide = phase_wide_beams(torch, np, dev)
    widths = phase_gru_widths(torch, np, dev)
    train_kernels = [phase_gru_bwd(torch, np, dev), *phase_dec_scan(torch, np, dev)]
    bf16_kernels = phase_bf16_kernels(torch, np, dev)
    readout16 = phase_readout_bf16(torch, np, dev)
    dec_step16 = phase_dec_step_bf16(torch, np, dev)
    gru16_decode = phase_gru_bf16_decode(torch, np, dev)
    grid_times = phase_topk_grids(torch, np, dev)
    serve_kernels = [phase_beam_topk(torch, np, dev),
                     phase_dec_step(torch, np, dev)]
    ikea_kernels = [*phase_legacy_topk(torch, np, dev),
                    phase_readout_slots(torch, np, dev)]
    readout_grids = readout_grid_times(torch, np, dev)
    launches, grids, run = phase_main(torch, np, dev)
    phase_profile(torch, "decode (beam steps)", run)
    launches16, bf16_decode = phase_bf16_decode(torch, np, dev)
    bucketed = phase_bucketed(torch, np, dev)
    t_launches, t_grids, t_run, train_run = phase_train(torch, np, dev)
    phase_profile(torch, "train (steps)", t_run)
    b_instances, b_launches, b_grids, b_run = phase_train_bf16(torch, np, dev)
    phase_profile(torch, "train bf16 (steps)", b_run)
    try:
        s_launches, s_grids = phase_serve(torch, np, dev, train_run)
    finally:
        shutil.rmtree(train_run[0], ignore_errors=True)
    i_launches, i_grids = phase_ikea(torch, np, dev)
    cli = phase_cli(torch, np, dev)
    jax_run = phase_jax_run(torch, np, dev)
    dp, dp_single = phase_data_parallel(torch, np, dev)
    tp = phase_tensor_parallel(torch, np, dev, dp_single)
    host = phase_host_modules(torch, np, dev)
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
    # the bf16 instances: their launches in the bf16 training run (phase
    # 8c), where each of kernels 2-5 ran in bf16 only (the dev eval's
    # fp32 decode adds gru_fwd's other launches), and their grids
    for k in bf16_kernels:
        base = k["name"][:-len("_bf16")]
        k["launches"] = b_instances[k["name"]]
        k["grids"] = b_grids[base] // b_launches[base] * k["launches"]
    # kernels 1b and 7b: their launches in the bf16 decode (phase 20: the
    # default path for 1b, VAG_DEC_STEP=on for 7b); kernel 2b's at decode
    for k in (readout16, dec_step16):
        k["launches"] = launches16[k["name"]]
        k["grids"] = k["launches"] * (5 if k["name"] == "dec_step_bf16" else 1)
    for k in bf16_kernels:
        if k["name"] == "gru_fwd_bf16":
            k["decode_shapes"] = gru16_decode
            k["decode_launches"] = launches16["gru_fwd_bf16"]
    kernels = (decode_kernels + train_kernels + serve_kernels + ikea_kernels
               + bf16_kernels + [readout16, dec_step16])
    for k in kernels:
        k.update(grid_times.get((k["name"], TOPK_PATH_V.get(k["name"])), {}))
    # kernel 1: depth K at V=8000 (m30k) and the shallow slots at 16000
    # (ikea); the depth-K row also carries every field at both V.
    for k in kernels:
        if k["name"] in ("readout_topk", "readout_topk_slots"):
            g = readout_grids[8000 if k["name"] == "readout_topk" else 16000]
            k.update({f: g[f] for f in ("grid_ms", "grid_warm_ms",
                                        "slots1_grid_ms", "recovery_grid_ms",
                                        "addmm_grid_ms", "grid_floor_ms")})
    decode_kernels[0]["grids_by_v"] = readout_grids
    # the K <= 16 instances (phase 2b) and kernel 2's other widths (3b);
    # the command line's launches of each kernel, by command (phase 15)
    # (rows with a counter of their own: the slot mode's launches count in
    # readout_topk's, and phase 2b times depth K only)
    wrappers = _cli_wrappers()
    for k in kernels:
        if k["name"] in wide[WIDE_BEAMS[-1]]:
            k["wide_beams"] = {K: wide[K][k["name"]] for K in WIDE_BEAMS}
        if k["name"] in wrappers:
            k["cli_launches"] = {c: f["launches"].get(k["name"], 0)
                                 for c, f in cli.items()}
            passes = {c: f["launches"][f"{k['name']}_passes"]
                      for c, f in cli.items()
                      if f"{k['name']}_passes" in f["launches"]}
            if passes:
                k["cli_passes"] = passes
        if k["name"].endswith("_bf16"):
            k["cli_launches"] = {c: f["launches"].get(k["name"], 0)
                                 for c, f in cli.items()}
    decode_kernels[1]["widths"] = widths
    # each rank's launches on phase 22's paths: training (kernels 2-5) and
    # the chunked decode (kernels 1 and 2)
    for k in kernels:
        n = k["name"]
        per_rank = {}
        for i in range(DP_WORLD):
            r = dp["train"][f"rank{i}"]["launches"].get(n, 0) + \
                dp["decode"]["chunked"][f"rank{i}"]["launches"].get(n, 0)
            if r:
                per_rank[f"rank{i}"] = r
        if per_rank:
            k["dp_launches"] = per_rank
    # each rank's launches on phase 23's (1 x 2) paths: training (kernels
    # 2-5), the decodes (1 on its slices in fp32, 1b in bf16, 6 on the
    # gathered rows, 2 and 2b); kernel 1 alone on slices
    for k in kernels:
        n = k["name"]
        per_rank = {}
        for i in range(DP_WORLD):
            r = tp["train"][f"rank{i}"]["launches"].get(n, 0)
            for mode in TP_SPEC["decode"]:
                got = tp["decode"][mode][f"rank{i}"]["launches"]
                r += got.get(f"{n}_fp32", got.get(n, 0))
            if r:
                per_rank[f"rank{i}"] = r
        if per_rank:
            k["tp_launches"] = per_rank
    decode_kernels[0]["tp_slices"] = tp["slices"]
    print(f"jax run: {json.dumps(jax_run)}")
    print(f"bf16 decode: {json.dumps(bf16_decode)}")
    print(f"bucketed and super-chunk decode: {json.dumps(bucketed)}")
    print(f"data parallel: {json.dumps(dp)}")
    print(f"tensor parallel: {json.dumps(tp)}")
    print(f"host modules: {json.dumps(host)}")
    print(f"phases_s: {time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
