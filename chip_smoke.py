#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. card and build: the card's name and power limit, and the build of every
     hand-written kernel under vag_nmt_tpu_torch/csrc/ (one nvcc each, all
     started together);
  2. readout_topk kernel against its plain PyTorch version at the beam-5
     decode shape of m30k_ende_vag (R=640 rows, E=256, V=8000, K=5);
  3. gru_fwd kernel against its plain version at the encoder's super-chunk
     shape (B=1024, T=32, E=256, H=512), ragged lengths, both directions;
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
     shape (B=128, K=5, V=8000), exactly, with finished rows and forced ties;
 10. dec_step kernel against its plain version at full width (B=128, K=5,
     T=32) and at a ragged shape, with masked source positions;
 11. the serving path: Translator.from_run on phase 8's run dir (its
     checkpoint, plus config.json and vocab files written here), then a
     1024-line raw-text request at batch 128 in six modes: (a) the default
     streaming pool, (b) the pool with VAG_DEC_STEP=on, (c) streaming off,
     (d) VAG_READOUT_TOPK=unfused, (e) bulk=True, (f) greedy on 128 lines;
     each kernel's launches read from each mode alone, the shares of
     identical hypotheses between modes, and (a) and (b) under the profiler.
Phase 1 builds all seven sources. It prints one JSON line of per-kernel
numbers and, last, the device line.
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
    times.sort()
    return times[len(times) // 2] if len(times) % 2 else 0.5 * (
        times[len(times) // 2 - 1] + times[len(times) // 2])


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


def phase_gru(torch, np, dev):
    from vag_nmt_tpu_torch.ops.gru import init_gru_params
    from vag_nmt_tpu_torch.ops.gru_kernel import gru_fwd, gru_fwd_plain

    B, T, E, H = 1024, 32, 256, 512
    rng = np.random.RandomState(2)
    p = {k: v.to(dev) for k, v in
         init_gru_params(torch.Generator().manual_seed(2), E, H).items()}
    p["bi"] = torch.from_numpy((0.1 * rng.randn(3 * H)).astype(np.float32)).to(dev)
    p["bh"] = torch.from_numpy((0.1 * rng.randn(3 * H)).astype(np.float32)).to(dev)
    x = torch.from_numpy((0.5 * rng.randn(T, B, E)).astype(np.float32)).to(dev)
    lens = torch.from_numpy(rng.randint(4, T + 1, B)).to(dev)
    mask_t = (torch.arange(T, device=dev)[:, None] < lens[None, :]).float().contiguous()
    xg_t = (x @ p["wi"] + p["bi"]).contiguous()
    h0 = torch.zeros((B, H), device=dev)
    max_err = 0.0
    for reverse in (False, True):
        hk = gru_fwd(xg_t, mask_t, p["uh"], p["bh"], h0, reverse=reverse,
                     impl="kernel")
        hp = gru_fwd_plain(xg_t, mask_t, p["uh"], p["bh"], h0, reverse=reverse)
        torch.cuda.synchronize()
        err = float((hk - hp).abs().max())
        if not err <= GRU_ATOL:
            raise AssertionError(f"gru_fwd reverse={reverse}: max abs err {err}")
        max_err = max(max_err, err)
        print(f"gru_fwd reverse={reverse}: ok (max abs err {err:.3g})")

    ms = _time_ms(torch, lambda: gru_fwd(xg_t, mask_t, p["uh"], p["bh"], h0,
                                         impl="kernel"), reps=20)
    plain_ms = _time_ms(torch, lambda: gru_fwd_plain(xg_t, mask_t, p["uh"],
                                                     p["bh"], h0), reps=10)
    # Yardstick only (the port never calls it): cuDNN's GRU at the same
    # (T, B, E, H), fp32 with TF32 off; it also does the input projection.
    cudnn = torch.nn.GRU(E, H).to(dev)
    with torch.no_grad():
        library_ms = _time_ms(torch, lambda: cudnn(x), reps=20)
    flops = 2.0 * T * B * H * 3 * H
    nbytes = 4.0 * (T * B * 3 * H + T * B + H * 3 * H + 3 * H + B * H + T * B * H)
    bound_ms, bound_by = _bound(flops, nbytes)
    print(f"gru_fwd (one direction): kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    return {"name": "gru_fwd", "route": "cuda",
            "source": "vag_nmt_tpu_torch/csrc/gru_fwd.cu",
            "replaces": "vag_nmt_tpu/ops/pallas_gru.py:114",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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


def phase_beam_topk(torch, np, dev):
    """beam_topk against beam_topk_plain at the unfused beam step's shape:
    ids and values exactly, with finished rows and forced ties (integer
    logits repeated across a sentence's beams under equal scores, so
    candidates tie within rows, across rows and across beams)."""
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
    print(f"build_s: {_build.build_all():.2f}")
    t0 = time.perf_counter()
    decode_kernels = [phase_readout(torch, np, dev), phase_gru(torch, np, dev)]
    train_kernels = [phase_gru_bwd(torch, np, dev), *phase_dec_scan(torch, np, dev)]
    serve_kernels = [phase_beam_topk(torch, np, dev),
                     phase_dec_step(torch, np, dev)]
    launches, grids, run = phase_main(torch, np, dev)
    phase_profile(torch, "decode (beam steps)", run)
    t_launches, t_grids, t_run, train_run = phase_train(torch, np, dev)
    phase_profile(torch, "train (steps)", t_run)
    try:
        s_launches, s_grids = phase_serve(torch, np, dev, train_run)
    finally:
        shutil.rmtree(train_run[0], ignore_errors=True)
    # Each kernel's launches come from the run of its own path: the decode
    # path for the decode kernels, the training path for the training
    # kernels, the serving modes that select them for beam_topk and dec_step.
    for ks, ln, gr in ((decode_kernels, launches, grids),
                       (train_kernels, t_launches, t_grids),
                       (serve_kernels, s_launches, s_grids)):
        for k in ks:
            k["launches"] = ln[k["name"]]
            k["grids"] = gr[k["name"]]    # device grids those launches enqueued
    kernels = decode_kernels + train_kernels + serve_kernels
    print(f"phases_s: {time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
