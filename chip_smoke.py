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
     of the host wall, device launches per beam step and the top kernels.
It prints one JSON line of per-kernel numbers and, last, the device line.
Needs torch with CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# fp32 peak outside the tensor cores and HBM rate of one H100 SXM
# (NVIDIA data sheet); the bounds below are against these.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

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
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
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
    return launches, grids, lambda: run("auto")


def phase_profile(torch, run):
    """One run of the main path under torch.profiler, device activity only.
    One stream, so kernels do not overlap and their summed time is the
    device's busy time; the idle share is 1 - busy / host wall. The
    profiler's own host cost makes the wall, and so the idle share, an upper
    estimate."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, st = run()
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
    print("profile: " + json.dumps({
        "beam_loop_steps": st["beam_loop_steps"], "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        # None: the profiler saw no device activity (not measured)
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        "device_launches": n_launch,
        "device_launches_per_step": n_launch / max(1, st["beam_loop_steps"]),
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
    kernels = [phase_readout(torch, np, dev), phase_gru(torch, np, dev)]
    launches, grids, run = phase_main(torch, np, dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["grids"] = grids[k["name"]]     # device grids those launches enqueued
    phase_profile(torch, run)
    print(f"phases_s: {time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
