"""Tuning study of the decoder-scan kernels (``csrc/dec_scan_fwd.cu``,
``csrc/dec_scan_bwd.cu``, ``csrc/dec_scan.cuh``) on one NVIDIA GPU; no
path of the port runs it.

Run from the repository root:

    python3 -m vag_nmt_tpu_torch.ops.dec_scan_tune probe
    python3 -m vag_nmt_tpu_torch.ops.dec_scan_tune bench

``probe`` builds both kernels with parts taken out or changed (``PROBES``,
text edits of the sources: update them with the kernels; the outputs of
the builds that take parts out are wrong by design) and times each build's
whole call alone, cold and warm, through the wrappers, with each
recurrence phase's device ms from its barrier stamps (chip_smoke.py's
phase-7 inputs at training's (B, T, Tt) = (64, 24, 24), ``_grid_ms`` and
``_dec_scan_phases``), and counts the instructions of each build's
recurrence kernel without L2 slices, the one these shapes run
(``cuobjdump -sass``). ``bench`` times the machine's parts
the design rests on: a grid sync of one CTA a SM, the TF32 ``mma.sync``
rate at 1 and 4 independent accumulators a warp, with and without the
operand split, and the fp32 FMA rate. One JSON line per case.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys

_PRODUCT = "template <int NI, bool L2>\n__device__ __noinline__ void product_part("
_NO_LOADS = ("  const int r = row0 + mi * 16 + g;\n",
             "  const int r = row0 + mi * 16 + g;\n  M = 0;\n")
_NO_MMA = ("        mma_slab<NI, L2>(acc, cor, l, h, wres + (size_t)2 * s * NI * 32);",
           "        acc[0][0][0] += l.x + h.y;")
_SPLIT_TR = "__device__ __forceinline__ void split_tr(float x, uint32_t& big, uint32_t& small) {\n"
_PRODUCTS_TRUNCATED = [(
    "    split_tf32(s ? lo.z : lo.x, ab[s][0], asl[s][0]);\n"
    "    split_tf32(s ? hi.z : hi.x, ab[s][1], asl[s][1]);\n"
    "    split_tf32(s ? lo.w : lo.y, ab[s][2], asl[s][2]);\n"
    "    split_tf32(s ? hi.w : hi.y, ab[s][3], asl[s][3]);\n",
    "    split_tr(s ? lo.z : lo.x, ab[s][0], asl[s][0]);\n"
    "    split_tr(s ? hi.z : hi.x, ab[s][1], asl[s][1]);\n"
    "    split_tr(s ? lo.w : lo.y, ab[s][2], asl[s][2]);\n"
    "    split_tr(s ? hi.w : hi.y, ab[s][3], asl[s][3]);\n"),
    ("      split_tf32(bv.x, bb[s][ni][0], bs[s][ni][0]);\n"
     "      split_tf32(bv.y, bb[s][ni][1], bs[s][ni][1]);\n",
     "      split_tr(bv.x, bb[s][ni][0], bs[s][ni][0]);\n"
     "      split_tr(bv.y, bb[s][ni][1], bs[s][ni][1]);\n")]
_STREAMED_ROUNDED = [(_SPLIT_TR + "  big = __float_as_uint(x) & 0xffffe000u;\n"
                      "  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));\n",
                      _SPLIT_TR + "  split_tf32(x, big, small);\n")]
_PREFETCH = "constexpr int PREFETCH = VAG_PREFETCH;"
# Builds timed by ``probe``: (label, [(source text, replacement)]), the same
# edits for both kernels (the products, the split and the constants live in
# their shared header). An edit whose text is not in a source raises,
# naming the build (``_build.apply_edits``; tests/test_torch_tune.py checks
# every edit).
PROBES = (
    ("kernel", []),
    ("products inlined at every call site",
     [(_PRODUCT, "template <int NI, bool L2>\n__device__ __forceinline__ void product_part(")]),
    ("no activation loads in the products", [_NO_LOADS]),
    ("no mma in the products (activations loaded)", [_NO_MMA]),
    ("truncating split in the products", _PRODUCTS_TRUNCATED),
    ("rounded split in the streamed tiles", _STREAMED_ROUNDED),
    ("prefetch 2 slabs", [(_PREFETCH, "constexpr int PREFETCH = 2;")]),
    ("prefetch 8 slabs", [(_PREFETCH, "constexpr int PREFETCH = 8;")]),
    ("general kernel (column loop, L2 dispatch) at one tile a CTA",
     [("= plan_general(g.p, 4, plan[4]) ?", "= true ?")]),
)
KERNELS = ("dec_scan_fwd", "dec_scan_bwd")


def _sass_count(so, kernel: str) -> int:
    """Instructions of the function named ``kernel`` in library ``so``, or
    -1 where cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                             text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return -1
    for f in re.split(r"\n\s+Function : ", out)[1:]:
        if kernel in f.split("\n", 1)[0]:
            return len(re.findall(r"^\s+/\*[0-9a-f]+\*/\s+\S", f, re.M))
    return -1


def probe(torch, np, dev):
    """Each build of PROBES (``_build.build_variants``), timed through the
    wrappers with the builds in place of the kernels' libraries."""
    import chip_smoke as cs
    from vag_nmt_tpu_torch.ops import _build
    from vag_nmt_tpu_torch.ops import dec_scan as ds

    out = _build.BUILD_DIR.parent / "dec_scan_probe"
    libs = {n: _build.build_variants(n, PROBES, out / n) for n in KERNELS}
    label, *shape = cs._dec_scan_shapes()[0]
    inputs, weights, g_t = cs._dec_scan_case(torch, np, dev, *shape)
    want = ds.dec_scan_fwd_plain(*inputs, weights)
    xg_t, ctx, ctxp, mask = inputs[1], inputs[3], inputs[4], inputs[5]
    calls = {"dec_scan_fwd": lambda tm=None: ds.dec_scan_fwd(
                 *inputs, weights, impl="kernel", timers=tm),
             "dec_scan_bwd": lambda tm=None: ds.dec_scan_bwd(
                 want, xg_t, ctx, ctxp, mask, weights, g_t, impl="kernel",
                 timers=tm)}
    kw = {"hold": cs.READOUT_HOLD, "warm_hold": cs.READOUT_WARM_HOLD}
    for name in KERNELS:
        for i, (build, _) in enumerate(PROBES):
            with _build.loaded_as(name, libs[name][i]):
                cold, warm = cs._grid_ms(torch, calls[name], **kw)
                phases = cs._dec_scan_phases(torch, calls[name], name[-3:],
                                             shape[2])
            f = {"kernel": name, "build": build, "shape": label,
                 "grid_ms": cold, "grid_warm_ms": warm, "phases_ms": phases,
                 "sass_instructions": _sass_count(out / name / f"{name}_{i}.so",
                                                  f"{name}_kernelILb0E")}
            print("dec_scan probe: " + json.dumps(f), flush=True)


# The machine's parts: a grid sync, mma.sync TF32 and fp32 FMA rates.
_BENCH_SRC = r'''
#include <cooperative_groups.h>
#include "tf32_mma.cuh"

namespace cg = cooperative_groups;
using namespace vag;

__global__ void __launch_bounds__(256, 1) k_sync(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// NACC independent accumulator chains a warp, one mma a chain an iteration
template <int NACC, bool SPLIT>
__global__ void __launch_bounds__(256, 1) k_mma(int n, const float* in, float* out) {
  float acc[NACC][4] = {};
  const float x = in[threadIdx.x & 31];
  uint32_t a[4] = {__float_as_uint(x), __float_as_uint(x + 1.f),
                   __float_as_uint(x + 2.f), __float_as_uint(x + 3.f)};
  const uint32_t b[2] = {__float_as_uint(2.f * x), __float_as_uint(3.f * x)};
  for (int i = 0; i < n; ++i) {
    if (SPLIT) {
      uint32_t big, small;
      split_tf32(__uint_as_float(a[i & 3]) + 1e-3f, big, small);
      a[i & 3] = big ^ (small & 1u);
    }
#pragma unroll
    for (int j = 0; j < NACC; ++j) mma_tf32(acc[j], a, b);
  }
  float s = 0.f;
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

// 16 independent FMA chains a thread
__global__ void __launch_bounds__(256, 1) k_fma(int n, const float* in, float* out) {
  float acc[16];
  for (int j = 0; j < 16; ++j) acc[j] = in[j];
  const float x = in[threadIdx.x & 31], y = in[(threadIdx.x + 1) & 31];
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = fmaf(x, acc[j], y);
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += acc[j];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

// Device ms of case `which` (0 grid syncs, 1-4 mma with 1 / 4 chains,
// without / with the split, 5 fma) with n iterations on the SMs' count of
// CTAs of 256 threads; in and out hold 32 and ctas * 256 floats.
extern "C" int dec_scan_bench(int which, int n, int ctas, const float* in,
                              float* out, float* ms) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaError_t e = cudaSuccess;
  for (int rep = 0; rep < 2 && e == cudaSuccess; ++rep) {   // warm, then timed
    cudaEventRecord(a);
    switch (which) {
      case 0: {
        void* args[] = {&n};
        e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(k_sync),
                                        dim3(ctas), dim3(256), args, 0, 0);
        break;
      }
      case 1: k_mma<1, false><<<ctas, 256>>>(n, in, out); break;
      case 2: k_mma<4, false><<<ctas, 256>>>(n, in, out); break;
      case 3: k_mma<1, true><<<ctas, 256>>>(n, in, out); break;
      case 4: k_mma<4, true><<<ctas, 256>>>(n, in, out); break;
      default: k_fma<<<ctas, 256>>>(n, in, out); break;
    }
    if (e == cudaSuccess) e = cudaGetLastError();
    cudaEventRecord(b);
    cudaEventSynchronize(b);
  }
  cudaEventElapsedTime(ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return (int)e;
}
'''
# (label, case, operations an iteration per warp)
_BENCH_CASES = (("grid sync", 0, 0), ("mma tf32, 1 chain a warp", 1, 2048),
                ("mma tf32, 4 chains a warp", 2, 4 * 2048),
                ("mma tf32 + split, 1 chain a warp", 3, 2048),
                ("mma tf32 + split, 4 chains a warp", 4, 4 * 2048),
                ("fp32 fma, 16 chains a thread", 5, 2 * 16 * 32))


def bench(torch, dev):
    """Builds _BENCH_SRC with the kernels' flags and times each case."""
    from vag_nmt_tpu_torch.ops import _build

    out = _build.BUILD_DIR.parent / "dec_scan_bench"
    out.mkdir(parents=True, exist_ok=True)
    (out / "bench.cu").write_text(_BENCH_SRC)
    so = out / "bench.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", str(so), str(out / "bench.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.dec_scan_bench.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x = torch.zeros(32, device=dev)
    y = torch.zeros(sms * 256, device=dev)
    for label, case, ops in _BENCH_CASES:
        n = 1000 if case == 0 else 1 << 16
        ms = ctypes.c_float()
        rc = lib.dec_scan_bench(case, n, sms, x.data_ptr(), y.data_ptr(),
                                ctypes.addressof(ms))
        if rc != 0:
            raise RuntimeError(f"dec_scan bench {label}: CUDA error {rc}")
        f = {"case": label, "ms": ms.value}
        if case == 0:
            f["us_each"] = ms.value * 1e3 / n
        else:
            f["tflops"] = ops * n * 8 * sms / (ms.value * 1e-3) / 1e12
        print("dec_scan bench: " + json.dumps(f), flush=True)


def main(argv) -> int:
    import numpy as np
    import torch

    if argv not in (["probe"], ["bench"]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("dec_scan_tune: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if argv == ["probe"]:
        probe(torch, np, dev)
    else:
        bench(torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
