"""Tuning study of the fused readout top-K kernel (``csrc/readout_topk.cu``)
on one NVIDIA GPU; no path of the port runs it.

Run from the repository root:

    python3 -m vag_nmt_tpu_torch.ops.readout_topk_tune probe

``probe`` builds ``csrc/readout_topk.cu`` with parts taken out or changed
(``PROBES``, text edits of the source: update them with the kernel; the
outputs of all but the first are wrong by design) and times each build's
whole call alone, cold and warm, through the wrapper (chip_smoke.py's
``readout_grid_times`` inputs and ``_grid_ms``), at R=640, E=256, K=5,
V=8000 and 16000, at depth K and at slots 1. One JSON line per case.
"""

from __future__ import annotations

import json
import sys

_NO_FOLD = ("      if (row >= p.R) continue;", "      if (row >= 0) continue;")
_NO_INSERT = ("? insert<SK>(sv[r], si[r], x[j], col) : x[j];", "? x[j] : x[j];")
_ONE_PASS = ("        mma_tf32(acc[mi][ni], as[mi], bb[ni]);\n"
             "        mma_tf32(acc[mi][ni], ab[mi], bs[ni]);\n", "")
_NO_MMA = ("        mma_tf32(acc[mi][ni], ab[mi], bb[ni]);\n",
           "        asm volatile(\"\" :: \"r\"(ab[mi][0]), \"r\"(ab[mi][1]), \"r\"(ab[mi][2]),"
           " \"r\"(ab[mi][3]), \"r\"(as[mi][0]), \"r\"(as[mi][1]), \"r\"(as[mi][2]),"
           " \"r\"(as[mi][3]), \"r\"(bb[ni][0]), \"r\"(bb[ni][1]), \"r\"(bs[ni][0]),"
           " \"r\"(bs[ni][1]));\n")
_NO_LOADS = [("    if (q < n_q)\n      load_chunk(", "    if (q < 0)\n      load_chunk("),
             ("    if (qn < n_q)\n      load_chunk(", "    if (qn < 0)\n      load_chunk(")]
_CVT_SPLIT = ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
              "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));"
              "\n  return r;")
_RAW_SMALL = ("  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));",
              "  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));")
_NO_W_LOADS = ("  for (int i = tid; i < BK * (BN / VEC); i += THREADS) {",
               "  for (int i = tid; i < 0; i += THREADS) {")
_BK32 = [("constexpr int BK = VAG_BK; ", "constexpr int BK = 32; "),
         ("constexpr int STAGES = 3; ", "constexpr int STAGES = 4; ")]
_T256 = [("constexpr int THREADS = 512;", "constexpr int THREADS = 256;"),
         ("constexpr int WARPS_M = 2, WARPS_N = 8;", "constexpr int WARPS_M = 2, WARPS_N = 4;")]
# Builds timed by ``probe``: (label, [(source text, replacement)]). An edit
# whose text is not in the source raises, naming the build
# (``_build.apply_edits``; tests/test_torch_tune.py checks every edit).
PROBES = (
    ("kernel", []),
    ("32-deep chunks, 4 stages", _BK32),
    ("256 threads, 32 x 32 warp tiles", _T256),
    ("split by cvt.rna", [_CVT_SPLIT]),
    ("remainder not rounded (the mma drops its low bits)", [_RAW_SMALL]),
    ("no W loads", [_NO_W_LOADS]),
    ("no fold", [_NO_FOLD]),
    ("fold without the top-K insertion", [_NO_INSERT]),
    ("one TF32 product (no remainders)", [_ONE_PASS]),
    ("no mma (operands loaded and split)", [_ONE_PASS, _NO_MMA]),
    ("no ring loads", _NO_LOADS),
    ("no fold, no ring loads", [_NO_FOLD, *_NO_LOADS]),
    ("no fold, no mma", [_NO_FOLD, _ONE_PASS, _NO_MMA]),
    ("no fold, no mma, no ring loads", [_NO_FOLD, _ONE_PASS, _NO_MMA, *_NO_LOADS]),
)


def probe(torch, np, dev):
    """Each build of PROBES (``_build.build_variants``), timed through the
    wrapper with the build in place of the kernel's library."""
    import chip_smoke as cs
    from vag_nmt_tpu_torch.ops import _build
    from vag_nmt_tpu_torch.ops import readout_topk as rt

    libs = _build.build_variants("readout_topk", PROBES,
                                 _build.BUILD_DIR.parent / "readout_probe")
    R, E, K = 640, 256, 5
    kw = {"hold": cs.READOUT_HOLD, "warm_hold": cs.READOUT_WARM_HOLD}
    for V in cs.READOUT_GRID_V:
        rng = np.random.RandomState(V + 7)
        t = torch.from_numpy(np.tanh(rng.randn(R, E)).astype(np.float32)).to(dev)
        w = torch.from_numpy((0.05 * rng.randn(E, V)).astype(np.float32)).to(dev)
        b = torch.from_numpy((0.1 * rng.randn(V)).astype(np.float32)).to(dev)
        for (label, _), lib in zip(PROBES, libs):
            f = {"V": V, "build": label}
            with _build.loaded_as("readout_topk", lib):
                for what, slots in (("depth_k", 0), ("slots1", 1)):
                    cold, warm = cs._grid_ms(torch, lambda: rt.readout_topk_rows(
                        t, w, b, K, slots=slots, impl="kernel"), **kw)
                    f[f"{what}_grid_ms"], f[f"{what}_grid_warm_ms"] = cold, warm
            print("readout_topk probe: " + json.dumps(f), flush=True)


def main(argv) -> int:
    import numpy as np
    import torch

    if argv != ["probe"]:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("readout_topk_tune: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    probe(torch, np, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
