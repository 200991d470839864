"""Tuning study of the persistent GRU forward kernel (``csrc/gru_fwd.cu``)
on one NVIDIA GPU; no path of the port runs it.

Run from the repository root:

    python3 -m vag_nmt_tpu_torch.ops.gru_fwd_tune sweep
    python3 -m vag_nmt_tpu_torch.ops.gru_fwd_tune probe

``sweep`` checks each tiling of ``SWEEP`` against the plain version (both
directions, chip_smoke's ``GRU_ATOL``) and times its grid alone, cold and
warm. ``probe`` builds ``csrc/gru_fwd.cu`` with parts of a step taken out
(``PROBES``; the outputs are wrong by design) and times each build's grid
alone at chip_smoke's ``GRU_SHAPES`` under the card's plan, to see what a
step's time is made of. Both print one JSON line per case and use
chip_smoke.py's inputs (``_gru_case``) and grid timer (``_grid_ms``).
"""

from __future__ import annotations

import json
import sys

# Tilings timed by ``sweep`` (B, T, rows a thread, row_block, unit_block,
# chunk, row_slots); H = chip_smoke.GRU_H. The first of each shape is
# gru_fwd_plan's on an H100.
SWEEP = (
    (1024, 32, 8, 128, 32, 16, 8), (1024, 8, 8, 128, 32, 16, 8),
    (1024, 32, 8, 256, 16, 32, 4), (1024, 32, 4, 64, 32, 32, 8),
    (512, 120, 4, 64, 32, 32, 8), (512, 120, 8, 64, 32, 32, 8),
    (512, 120, 8, 128, 16, 32, 4),
    (64, 24, 1, 8, 32, 128, 8), (64, 24, 1, 16, 32, 128, 4),
    (64, 24, 2, 16, 32, 128, 4))

# Builds timed by ``probe``: (label, [(source text, replacement)]). An edit
# whose text is not in the source raises, naming the build
# (``_build.apply_edits``; tests/test_torch_tune.py checks every edit).
_REG_STATE = ("hv[i] = *reinterpret_cast<const float4*>(hrow + i * rstride + kq);",
              "hv[i] = make_float4(__int_as_float(kq + i + 1), 1.f, 2.f, 3.f);")
_REG_UH = ("for (int m = 0; m < W / 4; ++m) wv[m] = w4[m];",
           "for (int m = 0; m < W / 4; ++m)"
           " wv[m] = make_float4(__int_as_float(kq + m), 1.f, 2.f, 3.f);")
_NO_LOADS = [("if (c < NC) load_chunk(c);", ""),
             ("if (c + STAGES - 1 < NC) load_chunk(c + STAGES - 1);", "")]
_NO_PRODUCT = ("for (int kq = 0; kq < KC; kq += 4) {",
               "for (int kq = 0; kq < 0; kq += 4) {")
_NO_SYNC = ("if (step + 1 < T) grid.sync();", "")
PROBES = (
    ("kernel", []),
    ("state operand from registers", [_REG_STATE]),
    ("Uh operand from registers", [_REG_UH]),
    ("both operands from registers", [_REG_STATE, _REG_UH]),
    ("both from registers, no state loads", [_REG_STATE, _REG_UH, *_NO_LOADS]),
    ("no product, no state loads", [_NO_PRODUCT, *_NO_LOADS]),
    ("no product, no state loads, no grid sync",
     [_NO_PRODUCT, *_NO_LOADS, _NO_SYNC]))


def sweep(torch, np, dev):
    """Each tiling of SWEEP against the plain version, then timed."""
    import chip_smoke as cs
    from vag_nmt_tpu_torch.ops import _build
    from vag_nmt_tpu_torch.ops.gru_kernel import (GruFwdPlan, _launch,
                                                  gru_fwd_plain)

    fn, H = _build.load("gru_fwd").gru_fwd_launch, cs.GRU_H
    for B, T, R, RB, UB, KC, GX in SWEEP:
        plan = GruFwdPlan(R, RB, UB, KC, -(-B // RB), GX, H // UB)
        _, p, xg_t, mask_t, h0 = cs._gru_case(torch, np, dev, B, T, seed=2)
        args = (xg_t, mask_t, p["uh"], p["bh"], h0)
        err = max(float((_launch(fn, plan, *args, r)
                         - gru_fwd_plain(*args, reverse=r)).abs().max())
                  for r in (False, True))
        if not err <= cs.GRU_ATOL:
            raise AssertionError(f"gru_fwd {plan}: max abs err {err}")
        cold, warm = cs._grid_ms(torch, lambda: _launch(fn, plan, *args, False))
        print("gru_fwd sweep: " + json.dumps(
            {"B": B, "T": T, "R": R, "RB": RB, "UB": UB, "KC": KC,
             "grid": list(plan.grid), "threads": plan.threads,
             "passes": plan.passes, "grid_ms": cold, "grid_warm_ms": warm,
             "step_us": 1e3 * cold / T, "max_abs_err": err}), flush=True)


def probe(torch, np, dev):
    """Each build of PROBES (``_build.build_variants``), timed."""
    import chip_smoke as cs
    from vag_nmt_tpu_torch.ops import _build
    from vag_nmt_tpu_torch.ops.gru_kernel import (_device_limits, _launch,
                                                  gru_fwd_plan)

    fns = [lib.gru_fwd_launch for lib in _build.build_variants(
        "gru_fwd", PROBES, _build.BUILD_DIR.parent / "gru_probe")]
    for label, B, T in cs.GRU_SHAPES:
        _, p, xg_t, mask_t, h0 = cs._gru_case(torch, np, dev, B, T, seed=2)
        args = (xg_t, mask_t, p["uh"], p["bh"], h0)
        plan = gru_fwd_plan(B, cs.GRU_H, *_device_limits(xg_t.device))
        for (name, _), fn in zip(PROBES, fns):
            cold, warm = cs._grid_ms(torch, lambda: _launch(fn, plan, *args,
                                                            False))
            print("gru_fwd probe: " + json.dumps(
                {"shape": label, "build": name, "grid_ms": cold,
                 "grid_warm_ms": warm, "step_us": 1e3 * cold / T}), flush=True)


def main(argv) -> int:
    import numpy as np
    import torch

    if argv not in (["sweep"], ["probe"]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("gru_fwd_tune: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    (sweep if argv == ["sweep"] else probe)(torch, np, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
