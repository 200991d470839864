"""The per-step products of the persistent recurrence kernels, as their
plans tile them: the constants of ``csrc/dec_scan.cuh`` (passed to every
source that includes it as -D defines), ``ScanProduct`` (the header's
``Prod``) and the tilings a product can take on a card. Shared by the
decoder scans' plan (``ops/dec_scan.py::dec_scan_plan``) and the GRU
backward's (``ops/gru_kernel.py::gru_bwd_plan``)."""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Tuple

# The kernels' constants, passed to csrc/dec_scan.cuh as -D defines: depth
# of a streamed product's chunk and stages of its cp.async ring, n8 tiles
# of a per-step product tile at most, 16-deep slabs of the activations a
# warp of a per-step product keeps in flight, loads a thread of the
# attention keeps in flight, rows and columns of a streamed-product tile
# (the time-parallel work before and after the loop). A CTA has THREADS
# threads.
BK, GSTAGES, NI_MAX, PREFETCH, ATT_BATCH, GM, GN = 32, 4, 3, 4, 16, 64, 64
THREADS = 256
WARPS = THREADS // 32
# The plans' choices: rows of a per-step tile (m16 tiles for the 8 warps:
# 2 or 4), units of a gate tile, columns of a plain tile, and how many
# column-pass counts of a product to try.
TILE_ROWS = (32, 64)
GATE_UNITS = (2, 4, 8)
PLAIN_COLS = (8, 16, 24)
COL_PASSES = 4   # column-pass counts the plan tries from the least that fits
_DEFINES = {"VAG_BK": BK, "VAG_GSTAGES": GSTAGES, "VAG_NI_MAX": NI_MAX,
            "VAG_PREFETCH": PREFETCH, "VAG_ATT_BATCH": ATT_BATCH, "VAG_GM": GM,
            "VAG_GN": GN}


def _up(x: int, m: int) -> int:
    return -(-x // m) * m

@dataclass(frozen=True)
class ScanProduct:
    """One per-step product out (rows, cols) = a (rows, depth) @ W as the
    kernel tiles it (csrc/dec_scan.cuh's Prod): ``col_tiles`` column tiles
    of ``tile_cols`` columns, either gate tiles (``unit_block`` units of H,
    their r, z and n columns at tile columns [0, ub), [ub, 2ub), [2ub, 3ub))
    or plain tiles of consecutive columns, and row parts of ``tile_rows``
    rows, on ``col_slots`` column slots of ``row_slots`` CTAs each. CTAs
    [cta0, cta0 + ctas) take it: CTA cta0 + c * row_slots + i takes column
    tiles c, c + col_slots, ... and row parts i, i + row_slots, ...; the
    weight slice of its k-th column tile sits in its shared memory at float
    ``woff`` + k * slice_floats or, when ``l2off`` >= 0, in the launch's
    weight buffer at l2off + ((cta - cta0) * col_passes + k) *
    slice_floats, read through L2. ``bf16``: the bf16 instances' slices,
    two weights a float."""
    name: str
    rows: int
    depth: int
    cols: int
    H: int
    unit_block: int
    tile_cols: int
    tile_rows: int
    row_slots: int
    col_tiles: int
    col_slots: int
    cta0: int = 0
    woff: int = 0
    l2off: int = -1
    bf16: bool = False

    @property
    def row_parts(self) -> int:
        return -(-self.rows // self.tile_rows)

    @property
    def ctas(self) -> int:
        return self.col_slots * self.row_slots

    @property
    def col_passes(self) -> int:
        """Column tiles of the busiest CTA."""
        return -(-self.col_tiles // self.col_slots)

    @property
    def slice_floats(self) -> int:
        """One column tile's weight slice, its depth padded to 16-deep
        slabs (in floats: halved for bf16 weights)."""
        return _up(self.depth, 16) * self.tile_cols // (2 if self.bf16 else 1)

    @property
    def region_floats(self) -> int:
        """A CTA's weight slices."""
        return self.col_passes * self.slice_floats

    @property
    def passes(self) -> int:
        """Tiles (column tile, row part) of the busiest CTA a step."""
        return self.col_passes * -(-self.row_parts // self.row_slots)

    @property
    def work(self) -> int:
        """Multiply-adds of the busiest CTA a step (padding included)."""
        return self.passes * self.tile_rows * self.tile_cols * _up(self.depth, 16)

    @property
    def part_floats(self) -> int:
        """The warps' k-slice accumulators, added in the epilogue."""
        return WARPS * (self.tile_cols // 8) * 32 * 4

    def launch_args(self) -> Tuple[int, ...]:
        return (self.unit_block, self.tile_cols, self.tile_rows,
                self.row_slots, self.col_tiles, self.col_slots, self.cta0,
                self.woff, self.l2off)

def _col_slots(col_tiles: int, most: int) -> List[int]:
    """Column slots of a product on at most ``most`` CTAs: the fewest
    column passes that fit and up to COL_PASSES - 1 more, and the passes
    that fit a half, a third and a quarter of ``most`` (room for a phase's
    other product); each as the fewest slots that give its passes."""
    if most < 1:
        return []
    least = -(-col_tiles // most)
    passes = set(range(least, least + COL_PASSES))
    passes |= {-(-col_tiles // max(1, most // d)) for d in (2, 3, 4)}
    return sorted({-(-col_tiles // m) for m in passes}, reverse=True)


def _product_options(spec, B: int, H: int, n_sms: int,
                     bf16: bool = False) -> List[ScanProduct]:
    name, depth, cols, gate = spec
    out = []
    widths = ([(ub, _up(3 * ub, 8)) for ub in GATE_UNITS] if gate
              else [(0, nt) for nt in PLAIN_COLS])
    for ub, nt in widths:
        if nt // 8 > NI_MAX:
            continue
        col_tiles = -(-H // ub) if gate else -(-cols // nt)
        for rt in TILE_ROWS:
            for nr in range(1, min(n_sms, -(-B // rt)) + 1):
                for cs in _col_slots(col_tiles, n_sms // nr):
                    out.append(ScanProduct(name, B, depth, cols, H, ub, nt,
                                           rt, nr, col_tiles, cs, bf16=bf16))
    return out


def _phase_options(phase, B: int, H: int, n_sms: int, bf16: bool = False):
    """Pareto set of (cost, slice floats, products) for one phase: its
    products on disjoint CTAs, at most n_sms in all."""
    opts = {}
    for combo in itertools.product(*(_product_options(s, B, H, n_sms, bf16)
                                      for s in phase)):
        if sum(p.ctas for p in combo) > n_sms:
            continue
        cost = max(p.work for p in combo)
        region = _up(max(p.region_floats for p in combo), 32)
        key = (cost, region)
        # ties: fewer passes over row parts a CTA, then fewer CTAs
        rank = (max(p.passes for p in combo),
                sum(p.ctas for p in combo),
                tuple((p.tile_rows, p.tile_cols) for p in combo))
        if key not in opts or rank < opts[key][0]:
            opts[key] = (rank, combo)
    front, best_region = [], None
    for (cost, region), (_, combo) in sorted(opts.items()):
        if best_region is None or region < best_region:
            front.append((cost, region, combo))
            best_region = region
    return front
