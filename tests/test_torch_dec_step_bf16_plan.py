"""Kernel 7b's design (``csrc/dec_step_bf16.cu``) modelled in plain torch on
the CPU: its tiling (``ops/dec_step.py::dec_step_bf16_plan``: 64-row tiles in
64-deep stages, gate tiles holding the r, z and n columns of 32 units as
three 32-column boxes, qh tiles of two 64-column boxes, tc tiles of three
32-column boxes, the readout in 32-column tiles over its whole depth), its
products (bf16 values, each 16-deep step's products exact, summed into one
fp32 accumulator per output in ascending depth), the GRU cells on the gate
tiles' accumulators with s~ and s' rounded to bf16 once each, the
attention's context rounded once, and the readout on its accumulators in
the plain order. The plan's tile counts are the kernel launch's arguments
(``launch_tiles``), so its coverage here is the launched grids'. The model
is held against ``dec_step_plain`` and the JAX package's
``pallas_decode_step`` (interpret mode on the CPU) on bf16 operands; the
CUDA kernel is held against the same plain version on the card by
chip_smoke.py (phase 18).

Tolerances: against the plain version at chip_smoke's shapes its own
BF16_STATE_ATOL on the bf16 states and BF16_RTOL on t over its scale (a
state may round to the bf16 value either side of a boundary); against the
JAX kernel those of tests/test_torch_bf16_decode.py (STATE_ATOL, SCALE_TOL);
the product model within a tenth of DEC_STEP_RTOL of fp64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from tests.test_torch_bf16_decode import (SCALE_TOL, STATE_ATOL, _dec_step_case,
                                          _np, _scale_close)
from tests.test_torch_readout_plan import product_bf16_k16
from vag_nmt_tpu.models import decoder as jdec
from vag_nmt_tpu.ops.attention import precompute_ctx_proj as j_ctx_proj
from vag_nmt_tpu.ops.pallas_dec_step import pallas_decode_step

from vag_nmt_tpu_torch.models import decoder as tdec
from vag_nmt_tpu_torch.ops import _build
from vag_nmt_tpu_torch.ops import dec_step as ds
from vag_nmt_tpu_torch.ops.attention import precompute_ctx_proj
from vag_nmt_tpu_torch.ops.gru_kernel import gru_gate_algebra, rbf

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

BF = torch.bfloat16
CPU = torch.device("cpu")
FULL = cs._dec_step_full()
# chip_smoke's full-width shape, its ragged and odd shapes (widths no
# multiples of 8: the copy path), one beam, one sentence, phase 18's K = 12
# and 20, narrow widths, and all ones
PLAN_SHAPES = [FULL, cs.DEC_STEP_RAGGED, cs.DEC_STEP_ODD, cs._dec_step_full(K=1),
               cs._dec_step_full(B=1), cs._dec_step_full(K=12),
               cs._dec_step_full(K=20), (3, 2, 5, 10, 6, 14, 7), (1, 1, 1, 1, 1, 1, 1)]
# the wgmma shapes hopper_mma.cuh instantiates (m64nNk16)
WGMMA_N = (32, 96, 128)


def _widths(shape):
    B, K, T, H, A, C, R = shape
    return B * K, H, A, C, R


def _outputs(g):
    return {"hg1": 3 * g.H, "qh": g.cols, "xc": 3 * g.H + g.cols, "sw": g.cols}[g.name]


def _boxes(g, ct):
    """b's first column of each B box of tile ct, as the kernel's producer
    places them (gate tiles: box j at j H + ct ub; plain tiles: col0 +
    (ct - gate_tiles) tile_cols + j box)."""
    n = g.tile_cols // g.box
    if ct < g.gate_tiles:
        return [j * g.H + ct * g.ub for j in range(n)]
    return [g.col0 + (ct - g.gate_tiles) * g.tile_cols + j * g.box for j in range(n)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_covers_every_output_once_and_fits(shape):
    """Every output column of each product in one tile (the gate tiles' r,
    z, n columns of their units), each tile's columns its B boxes side by
    side, one wgmma shape of the engine per product, the depth in one
    split, and the launch's arguments in the form dec_step_launch takes.
    (The block's shared memory depends only on the tile width: the
    kernel's static_assert holds Tile::SMEM within 227 KB.)"""
    N, H, A, C, R = _widths(shape)
    plan = ds.dec_step_bf16_plan(N, H, A, C, R)
    assert [g.name for g in plan] == ["hg1", "qh", "xc", "sw"]
    assert [g.depth for g in plan] == [H, H, C, H]
    assert [g.box for g in plan] == [32, 64, 32, 32]
    for g in plan:
        seen = np.zeros(_outputs(g), dtype=np.int64)
        assert g.tile_cols in WGMMA_N and g.tile_cols % g.box == 0
        for ct in range(g.col_tiles):
            cols = g.b_columns(ct)
            boxes = _boxes(g, ct)
            for j, c in enumerate(cols):
                if c >= 0:
                    seen[c] += 1
                    assert c == boxes[j // g.box] + j % g.box
            if ct < g.gate_tiles:
                u = cols[:g.ub]
                assert cols[g.ub:2 * g.ub] == [c + H if c >= 0 else -1 for c in u]
                assert cols[2 * g.ub:] == [c + 2 * H if c >= 0 else -1 for c in u]
        np.testing.assert_array_equal(seen, 1)
        assert g.splits == 1 and g.kchunk == g.depth
        assert (g.row_tiles - 1) * ds.BM < N <= g.row_tiles * ds.BM
    gt1, ct1, gt2, ct2, gt3, ct3, gt4, ct4, kchunk = ds.launch_tiles(plan)
    assert gt1 == ct1 >= 1 and gt2 == gt4 == 0 and ct2 >= 1 and ct4 >= 1
    assert 1 <= gt3 < ct3 and kchunk >= H


def test_full_width_plan():
    """At the serving shape: 160 to 190 blocks a product grid on the H100's
    132 SMs but for the readout's 80 (its 256 columns in 32-column tiles,
    the depth not split)."""
    plan = ds.dec_step_bf16_plan(*_widths(FULL))
    assert {g.name: g.row_tiles * g.col_tiles for g in plan} == {
        "hg1": 160, "qh": 160, "xc": 190, "sw": 80}


def test_bf16_builds_are_their_own_source():
    """The bf16 instances build csrc/dec_step_bf16.cu with the bf16 plan's
    constants; dec_step.cu keeps no bf16 branch."""
    for base in ("dec_step", "dec_step_k16"):
        fns, defs, src = _build._KERNELS[f"{base}_bf16"]
        assert src == "dec_step_bf16" and _build._KERNELS[base][2] == "dec_step"
        assert (defs["VAG_UB"], defs["VAG_BN"], defs["VAG_RN"], defs["VAG_STAGES"]) == (
            ds.BF16_UB, ds.BF16_BN, ds.BF16_RN, ds.BF16_STAGES)
        assert defs["VAG_BF16"] == 1 and defs["VAG_MAX_K"] == _build._KERNELS[base][1]["VAG_MAX_K"]
        assert list(fns) == ["dec_step_launch"]
    src = (_build.CSRC / "dec_step.cu").read_text()
    assert "VAG_DS_BF16" not in src and "VAG_BF16" not in src


def _ctx_cols(C):
    """csrc/dec_step_bf16.cu's ctx_cols: the context columns of each of a
    sentence's context CTAs, C in BF16_ATT_PARTS parts of whole 8-column
    groups."""
    return (-(-C // ds.BF16_ATT_PARTS) + 7) // 8 * 8


def _quarters(T):
    """The kernel's position ranges of the context sums' quarters."""
    return [(h * T // 4, (h + 1) * T // 4) for h in range(4)]


def _context_quarters(w, ctx):
    """The kernel's context sums on (B, K, T) weights and (B, T, C) ctx:
    each quarter's positions summed in ascending order in fp32, the
    quarters added (q0 + q1) + (q2 + q3)."""
    q = []
    for j0, j1 in _quarters(w.shape[2]):
        acc = torch.zeros(w.shape[0], w.shape[1], ctx.shape[2])
        for j in range(j0, j1):
            acc = acc + w[:, :, j, None] * ctx[:, None, j, :]
        q.append(acc)
    return (q[0] + q[1]) + (q[2] + q[3])


@pytest.mark.parametrize("T,C", [(32, 1024), (7, 37), (1, 1), (33, 1030), (5, 8)])
def test_context_sums_cover_every_position_and_column_once(T, C):
    """The attention's context sums: a sentence's context CTAs take every
    column once, in whole 8-column groups where C is a multiple of 8 (one
    16-byte load a position); the quarters take every position once; the
    quarter sums within 1e-6 of fp64 over their scale."""
    per = _ctx_cols(C)
    seen = np.zeros(C, dtype=np.int64)
    for rank in range(ds.BF16_ATT_PARTS):
        c0, c1 = min(C, rank * per), min(C, rank * per + per)
        seen[c0:c1] += 1
        if C % 8 == 0:
            assert c0 % 8 == 0 and (c1 - c0) % 8 == 0
    np.testing.assert_array_equal(seen, 1)
    pos = np.zeros(T, dtype=np.int64)
    for j0, j1 in _quarters(T):
        pos[j0:j1] += 1
    np.testing.assert_array_equal(pos, 1)
    rng = np.random.RandomState(T + C)
    w = torch.softmax(torch.from_numpy(rng.randn(2, 3, T).astype(np.float32)), -1)
    ctx = torch.from_numpy(rng.randn(2, T, C).astype(np.float32)).to(BF).float()
    exact = torch.einsum("bkt,btc->bkc", w.double(), ctx.double())
    err = (_context_quarters(w, ctx).double() - exact).abs().max()
    assert err / exact.abs().max() <= 1e-6


def _model(gy, s, ctx, ctxpb, mask, weights, cover=None):
    """csrc/dec_step_bf16.cu in torch on fp32 tensors holding the bf16
    values: the products tile by tile (``product_bf16_k16``), GRU1 and GRU2
    on the gate tiles' accumulators, s~, c and s' rounded to bf16 once
    (``rbf``), the energies as the plain version and the context sums in
    quarters (``_context_quarters``), the readout on its
    tiles' accumulators. ``cover`` counts each product's outputs written."""
    uh1, bh1, w_s, bh2, va, w_c, bi2, ws, b = weights
    B, T, C = ctx.shape
    N, H = s.shape
    K = N // B
    A = w_s.shape[1] - 3 * H
    R = ws.shape[1]
    plan = {g.name: g for g in ds.dec_step_bf16_plan(N, H, A, C, R)}

    def tiles(g, a, w):
        for rt in range(g.row_tiles):
            rows = torch.arange(rt * ds.BM, min(N, (rt + 1) * ds.BM))
            for ct in range(g.col_tiles):
                cols = torch.tensor(g.b_columns(ct))
                inb = cols >= 0
                acc = torch.zeros(len(rows), g.tile_cols)
                acc[:, inb] = product_bf16_k16(a[rows], w[:, cols[inb]])
                if cover is not None:
                    cover[g.name][rows[:, None], cols[inb][None]] += 1
                yield rows, ct, cols, acc

    def gates(g, a, w, epilogue):
        out, rest = torch.empty(N, H), torch.empty(N, R)
        for rows, ct, cols, acc in tiles(g, a, w):
            if ct < g.gate_tiles:
                units = cols[:g.ub]
                keep = units >= 0
                u = units[keep]
                pre = [acc[:, i * g.ub:(i + 1) * g.ub][:, keep] for i in range(3)]
                out[rows[:, None], u[None]] = epilogue(rows, u, pre)
            else:
                inb = cols >= 0
                rest[rows[:, None], (cols[inb] - g.col0)[None]] = acc[:, inb]
        return out, rest

    def gru1(rows, u, pre):
        x = [gy[rows[:, None], (i * H + u)[None]] for i in range(3)]
        hg = [pre[i] + bh1[i * H + u] for i in range(3)]
        return gru_gate_algebra(torch.cat(x, 1), torch.cat(hg, 1), s[rows[:, None], u[None]])

    st = rbf(gates(plan["hg1"], s, uh1, gru1)[0])
    qh = torch.empty(N, A + 3 * H)
    for rows, ct, cols, acc in tiles(plan["qh"], st, w_s):
        inb = cols >= 0
        qh[rows[:, None], cols[inb][None]] = acc[:, inb]
    q = qh[:, :A].reshape(B, K, A)
    e = torch.tanh(ctxpb[:, None, :, :] + q[:, :, None, :])
    sc = (e * va).sum(-1)
    sc = torch.where(mask[:, None, :] > 0, sc, torch.full_like(sc, ds.NEG_INF))
    c = rbf(_context_quarters(torch.softmax(sc, -1), ctx).reshape(N, C))

    def gru2(rows, u, pre):
        xg = [pre[i] + bi2[i * H + u] for i in range(3)]
        hg = [qh[rows[:, None], (A + i * H + u)[None]] + bh2[i * H + u] for i in range(3)]
        return gru_gate_algebra(torch.cat(xg, 1), torch.cat(hg, 1), st[rows[:, None], u[None]])

    s_new, tc = gates(plan["xc"], c, w_c, gru2)
    s_new = rbf(s_new)
    sw = torch.empty(N, R)
    for rows, ct, cols, acc in tiles(plan["sw"], s_new, ws):
        inb = cols >= 0
        sw[rows[:, None], cols[inb][None]] = acc[:, inb]
    t = torch.tanh(((gy[:, 3 * H:] + sw) + tc) + b)
    return s_new, t


def _cover(shape):
    N, H, A, C, R = _widths(shape)
    return {"hg1": torch.zeros(N, 3 * H), "qh": torch.zeros(N, A + 3 * H),
            "xc": torch.zeros(N, 3 * H + R), "sw": torch.zeros(N, R)}


@pytest.mark.parametrize("label", ["full", "ragged", "odd"])
def test_model_matches_plain_at_chip_shapes(label):
    """Phase 18's bf16 inputs on the CPU: the model's states within
    BF16_STATE_ATOL and t within BF16_RTOL of its scale of dec_step_plain
    on the bf16 operands, every output of every product written once."""
    shape = {"full": FULL, "ragged": cs.DEC_STEP_RAGGED, "odd": cs.DEC_STEP_ODD}[label]
    inputs, weights = cs._dec_step_bf16_case(torch, np, CPU, shape, seed=31)
    f32 = tuple(x.float() for x in inputs), tuple(w.float() for w in weights)
    cover = _cover(shape)
    got = _model(*f32[0], f32[1], cover=cover)
    want = ds.dec_step_plain(*inputs, weights)
    assert want[0].dtype == BF and want[1].dtype == torch.float32
    assert float((got[0] - want[0].float()).abs().max()) <= cs.BF16_STATE_ATOL
    assert cs._rel_err(got[1], want[1]) <= cs.BF16_RTOL
    for name, n in cover.items():
        assert torch.equal(n, torch.ones_like(n)), name


def test_products_within_a_tenth_of_dec_step_rtol_of_fp64():
    """The four products at full width on phase 18's bf16 operands: the
    model (exact 16-deep steps into fp32 accumulators in ascending depth)
    within DEC_STEP_RTOL / 10 of the exact products over their scale; the
    fp32 operands the bf16 values came from are not within BF16_RTOL / 100,
    so bf16 and fp32 sets are different functions."""
    inputs, weights = cs._dec_step_bf16_case(torch, np, CPU, FULL, seed=31)
    gy, s, ctx, ctxpb, mask = inputs
    c32 = torch.from_numpy((0.5 * np.random.RandomState(5).randn(
        s.shape[0], ctx.shape[2])).astype(np.float32))
    c = c32.to(BF)
    for a, w in ((s, weights[0]), (s, weights[2]), (c, weights[5]), (s, weights[7])):
        exact = a.double() @ w.double()
        err = (product_bf16_k16(a, w).double() - exact).abs().max()
        assert err / exact.abs().max() <= cs.DEC_STEP_RTOL / 10
    exact32 = c32.double() @ weights[5].double()
    assert (exact32 - c.double() @ weights[5].double()).abs().max() / \
        exact32.abs().max() > cs.BF16_RTOL / 100


@pytest.mark.parametrize("K", [1, 3, 5])
def test_model_matches_plain_and_jax_pallas_step(K):
    """The model on bf16 operands made with numpy from a seed (the JAX
    test's decoder, cast params, ragged source lengths) against
    dec_step_plain and pallas_decode_step in interpret mode."""
    _, _, jc, tc, tok, s, ctx, mask = _dec_step_case(K, seed=50 + K)
    jt = jdec.decode_tables(jc)
    ctxp = j_ctx_proj(jc["attn"], ctx)
    js, jt_out = pallas_decode_step(jc, jt, jnp.asarray(tok), s, ctx, ctxp,
                                    jnp.asarray(mask))
    tt = tdec.decode_tables(tc)
    B, _, H = s.shape
    ctx_t = torch.from_numpy(_np(ctx)).to(BF)
    ctxpb = precompute_ctx_proj(tc["attn"], ctx_t) + tc["attn"]["ba"]
    gy = tt["gy"][torch.from_numpy(tok).long().reshape(-1)]
    weights = ds.step_weights(tc, tt)
    args = (gy, torch.from_numpy(_np(s)).to(BF).reshape(B * K, H), ctx_t, ctxpb,
            torch.from_numpy(mask))
    got = _model(*(x.float() for x in args), tuple(w.float() for w in weights))
    want = ds.dec_step_plain(*args, weights)
    assert float((got[0] - want[0].float()).abs().max()) <= STATE_ATOL
    _scale_close(got[1].numpy(), want[1].numpy(), SCALE_TOL, "t (plain)")
    err = float((got[0].reshape(B, K, H) - torch.from_numpy(_np(js))).abs().max())
    assert err <= STATE_ATOL, err
    _scale_close(got[1].numpy(), _np(jax.device_get(jt_out)), SCALE_TOL, "t (JAX)")
