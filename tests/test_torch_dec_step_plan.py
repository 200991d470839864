"""Kernel 7's design (``csrc/dec_step.cu``) modelled in plain torch on the
CPU: its tiling (``ops/dec_step.py::dec_step_plan``: 64-row tiles, gate
tiles holding the r, z and n columns of a block of hidden units, plain
tiles, the last product split over its depth), its 3xTF32 products (each
operand split into a TF32 part and a TF32 remainder, both rounded to
nearest with ties away on the bits), the GRU cells in the gate tiles'
epilogues, the split partials merged in split order and the readout in the
merge's epilogue. The plan's tile counts are the kernel launch's
arguments (``launch_tiles``), so its coverage here is the launched grids'.
The model is held against ``dec_step_plain`` and the JAX package's
``pallas_decode_step`` (interpret mode on the CPU); the CUDA kernel is held
against the same plain version on the card by chip_smoke.py.

Tolerances: the 3xTF32 products within a tenth of chip_smoke's
DEC_STEP_RTOL of fp64 (relative to the product's scale); the model against
the plain version and the JAX kernel to rtol = atol = 1e-5, as the JAX
package's own kernel tests (the products and sums run in another order);
at chip_smoke's full-width and ragged shapes to DEC_STEP_RTOL over the
reference's scale, as the card's check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from tests.test_torch_dec_step import _case, _to_torch
from tests.test_torch_readout_plan import product_3xtf32, split_tf32, tf32_rna
from vag_nmt_tpu.models import decoder as jdec
from vag_nmt_tpu.ops.attention import precompute_ctx_proj as j_ctx_proj
from vag_nmt_tpu.ops.pallas_dec_step import pallas_decode_step

from vag_nmt_tpu_torch.models import decoder as dec
from vag_nmt_tpu_torch.ops import dec_step as ds
from vag_nmt_tpu_torch.ops.attention import precompute_ctx_proj
from vag_nmt_tpu_torch.ops.gru_kernel import gru_gate_algebra

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

TOL = 1e-5
CPU = torch.device("cpu")
# (B, K, T, H, A, C, R): chip_smoke's full-width m30k shape, its ragged
# shape, its shape of widths that are no multiples of 4 (the kernel's 4-byte
# copies), its one-beam and one-sentence cases, and narrower such widths
FULL = cs._dec_step_full()
RAGGED = cs.DEC_STEP_RAGGED
ODD = cs.DEC_STEP_ODD
PLAN_SHAPES = [FULL, RAGGED, ODD, cs._dec_step_full(K=1), cs._dec_step_full(B=1),
               (3, 2, 5, 10, 6, 14, 7), (1, 1, 1, 1, 1, 1, 1)]


def _widths(shape):
    B, K, T, H, A, C, R = shape
    return B * K, H, A, C, R


def _outputs(g: ds.GemmPlan):
    """The columns of b a product's output holds."""
    return {"hg1": 3 * g.H, "qh": g.cols, "xc": 3 * g.H + g.cols,
            "sw": g.cols}[g.name]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_covers_every_output_once_within_its_limits(shape):
    N, H, A, C, R = _widths(shape)
    plan = ds.dec_step_plan(N, H, A, C, R)
    assert [g.name for g in plan] == ["hg1", "qh", "xc", "sw"]
    assert [g.depth for g in plan] == [H, H, C, H]
    for g in plan:
        seen = np.zeros(_outputs(g), dtype=np.int64)
        for ct in range(g.col_tiles):
            cols = g.b_columns(ct)
            assert len(cols) == g.tile_cols
            for c in cols:
                if c >= 0:
                    seen[c] += 1
            if ct < g.gate_tiles:
                # a gate tile: UB units, each with its r, z and n columns
                units = [c for c in cols[:ds.UB] if c >= 0]
                assert cols[ds.UB:2 * ds.UB] == [c + H if c >= 0 else -1
                                                  for c in cols[:ds.UB]]
                assert cols[2 * ds.UB:] == [c + 2 * H if c >= 0 else -1
                                            for c in cols[:ds.UB]]
                assert all(0 <= u < H for u in units)
            # a 4-column group: 4 contiguous columns, all in or all out
            # where the widths are multiples of 4 (the 16-byte copies)
            if H % 4 == 0 and g.cols % 4 == 0:
                for j in range(0, g.tile_cols, 4):
                    grp = cols[j:j + 4]
                    assert (all(c < 0 for c in grp)
                            or grp == list(range(grp[0], grp[0] + 4)))
        np.testing.assert_array_equal(seen, 1)
        assert (g.row_tiles - 1) * ds.BM < N <= g.row_tiles * ds.BM
        # the splits cover the depth once, trailing ones empty
        depth = np.zeros(g.depth, dtype=np.int64)
        for z in range(g.splits):
            depth[z * g.kchunk:(z + 1) * g.kchunk] += 1
        np.testing.assert_array_equal(depth, 1)
        assert g.kchunk % ds.BK == 0 or g.splits == 1
        assert g.tile_cols % 16 == 0   # whole n8 tiles for 2 warps
        assert g.smem_bytes <= ds.SMEM_LIMIT
    assert [g.splits for g in plan] == [1, 1, 1, ds.SPLIT]
    assert ds.BM % ds.SPLIT == 0 and ds.SPLIT <= 8   # a portable cluster
    # the launch's arguments, in the form dec_step_launch accepts: gate
    # tiles in the two GRU products alone, hg1 all gate tiles, xc's tc
    # tiles after its gate tiles, the split depth a multiple of BK
    gt1, ct1, gt2, ct2, gt3, ct3, gt4, ct4, kchunk = ds.launch_tiles(plan)
    assert gt1 == ct1 >= 1 and gt2 == gt4 == 0 and ct2 >= 1 and ct4 >= 1
    assert 1 <= gt3 < ct3
    assert kchunk == plan[-1].kchunk and kchunk % ds.BK == 0
    assert ds.SPLIT * kchunk >= H


def test_full_width_plan_fills_the_card():
    """At the serving shape every product has at least one CTA per SM of
    the H100 (132): the last one through its depth splits."""
    plan = ds.dec_step_plan(*_widths(FULL))
    ctas = {g.name: g.row_tiles * g.col_tiles * g.splits for g in plan}
    assert ctas == {"hg1": 320, "qh": 260, "xc": 380, "sw": 320}
    assert [g.splits for g in plan] == [1, 1, 1, 4]


def _one_tf32(a, w):
    """One TF32 product (operands rounded, no remainders), exact in fp64."""
    return tf32_rna(a).double() @ tf32_rna(w).double()


def _model(gy, s, ctx, ctxpb, mask, weights, cover=None, product=product_3xtf32):
    """csrc/dec_step.cu in torch: the products tile by tile as three TF32
    products (exact, summed in fp64, then fp32 as the accumulators), the
    GRU cells from the gate tiles' accumulators, the attention as the
    plain version, the readout from the split partials in split order.
    ``cover`` counts each product's outputs written; ``product`` is the
    tile product (the control takes one TF32 pass). Kernel 7b's model is
    tests/test_torch_dec_step_bf16_plan.py's."""
    uh1, bh1, w_s, bh2, va, w_c, bi2, ws, b = weights
    B, T, C = ctx.shape
    N, H = s.shape
    K = N // B
    A = w_s.shape[1] - 3 * H
    R = ws.shape[1]
    plan = {g.name: g for g in ds.dec_step_plan(N, H, A, C, R)}

    def tiles(g, a, w):
        """Yields (rows, tile columns (b's), the tile's accumulators (BM,
        tile_cols) fp32, split z) of product g."""
        for rt in range(g.row_tiles):
            rows = torch.arange(rt * ds.BM, min(N, (rt + 1) * ds.BM))
            for ct in range(g.col_tiles):
                cols = torch.tensor(g.b_columns(ct))
                inb = cols >= 0
                for z in range(g.splits):
                    k = slice(z * g.kchunk, min(g.depth, (z + 1) * g.kchunk))
                    acc = torch.zeros(len(rows), g.tile_cols)
                    acc[:, inb] = product(
                        a[rows, k], w[k][:, cols[inb]]).to(torch.float32)
                    if cover is not None and z == 0:
                        cover[g.name][rows[:, None], cols[inb][None]] += 1
                    yield rows, ct, cols, acc, z

    def gates(g, a, w, epilogue):
        out = torch.empty(N, H)
        rest = torch.empty(N, R)
        for rows, ct, cols, acc, _ in tiles(g, a, w):
            if ct < g.gate_tiles:
                units = cols[:ds.UB]
                keep = units >= 0
                u = units[keep]
                pre = [acc[:, i * ds.UB:(i + 1) * ds.UB][:, keep] for i in range(3)]
                out[rows[:, None], u[None]] = epilogue(rows, u, pre)
            else:
                inb = cols >= 0
                rest[rows[:, None], (cols[inb] - g.col0)[None]] = acc[:, inb]
        return out, rest

    def gru1(rows, u, pre):
        x = [gy[rows[:, None], (i * H + u)[None]] for i in range(3)]
        hg = [pre[i] + bh1[i * H + u] for i in range(3)]
        return gru_gate_algebra(torch.cat(x, 1), torch.cat(hg, 1),
                                s[rows[:, None], u[None]])

    st, _ = gates(plan["hg1"], s, uh1, gru1)
    qh = torch.empty(N, A + 3 * H)
    for rows, ct, cols, acc, _ in tiles(plan["qh"], st, w_s):
        inb = cols >= 0
        qh[rows[:, None], cols[inb][None]] = acc[:, inb]
    q = qh[:, :A].reshape(B, K, A)
    e = torch.tanh(ctxpb[:, None, :, :] + q[:, :, None, :])
    sc = (e * va).sum(-1)
    sc = torch.where(mask[:, None, :] > 0, sc, torch.full_like(sc, ds.NEG_INF))
    c = torch.einsum("bkt,btc->bkc", torch.softmax(sc, -1), ctx).reshape(N, C)

    def gru2(rows, u, pre):
        xg = [pre[i] + bi2[i * H + u] for i in range(3)]
        hg = [qh[rows[:, None], (A + i * H + u)[None]] + bh2[i * H + u]
              for i in range(3)]
        return gru_gate_algebra(torch.cat(xg, 1), torch.cat(hg, 1),
                                st[rows[:, None], u[None]])

    s_new, tc = gates(plan["xc"], c, w_c, gru2)
    g = plan["sw"]
    parts = torch.zeros(g.splits, N, R)
    for rows, ct, cols, acc, z in tiles(g, s_new, ws):
        inb = cols >= 0
        parts[z][rows[:, None], cols[inb][None]] = acc[:, inb]
    sw = torch.zeros(N, R)
    for z in range(g.splits):          # split order, never arrival order
        sw = sw + parts[z]
    t = torch.tanh(((gy[:, 3 * H:] + sw) + tc) + b)
    return s_new, t


def _cover(shape):
    N, H, A, C, R = _widths(shape)
    return {"hg1": torch.zeros(N, 3 * H), "qh": torch.zeros(N, A + 3 * H),
            "xc": torch.zeros(N, 3 * H + R), "sw": torch.zeros(N, R)}


@pytest.mark.parametrize("label", ["full", "ragged", "odd"])
def test_model_matches_plain_at_chip_shapes(label):
    """chip_smoke's phase-10 inputs on the CPU: the model within
    DEC_STEP_RTOL of the plain version, every output of every product
    written once."""
    shape = {"full": FULL, "ragged": RAGGED, "odd": ODD}[label]
    inputs, weights = cs._dec_step_case(torch, np, CPU, *shape, seed=11)
    cover = _cover(shape)
    got = _model(*inputs, weights, cover=cover)
    want = ds.dec_step_plain(*inputs, weights)
    for a, b in zip(got, want):
        assert cs._rel_err(a, b) <= cs.DEC_STEP_RTOL / 10
    for name, n in cover.items():
        assert torch.equal(n, torch.ones_like(n)), name


def test_one_tf32_pass_misses_dec_step_rtol_on_the_outputs():
    """The control: the same model with one TF32 pass per product instead
    of three puts (s_new, t) beyond DEC_STEP_RTOL of the plain version at
    chip_smoke's full-width data, so the check on the card tells the two
    precisions apart at the level of the outputs."""
    inputs, weights = cs._dec_step_case(torch, np, CPU, *FULL, seed=11)
    got = _model(*inputs, weights, product=_one_tf32)
    want = ds.dec_step_plain(*inputs, weights)
    assert max(cs._rel_err(a, b) for a, b in zip(got, want)) > cs.DEC_STEP_RTOL


def test_3xtf32_products_within_a_tenth_of_dec_step_rtol_of_fp64():
    """The four products at full width on chip_smoke's data: 3xTF32 within
    DEC_STEP_RTOL / 10 of fp64 over the product's scale; one TF32 pass is
    not within DEC_STEP_RTOL."""
    inputs, weights = cs._dec_step_case(torch, np, CPU, *FULL, seed=11)
    gy, s, ctx, ctxpb, mask = inputs
    rng = np.random.RandomState(5)
    c = torch.from_numpy((0.5 * rng.randn(s.shape[0], ctx.shape[2])).astype(
        np.float32))
    for a, w in ((s, weights[0]), (s, weights[2]), (c, weights[5]),
                 (s, weights[7])):
        exact = a.double() @ w.double()
        scale = exact.abs().max()
        three = product_3xtf32(a, w).to(torch.float32).double()
        one = _one_tf32(a, w)
        assert (three - exact).abs().max() / scale <= cs.DEC_STEP_RTOL / 10
        assert (one - exact).abs().max() / scale > cs.DEC_STEP_RTOL
    # the remainder is below half a TF32 unit of each element
    big, small = split_tf32(s)
    assert ((s - big).abs() <= s.abs() * 2.0 ** -11).all()
    assert ((small - (s - big)).abs() <= (s - big).abs() * 2.0 ** -11).all()


def test_readout_epilogue_sums_in_the_plain_order():
    """t = tanh(((ty + sw) + tc) + b): bit for bit the plain version's
    expression on the same fp32 terms, which another association of the
    four terms is not; the split partials in split order give the same sum
    whichever split arrives last."""
    rng = np.random.RandomState(3)
    ty, sw, tc = (torch.from_numpy((10.0 ** rng.uniform(-3, 1, (64, 256))
                                    * rng.randn(64, 256)).astype(np.float32))
                  for _ in range(3))
    b = torch.from_numpy(rng.randn(256).astype(np.float32))
    model = torch.tanh(((ty + sw) + tc) + b)
    assert torch.equal(model, torch.tanh(ty + sw + tc + b))
    assert not torch.equal(((ty + sw) + tc) + b, ty + ((sw + tc) + b))
    parts = torch.from_numpy(rng.randn(4, 64, 256).astype(np.float32))
    in_order = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    merged = torch.zeros(64, 256)
    for z in range(4):
        merged = merged + parts[z]
    assert torch.equal(merged, in_order)


@pytest.mark.parametrize("K", [1, 3, 5])
def test_model_matches_plain_and_jax_pallas_step(K):
    """The model on the kernel's argument layout against dec_step_plain and
    pallas_decode_step called directly (interpret mode), inputs from the
    JAX test's decoder with ragged source lengths."""
    _, _, jp, tok, s, ctx, mask = _case(K=K, seed=30 + K)
    jt = jdec.decode_tables(jp)
    ctxp = j_ctx_proj(jp["attn"], jnp.asarray(ctx))
    js, jt_out = pallas_decode_step(jp, jt, jnp.asarray(tok), jnp.asarray(s),
                                    jnp.asarray(ctx), ctxp, jnp.asarray(mask))
    tp = _to_torch(jax.device_get(jp))
    tt = dec.decode_tables(tp)
    B, _, H = s.shape
    ctx_t = torch.from_numpy(ctx)
    ctxpb = precompute_ctx_proj(tp["attn"], ctx_t) + tp["attn"]["ba"]
    gy = tt["gy"][torch.from_numpy(tok).long().reshape(-1)]
    args = (gy, torch.from_numpy(s).reshape(B * K, H), ctx_t, ctxpb,
            torch.from_numpy(mask), ds.step_weights(tp, tt))
    got = _model(*args)
    want = ds.dec_step_plain(*args)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[0].reshape(B, K, H).numpy(), np.asarray(js),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jt_out), rtol=TOL,
                               atol=TOL)


def test_fast_tanh_of_the_energies_within_its_stated_error():
    """The attention's tanh_fast, 1 - 2 / (1 + exp(2x)) in fp32: within
    2.5e-7 of tanh in fp64 over the energies' range with the CPU's exp and
    division; and within the kernel's stated 4.8e-7 when the exponential is
    off by the CUDA guide's bound for __expf (2 + 1.2 |2x| ulp) and the
    quotient by __fdividef's (2 ulp), either way (the scores sum A of
    these)."""
    x = torch.linspace(-12.0, 12.0, 200001, dtype=torch.float32)
    x = torch.cat([x, torch.tensor([0.0, 1e-6, -1e-6, 1e-3, 50.0, -50.0])])
    fast = 1.0 - 2.0 / (1.0 + torch.exp(2.0 * x))
    exact = torch.tanh(x.double())
    assert (fast.double() - exact).abs().max() <= 2.5e-7
    ulp = 2.0 ** -23
    y = (2.0 * x).double()
    e = torch.exp(y)
    for se in (-1.0, 1.0):
        q = 2.0 / (1.0 + e * (1.0 + se * (2.0 + 1.2 * y.abs()) * ulp))
        q_ulp = torch.exp2(torch.floor(torch.log2(q))) * ulp
        for sq in (-1.0, 1.0):
            worst = (1.0 - (q + sq * 2.0 * q_ulp)).to(torch.float32)
            assert (worst.double() - exact).abs().max() <= 4.8e-7
