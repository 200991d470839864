"""Kernels 4 and 5's design (``csrc/dec_scan_fwd.cu``, ``csrc/dec_scan_bwd.cu``,
``csrc/dec_scan.cuh``) modelled in plain torch on the CPU.

The plan (``ops/dec_scan.py::dec_scan_plan``) is checked where the card's
launches take it: at chip_smoke.py's phase-7 shapes and ragged ones, and
on a few SMs or little shared memory (column passes, weight slices in
L2), every output of every per-step product is covered exactly once, a
phase's products sit on disjoint CTAs within the grid, the resident weight
slices, the scratch region (the k-slices' accumulators and the
attention's shared row) and the streamed products' ring fit the shared
memory, the slices in L2 fit their buffer without overlap, and the plan
raises where nothing fits.

The model follows the kernels' partition: gate tiles (a unit block's r, z
and n columns) with GRU1 / GRU2 in their epilogues, plain tiles, the
products in 3xTF32 (each operand split into a TF32 part and a TF32
remainder, rounded on the bits in the per-step products, truncated in the
streamed ones; the big x big and the remainder products in separate
accumulators) over the warps' k-slices, added in k-slice order; the
attention on tanh_fast with the context's two halves of positions added in
order; the backward's GRU cells in the epilogues, and the hoisted sums:
dctx as a product over the steps, dctx_proj summed from the last step,
the weight grads as products over all rows and the bias grads as
row-block sums added in block order. It is held against
``dec_scan_fwd_plain`` / ``dec_scan_bwd_plain``, the forward against the
JAX package's ``pallas_decoder_scan`` (interpret mode) and XLA scan, the
gradients against ``jax.grad`` of the XLA scan (the Pallas backward has
known faults in the JAX package's own tests). A control shows that one
TF32 pass misses the tolerance on the scan's outputs, not only on a bare
product.

Tolerance: chip_smoke.py's DEC_SCAN_RTOL (1e-4) over the reference's
scale (``_rel_err``), as the card's check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from tests.test_torch_dec_scan import _dec_setup, _jax_xla_scan, _order, _torch_tree
from tests.test_torch_readout_plan import split_tf32
from vag_nmt_tpu.ops.pallas_dec_scan import pallas_decoder_scan

from vag_nmt_tpu_torch.ops import dec_scan as ds
from vag_nmt_tpu_torch.ops.gru_kernel import gru_cell_bwd_plain

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

RTOL = cs.DEC_SCAN_RTOL
N_SMS, MAX_SMEM = 132, 232448      # the H100's SMs and opt-in shared memory
PCIE_SMS = 114                     # the H100 PCIe's SMs
GRADS = ("dty", "dxg1", "ds0", "dctx", "dctx_proj", "duh1", "dbh1", "dua",
         "dva", "dwi2", "dbi2", "duh2", "dbh2", "dws", "dwc")

PLAN_SHAPES = [tuple(s[1:]) for s in cs._dec_scan_shapes()] + [
    (1, 3, 2, 16, 12, 20, 10),          # one row, narrow widths
    (130, 40, 5, 512, 512, 1024, 256),  # more rows than a tile pair holds
    (64, 24, 24, 256, 256, 512, 256),   # m30k_ende's smaller widths
]


# --- the plan ---------------------------------------------------------------

def _columns(p, ct):
    """W's column of each column of tile ct, -1 outside W (the kernel's
    prod_col)."""
    out = []
    for j in range(p.tile_cols):
        if p.unit_block:
            ub = p.unit_block
            u = ct * ub + j % ub
            out.append((j // ub) * p.H + u if j < 3 * ub and u < p.H else -1)
        else:
            c = ct * p.tile_cols + j
            out.append(c if c < p.cols else -1)
    return out


def _tiles_of(p, cta):
    """(column tiles, row parts) CTA ``cta`` takes of product p (the
    kernel's prod_slot and product loops), or None."""
    i = cta - p.cta0
    if not 0 <= i < p.ctas:
        return None
    return (list(range(i // p.row_slots, p.col_tiles, p.col_slots)),
            list(range(i % p.row_slots, p.row_parts, p.row_slots)))


def _coverage(p, B, ctas):
    """How often each (row, output column) of product p is written."""
    cover = np.zeros((B, p.cols), np.int64)
    for x in range(ctas):
        got = _tiles_of(p, x)
        if got is None:
            continue
        cts, parts = got
        for ct in cts:
            cols = [c for c in _columns(p, ct) if c >= 0]
            for rp in parts:
                cover[rp * p.tile_rows:(rp + 1) * p.tile_rows, cols] += 1
    return cover


def _check_plan(plan, B, T, A, C, n_sms, max_smem):
    for kp in (plan.fwd, plan.bwd):
        assert kp.ctas == n_sms and kp.smem_bytes <= max_smem
        assert kp.att_parts >= 1 and kp.att_parts * B <= max(n_sms, B)
        assert [p.name for p in kp.products] == [n for ph in kp.phases for n in ph]
        ends, l2 = [], []
        for phase in kp.phases:
            used = set()
            prods = [kp.product(n) for n in phase]
            for p in prods:
                ctas = set(range(p.cta0, p.cta0 + p.ctas))
                assert not ctas & used and max(ctas) < n_sms
                used |= ctas
                assert p.tile_cols % 8 == 0 and p.tile_cols // 8 <= ds.NI_MAX
                assert p.tile_rows in ds.TILE_ROWS
                assert p.unit_block == 0 or 3 * p.unit_block <= p.tile_cols
                assert 1 <= p.col_slots <= p.col_tiles
                assert (_coverage(p, B, n_sms) == 1).all(), (kp.kernel, p.name)
            # a phase's slices are all in L2 or all resident
            assert len({p.l2off >= 0 for p in prods}) == 1
            if prods[0].l2off >= 0:
                l2 += [(p.l2off, p.l2off + p.ctas * p.region_floats) for p in prods]
                continue
            # a resident phase's slices share one offset; the phases'
            # regions follow each other and end before the scratch region
            assert len({p.woff for p in prods}) == 1 and prods[0].woff % 4 == 0
            ends.append((prods[0].woff, max(p.woff + p.region_floats for p in prods)))
        for (_, end), (start, _) in zip(ends, ends[1:]):
            assert end <= start
        assert not ends or ends[-1][1] <= kp.scratch_off
        # every CTA's slices in L2 inside the buffer, no two overlapping
        l2.sort()
        assert all(a % 4 == 0 for a, _ in l2)
        assert all(e <= a for (_, e), (a, _) in zip(l2, l2[1:]))
        assert (l2[-1][1] if l2 else 0) == kp.l2_floats
        scratch = max([ds._att_floats(kp.kernel, T, A, C, kp.att_parts)]
                   + [p.part_floats for p in kp.products])
        assert 4 * (kp.scratch_off + scratch) <= kp.smem_bytes
        assert len(kp.launch_args()) == (6 if kp.kernel == "dec_scan_bwd" else 5) + 36


@pytest.mark.parametrize("n_sms", [N_SMS, PCIE_SMS])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_output_once_and_fits(shape, n_sms):
    B, T, Tt, H, A, C, R = shape
    plan = ds.dec_scan_plan(B, T, H, A, C, R, n_sms, MAX_SMEM)
    _check_plan(plan, B, T, A, C, n_sms, MAX_SMEM)


@pytest.mark.parametrize("shape, n_sms, max_smem", [
    ((64, 24, 24, 512, 512, 1024, 256), N_SMS, 48 * 1024),
    ((64, 24, 24, 512, 512, 1024, 256), 8, MAX_SMEM),
    ((37, 13, 9, 94, 90, 190, 62), 4, 16 * 1024),
    ((130, 40, 5, 512, 512, 1024, 256), 20, 64 * 1024),
])
def test_plan_with_column_passes_and_l2_slices_covers_every_output_once(
        shape, n_sms, max_smem):
    """Few SMs or little shared memory: CTAs take several column tiles of a
    product, and phases whose slices do not fit keep them in L2."""
    B, T, Tt, H, A, C, R = shape
    plan = ds.dec_scan_plan(B, T, H, A, C, R, n_sms, max_smem)
    _check_plan(plan, B, T, A, C, n_sms, max_smem)
    prods = plan.fwd.products + plan.bwd.products
    assert any(p.l2off >= 0 for p in prods)
    assert any(p.col_passes > 1 for p in prods) or n_sms == N_SMS


def test_plan_puts_the_weights_in_l2_only_where_they_do_not_fit():
    """chip_smoke.py's wide case (H = A = 1024, C = 2048: 54 MB of
    recurrent weights against 30 MB of shared memory) keeps some phases'
    slices in L2 and the rest resident; at full width nothing is in L2."""
    (_, B, T, _, H, A, C, R), = [s for s in cs._dec_scan_shapes() if s[0] == "wide"]
    plan = ds.dec_scan_plan(B, T, H, A, C, R, N_SMS, MAX_SMEM)
    for kp in (plan.fwd, plan.bwd):
        assert kp.l2_floats > 0
        assert {p.l2off >= 0 for p in kp.products} == {True, False}
    full = ds.dec_scan_plan(64, 24, 512, 512, 1024, 256, N_SMS, MAX_SMEM)
    assert full.fwd.l2_floats == full.bwd.l2_floats == 0


def test_streamed_tiles_fit_several_ctas_a_sm():
    """The grids of streamed tiles (readout, readout terms, weight grads,
    dctx) take GSTAGES stages of a GM-row A chunk and a GN-column B chunk:
    within the shared memory of three CTAs a SM (228 KB)."""
    assert 3 * 4 * ds.GSTAGES * (ds.GM + ds.GN) * (ds.BK + 4) <= 228 * 1024


def test_plan_at_full_width_takes_whole_tiles():
    """The card's plan at training's shape: every product on 128-130 CTAs
    of the 132, one pass over row parts a step, the 13.6 MB of recurrent
    weights resident."""
    plan = ds.dec_scan_plan(64, 24, 512, 512, 1024, 256, N_SMS, MAX_SMEM)
    for kp in (plan.fwd, plan.bwd):
        for phase in kp.phases:
            n = sum(kp.product(name).ctas for name in phase)
            assert 128 <= n <= N_SMS, (kp.kernel, phase, n)
        assert all(p.passes == 1 and p.l2off < 0 for p in kp.products)
    resident = sum(p.ctas * p.region_floats for p in plan.fwd.products) * 4
    assert resident >= 4 * (2 * 512 * 1536 + 512 * 512 + 1024 * 1536)


@pytest.mark.parametrize("args, what", [
    ((64, 24, 512, 512, 1024, 256, N_SMS, 4096), "do not fit"),
    ((64, 24, 512, 512, 1024, 256, 1, MAX_SMEM), "no tiling"),
    ((0, 24, 512, 512, 1024, 256, N_SMS, MAX_SMEM), "positive"),
])
def test_plan_raises_where_nothing_fits(args, what):
    ds.dec_scan_plan.cache_clear()
    with pytest.raises(ValueError, match=what):
        ds.dec_scan_plan(*args)


# --- the model --------------------------------------------------------------

def tanh_fast(x):
    """csrc/common.cuh's tanh_fast, 1 - 2 / (1 + exp(2x)), in fp32."""
    return 1.0 - 2.0 / (1.0 + torch.exp(2.0 * x))


def _tf32_trunc(x):
    """x's top 10 mantissa bits (the tensor cores' view of an fp32 operand
    of a TF32 product)."""
    return (x.contiguous().view(torch.int32) & -(1 << 13)).view(torch.float32)


def split_tr(x):
    """csrc/dec_scan.cuh's split_tr: big = x truncated to TF32, small = x -
    big (exact in fp32), as the tensor cores read them."""
    big = _tf32_trunc(x)
    return big, _tf32_trunc(x - big)


def test_split_tr_within_its_bound():
    """big + small as the tensor cores read them is x within 2^-20 |x|, and
    the 3xTF32 product of the split operands within DEC_SCAN_RTOL / 100 of
    fp64 at the per-step products' depths."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(100000, generator=g) * torch.exp(4 * torch.randn(100000, generator=g))
    big, small = split_tr(x)
    err = ((big.double() + small.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -20
    a = torch.randn(64, 1536, generator=g)
    w = torch.randn(1536, 24, generator=g) / 40
    big, cor = _two_accumulators(a, w, 3, split_tr)
    ref = a.double() @ w.double()
    assert float(((big + cor).double() - ref).abs().max() / ref.abs().max()) <= RTOL / 100


def _two_accumulators(a, w, passes, split):
    """(big x big, remainders) of a @ w in fp64, each rounded to fp32 as the
    warp's accumulators, the operands split by ``split`` (split_tf32 in the
    per-step products, split_tr in the streamed ones); passes=1 keeps only
    big x big (one TF32 pass)."""
    (ab, asl), (wb, wsl) = split(a.contiguous()), split(w.contiguous())
    d = torch.float64
    big = (ab.to(d) @ wb.to(d)).float()
    if passes == 1:
        return big, torch.zeros_like(big)
    cor = asl.to(d) @ wb.to(d) + ab.to(d) @ wsl.to(d)
    return big, cor.float()


def _slices(p, a, w, passes):
    """A per-step product's tile: the depth in the plan's k-slices (runs of
    16-deep slabs a warp takes), each slice's two accumulators added, then
    the slices added in order (tile_sum)."""
    K = a.shape[1]
    KS = ds.WARPS // (p.tile_rows // 16)
    nslab = -(-K // 16)
    out = torch.zeros(a.shape[0], w.shape[1])
    for ks in range(KS):
        lo, hi = ks * nslab // KS * 16, min(K, (ks + 1) * nslab // KS * 16)
        big, cor = _two_accumulators(a[:, lo:hi], w[lo:hi], passes, split_tf32)
        out = out + (big + cor)
    return out


def _tiles(p, ctas, a, w, passes):
    """Product p of a (B, K) and W (K, *) tile by tile as the CTAs take it:
    yields (column tile, rows, the tile's values)."""
    B, K = a.shape
    for x in range(ctas):
        got = _tiles_of(p, x)
        if got is None:
            continue
        cts, parts = got
        for ct in cts:
            wt = torch.stack([w[:, c] if c >= 0 else torch.zeros(K)
                              for c in _columns(p, ct)], 1)
            for rp in parts:
                rows = torch.arange(rp * p.tile_rows, min(B, (rp + 1) * p.tile_rows))
                if len(rows):
                    yield ct, rows, _slices(p, a[rows], wt, passes)


def _plain(p, ctas, a, w, passes):
    out = torch.full((a.shape[0], p.cols), float("nan"))
    for ct, rows, tile in _tiles(p, ctas, a, w, passes):
        cols = [c for c in range(p.tile_cols) if ct * p.tile_cols + c < p.cols]
        out[rows[:, None], torch.tensor([ct * p.tile_cols + c for c in cols])] = tile[:, cols]
    return out


def _gates(p, ctas, a, w, passes, epi):
    """A gate product: epi(rows, units, (r, z, n) pre-activations) in each
    tile's epilogue."""
    ub, H = p.unit_block, p.H
    for ct, rows, tile in _tiles(p, ctas, a, w, passes):
        units = torch.tensor([u for u in range(ct * ub, ct * ub + ub) if u < H])
        n = len(units)
        epi(rows, units, [tile[:, g * ub:g * ub + n] for g in range(3)])


def _gru(x3, h3, h):
    r = torch.sigmoid(x3[0] + h3[0])
    z = torch.sigmoid(x3[1] + h3[1])
    return (1.0 - z) * torch.tanh(x3[2] + r * h3[2]) + z * h


def _streamed(a, w, passes):
    """A streamed product (readout, readout terms, weight grads, dctx): one
    tile's two accumulators over the whole depth, added."""
    big, cor = _two_accumulators(a, w, passes, split_tr)
    return big + cor


def model_fwd(plan, ty_t, xg_t, s0, ctx, ctxp, mask, weights, passes=3):
    """The forward kernel's arithmetic: RESIDUALS."""
    uh1, bh1, ua, va, wi2, bi2, uh2, bh2, ws, wc = weights
    kp, Tt, B, _ = plan.fwd, *xg_t.shape
    H, T = s0.shape[1], ctx.shape[1]
    P = {p.name: p for p in kp.products}
    res = {k: [] for k in ds.RESIDUALS if k != "t"}
    res["s"].append(s0)
    s = s0
    for t in range(Tt):
        hg1, st = torch.zeros(B, 3 * H), torch.zeros(B, H)

        def gru1(rows, units, pre):
            hg = [pre[g] + bh1[g * H + units] for g in range(3)]
            for g in range(3):
                hg1[rows[:, None], g * H + units] = hg[g]
            x = [xg_t[t][rows[:, None], g * H + units] for g in range(3)]
            st[rows[:, None], units] = _gru(x, hg, s[rows[:, None], units])

        _gates(P["hg1"], kp.ctas, s, uh1, passes, gru1)
        q = _plain(P["q"], kp.ctas, st, ua, passes)
        hg2 = _plain(P["hg2"], kp.ctas, st, uh2, passes) + bh2
        e = tanh_fast(ctxp + q[:, None, :])
        sc = torch.where(mask > 0, (e * va).sum(-1), torch.full_like(mask, ds.NEG_INF))
        w = torch.softmax(sc, -1)
        Th = T // 2
        c = (torch.einsum("bj,bjc->bc", w[:, :Th], ctx[:, :Th])
             + torch.einsum("bj,bjc->bc", w[:, Th:], ctx[:, Th:]))
        xg2, s_new = torch.zeros(B, 3 * H), torch.zeros(B, H)

        def gru2(rows, units, pre):
            xg = [pre[g] + bi2[g * H + units] for g in range(3)]
            for g in range(3):
                xg2[rows[:, None], g * H + units] = xg[g]
            h3 = [hg2[rows[:, None], g * H + units] for g in range(3)]
            s_new[rows[:, None], units] = _gru(xg, h3, st[rows[:, None], units])

        _gates(P["xg2"], kp.ctas, c, wi2, passes, gru2)
        for k, v in (("s", s_new), ("st", st), ("c", c), ("w", w), ("q", q),
                     ("hg1", hg1), ("xg2", xg2), ("hg2", hg2)):
            res[k].append(v)
        s = s_new
        assert not any(torch.isnan(x).any() for x in (q, hg2, hg1, xg2, st, s))
    out = {k: torch.stack(v) for k, v in res.items()}
    rows = Tt * B
    pre = _streamed(torch.cat([out["c"].reshape(rows, -1),
                               out["s"][1:].reshape(rows, -1)], 1),
                    torch.cat([wc, ws], 0), passes)
    out["t"] = torch.tanh(ty_t + pre.reshape(ty_t.shape))
    return out


def model_bwd(plan, res, xg_t, ctx, ctxp, mask, weights, g_t, passes=3):
    """The backward kernel's arithmetic: dec_scan_bwd_plain's 15 outputs."""
    uh1, _, ua, va, wi2, _, uh2, _, ws, wc = weights
    kp, (Tt, B, R) = plan.bwd, g_t.shape
    H, T = uh1.shape[0], ctx.shape[1]
    P = {p.name: p for p in kp.products}
    rows = Tt * B

    def flat(x):
        return x.reshape(rows, -1)

    dpre = g_t * (1.0 - res["t"] * res["t"])
    ds_ro = _streamed(flat(dpre), ws.T, passes).reshape(Tt, B, H)
    dc = _streamed(flat(dpre), wc.T, passes).reshape(Tt, B, -1)
    dxg1, dxg2, dhg1, dhg2 = (torch.zeros(Tt, B, 3 * H) for _ in range(4))
    dq, dva_rows = torch.zeros(Tt, B, ctxp.shape[2]), torch.zeros(Tt, B, ctxp.shape[2])
    dsc = torch.zeros(Tt, B, T)

    def gru2_bwd(t, carry):
        dxg2[t], dhg2[t], base = gru_cell_bwd_plain(res["xg2"][t], res["hg2"][t],
                                                    res["st"][t], carry + ds_ro[t])
        return base

    dstp = gru2_bwd(Tt - 1, torch.zeros(B, H))
    for t in range(Tt - 1, -1, -1):
        dc[t] = dc[t] + _plain(P["dc"], kp.ctas, dxg2[t], wi2.T, passes)
        dst = dstp + _plain(P["dst"], kp.ctas, dhg2[t], uh2.T, passes)
        w, q = res["w"][t], res["q"][t]
        dw = (dc[t][:, None, :] * ctx).sum(-1)
        d = w * (dw - (w * dw).sum(-1, keepdim=True))
        dsc[t] = torch.where(mask > 0, d, torch.zeros_like(d))
        e = tanh_fast(ctxp + q[:, None, :])
        dq[t] = ((dsc[t][:, :, None] * va) * (1.0 - e * e)).sum(1)
        dva_rows[t] = (e * dsc[t][:, :, None]).sum(1)
        dtot = dst + _plain(P["dstq"], kp.ctas, dq[t], ua.T, passes)
        dxg1[t], dhg1[t], dsp = gru_cell_bwd_plain(xg_t[t], res["hg1"][t],
                                                   res["s"][t], dtot)
        ds_t = dsp + _plain(P["ds"], kp.ctas, dhg1[t], uh1.T, passes)
        if t > 0:
            dstp = gru2_bwd(t - 1, ds_t)
    ds0 = ds_t
    dctx = torch.stack([_streamed(res["w"][:, b].T, dc[:, b], passes)
                        for b in range(B)])
    dctxp = torch.zeros_like(ctxp)
    for t in range(Tt - 1, -1, -1):
        e = tanh_fast(ctxp + res["q"][t][:, None, :])
        dctxp = dctxp + (dsc[t][:, :, None] * va) * (1.0 - e * e)

    def colsum(x):
        blocks = [flat(x)[r:r + ds.COLSUM_ROWS].sum(0)
                  for r in range(0, rows, ds.COLSUM_ROWS)]
        out = torch.zeros_like(blocks[0])
        for b in blocks:
            out = out + b
        return out

    def wgrad(x, y):
        return _streamed(flat(x).T, flat(y), passes)

    return (dpre, dxg1, ds0, dctx, dctxp,
            wgrad(res["s"][:-1], dhg1), colsum(dhg1), wgrad(res["st"], dq),
            colsum(dva_rows), wgrad(res["c"], dxg2), colsum(dxg2),
            wgrad(res["st"], dhg2), colsum(dhg2), wgrad(res["s"][1:], dpre),
            wgrad(res["c"], dpre))


# --- the model against the plain versions and the JAX package --------------

def _case(seed=0, **kw):
    """_dec_setup's decoder, the scan's folded inputs and a cotangent."""
    cfg, params, inp = _dec_setup(seed=seed, **kw)
    tp = _torch_tree(params)
    weights = ds.scan_weights(tp)
    T = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    args = (T["ty"].transpose(0, 1).contiguous() + tp["readout"]["b"],
            T["xg1"].transpose(0, 1).contiguous(), T["s0"], T["ctx"],
            T["ctx_proj"] + tp["attn"]["ba"], T["src_mask"])
    Tt, B = args[1].shape[:2]
    R = args[0].shape[2]
    g = np.random.RandomState(seed + 1).randn(B, Tt, R).astype(np.float32)
    return cfg, params, inp, weights, args, g


def _plan_of(args, weights, n_sms=N_SMS, max_smem=MAX_SMEM):
    ty_t, xg_t, s0, ctx, ctxp, _ = args
    Tt, B, R = ty_t.shape
    return ds.dec_scan_plan(B, ctx.shape[1], s0.shape[1], ctxp.shape[2],
                            ctx.shape[2], R, n_sms, max_smem)


def test_model_forward_matches_plain_and_jax():
    cfg, params, inp, weights, args, _ = _case(seed=0)
    plan = _plan_of(args, weights)
    got = model_fwd(plan, *args, weights)
    want = ds.dec_scan_fwd_plain(*args, weights)
    errs = {k: cs._rel_err(got[k], want[k]) for k in ds.RESIDUALS}
    assert max(errs.values()) <= RTOL, errs
    jin = [jnp.asarray(x) for x in _order(inp)]
    t_bm = got["t"].transpose(0, 1)
    for name, ref in (("pallas", pallas_decoder_scan(params, *jin)),
                      ("xla", _jax_xla_scan(params, *jin))):
        assert cs._rel_err(t_bm, torch.from_numpy(np.array(ref))) <= RTOL, name


def test_model_backward_matches_plain_and_jax_grad():
    cfg, params, inp, weights, args, g = _case(seed=2)
    plan = _plan_of(args, weights)
    res = ds.dec_scan_fwd_plain(*args, weights)
    g_t = torch.from_numpy(g).transpose(0, 1).contiguous()
    xg_t, ctx, ctxp, mask = args[1], args[3], args[4], args[5]
    got = model_bwd(plan, res, xg_t, ctx, ctxp, mask, weights, g_t)
    want = ds.dec_scan_bwd_plain(res, xg_t, ctx, ctxp, mask, weights, g_t)
    errs = {n: cs._rel_err(a, b) for n, a, b in zip(GRADS, got, want)}
    assert max(errs.values()) <= RTOL, errs

    def jloss(params, ty, xg1, s0, ctx, ctx_proj):
        t_all = _jax_xla_scan(params, ty, xg1, s0, ctx, ctx_proj,
                              jnp.asarray(inp["src_mask"]))
        return (t_all * g).sum()

    jg = jax.grad(jloss, argnums=tuple(range(6)))(
        params, *[jnp.asarray(x) for x in _order(inp)[:5]])
    p = jg[0]

    def tm(x):       # batch-major JAX grad -> time-major
        return torch.from_numpy(np.array(x)).transpose(0, 1)

    ref = {"dty": tm(jg[1]), "dxg1": tm(jg[2]), "ds0": jg[3], "dctx": jg[4],
           "dctx_proj": jg[5], "duh1": p["gru1"]["uh"], "dbh1": p["gru1"]["bh"],
           "dua": p["attn"]["ua"], "dva": p["attn"]["va"],
           "dwi2": p["gru2"]["wi"], "dbi2": p["gru2"]["bi"],
           "duh2": p["gru2"]["uh"], "dbh2": p["gru2"]["bh"],
           "dws": p["readout"]["ws"], "dwc": p["readout"]["wc"]}
    for n, a in zip(GRADS, got):
        b = ref[n] if torch.is_tensor(ref[n]) else torch.from_numpy(np.array(ref[n]))
        assert cs._rel_err(a, b) <= RTOL, n


def test_model_with_column_passes_and_l2_slices_matches_plain():
    """The partition of a card with 4 SMs and 24 KB of shared memory (CTAs
    with several column tiles a product, some phases' slices in L2): the
    same arithmetic, within DEC_SCAN_RTOL of the plain versions."""
    cfg, params, inp, weights, args, g = _case(seed=4, B=4, Tt=6, T_=7, E=40,
                                               He=48, H=64, A=48)
    plan = _plan_of(args, weights, n_sms=4, max_smem=24 * 1024)
    prods = plan.fwd.products + plan.bwd.products
    assert any(p.col_passes > 1 for p in prods)
    assert {p.l2off >= 0 for p in prods} == {True, False}
    got = model_fwd(plan, *args, weights)
    want = ds.dec_scan_fwd_plain(*args, weights)
    errs = {k: cs._rel_err(got[k], want[k]) for k in ds.RESIDUALS}
    assert max(errs.values()) <= RTOL, errs
    g_t = torch.from_numpy(g).transpose(0, 1).contiguous()
    xg_t, ctx, ctxp, mask = args[1], args[3], args[4], args[5]
    got_g = model_bwd(plan, want, xg_t, ctx, ctxp, mask, weights, g_t)
    want_g = ds.dec_scan_bwd_plain(want, xg_t, ctx, ctxp, mask, weights, g_t)
    errs = {n: cs._rel_err(a, b) for n, a, b in zip(GRADS, got_g, want_g)}
    assert max(errs.values()) <= RTOL, errs


def test_one_tf32_pass_misses_the_tolerance():
    """The control: the same model with one TF32 product (big x big) in
    place of three misses DEC_SCAN_RTOL on the scan's outputs (t, s and
    the grads), where three passes keep it."""
    cfg, params, inp, weights, args, g = _case(seed=3, B=4, Tt=6, T_=7, E=40,
                                               He=48, H=64, A=48)
    plan = _plan_of(args, weights)
    want = ds.dec_scan_fwd_plain(*args, weights)
    g_t = torch.from_numpy(g).transpose(0, 1).contiguous()
    xg_t, ctx, ctxp, mask = args[1], args[3], args[4], args[5]
    want_g = ds.dec_scan_bwd_plain(want, xg_t, ctx, ctxp, mask, weights, g_t)

    def worst(passes):
        got = model_fwd(plan, *args, weights, passes=passes)
        got_g = model_bwd(plan, want, xg_t, ctx, ctxp, mask, weights, g_t,
                          passes=passes)
        fwd = {k: cs._rel_err(got[k], want[k]) for k in ("t", "s")}
        bwd = {n: cs._rel_err(a, b) for n, a, b in zip(GRADS, got_g, want_g)}
        return fwd, bwd

    fwd3, bwd3 = worst(3)
    assert max(fwd3.values()) <= RTOL and max(bwd3.values()) <= RTOL
    fwd1, bwd1 = worst(1)
    assert max(fwd1.values()) > RTOL, fwd1
    assert max(bwd1.values()) > RTOL, bwd1


def test_tanh_fast_probe_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        ds.tanh_fast_probe(torch.zeros(4))


def test_tanh_fast_model_within_its_bound():
    """The energies' tanh_fast modelled in fp32 stays within the 4.8e-7 of
    its documented bound of tanh over the energies' range (the card's
    tanh_fast against tanhf is measured by chip_smoke.py's phase 7)."""
    x = torch.linspace(-12.0, 12.0, 200001)
    assert float((tanh_fast(x) - torch.tanh(x.double()).float()).abs().max()) <= 4.8e-7
