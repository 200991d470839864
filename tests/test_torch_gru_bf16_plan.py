"""The encoder GRU's bf16 instances (kernels 2b and 3b) in their Hopper
design, modelled in plain torch on the CPU.

Kernel 2b (``csrc/gru_fwd_bf16.cu``) runs each step as one of
``dec_scan.cuh``'s per-step products on gate tiles, tiled by
``ops/gru_kernel.py::gru_fwd_bf16_plan``. The plan covers every (row, unit)
of hg = h @ Uh exactly once, fits the card's shared memory with one CTA a
SM (so the cooperative grid is co-resident) at chip_smoke.py's shapes
((64, 24), (64, 128), the decode encoders' (1024, 32) and (512, 120), B =
1 and 37) and at every width ``gru_fwd_plan`` and ``gru_bwd_plan`` take,
and on small cards, where CTAs take several column tiles and the slices go
to L2. The model of the kernel (each step's product on the fp32 carry
rounded to bf16 and Uh rounded to bf16, the warps' k-slices summed in
order, the cell and the mask in fp32) gives the plain version's states
within one bf16 ulp, and those of the JAX package's Pallas scan on bf16
streams (interpret mode); at the decode encoders' shapes the plain
version's.

Kernel 3b (``csrc/gru_bwd.cu``, bf16 build) precomputes, in its
recompute's epilogue, every coefficient of the masked cell backward that
does not depend on dh (``gru_cell_coef``), so the carry's epilogue is a
few multiplies (``gru_cell_bwd_coef``). Run over a whole reverse walk in
fp32, both directions, masked rows, that arithmetic equals
``gru_bwd_plain`` to COEF_RTOL over each output's scale, and the Pallas
scan's custom VJP to chip_smoke.py's GRU_BWD_RTOL.

Both directions of a bi-GRU in one grid (``gru_fwd_pair_plan``,
``gru_bwd_pair_plan``): disjoint, co-resident CTA ranges, each covering
its outputs once. ``bidirectional_gru`` on bf16 streams goes through
``BiGRUScan`` when its scans need a gradient (on the CPU its plain route,
held against the JAX package's ``bidirectional_gru`` through
``pallas_gru_scan``), and else through two scans of kernel 2b's instance
that sums in k order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from tests.test_torch_dec_scan_plan import _coverage, _tiles_of
from vag_nmt_tpu.ops.pallas_gru import _scan as pallas_scan

from vag_nmt_tpu_torch.ops import scan_tiles
from vag_nmt_tpu_torch.ops.gru_kernel import (_prev_states, gru_bwd_plain,
                                              gru_bwd_plan, gru_cell_bwd_coef,
                                              gru_bwd_pair_plan, gru_cell_coef,
                                              gru_fwd_bf16_plan, gru_fwd_pair_plan,
                                              gru_fwd_plain, gru_fwd_plan,
                                              gru_gate_algebra, padded_width,
                                              rbf)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

H100 = (132, 232448)        # SMs, opt-in shared memory of a block (bytes)
# chip_smoke.py's batches of kernel 2b (phases 8b and 19), B = 1 and a
# ragged batch; the widths of phases 3b and 8b and the others either plan
# takes, each at its padded width
BATCHES = [64, 1024, 512, 1, 37]
WIDTHS = [94, 256, 512, 1024, 1280, 2048]
SMALL_CARDS = [(37, 96, 4, 16 * 1024), (64, 512, 8, 232448),
               (9, 48, 2, 8 * 1024), (70, 32, 3, 6 * 1024)]
BF16_ULP = 2.0 ** -8        # one bf16 ulp of a state in [-1, 1)
COEF_RTOL = 1e-5


def _check_fwd_plan(plan, B, H, n_sms, max_smem):
    p = plan.product
    assert 1 <= plan.ctas <= n_sms and plan.ctas == p.ctas and p.cta0 == 0
    assert p.unit_block > 0 and 3 * p.unit_block <= p.tile_cols
    assert p.depth == H and p.cols == 3 * H and p.bf16
    assert p.tile_rows in scan_tiles.TILE_ROWS
    assert p.tile_cols % 8 == 0 and p.tile_cols // 8 <= scan_tiles.NI_MAX
    assert 1 <= p.col_slots <= p.col_tiles and p.col_tiles * p.unit_block >= H
    # one CTA a SM fits: the cooperative grid is co-resident
    assert plan.smem_bytes <= max_smem and plan.scratch_off % 4 == 0
    assert 4 * (plan.scratch_off + p.part_floats) <= plan.smem_bytes
    if plan.l2_floats:        # every CTA's slices in the buffer, in order
        assert p.l2off == 0 and plan.l2_floats == p.ctas * p.region_floats
    else:                     # resident, before the scratch region
        assert p.woff == 0 and p.l2off < 0 and p.region_floats <= plan.scratch_off
    assert len(plan.launch_args()) == 4 + 9
    assert (_coverage(p, B, plan.ctas) == 1).all()


@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_fwd_plan_covers_each_unit_once_co_resident(B, H):
    Hp = padded_width(H)
    _check_fwd_plan(gru_fwd_bf16_plan(B, Hp, *H100), B, Hp, *H100)


def test_fwd_plan_takes_every_width_the_fp32_plans_take():
    """Every H that gru_fwd_plan (up to 2112 on the H100 at training's
    batch) and gru_bwd_plan take has a 2b plan within the card's limits;
    its bf16 slices stay resident up to the widest."""
    for H in range(16, 2112 + 16, 16):
        gru_fwd_plan(64, H, *H100)
        gru_bwd_plan(64, H, *H100, bf16=True)
        plan = gru_fwd_bf16_plan(64, H, *H100)
        _check_fwd_plan(plan, 64, H, *H100)
        assert plan.l2_floats == 0


def test_fwd_plan_at_the_training_shape():
    """m30k training's (64, 512): one gate tile of 8 units a CTA, the rows
    in two parts of 32, 128 CTAs, one pass a step."""
    p = gru_fwd_bf16_plan(64, 512, *H100).product
    assert (p.unit_block, p.tile_rows, p.row_slots, p.ctas, p.passes) == \
        (8, 32, 2, 128, 1)


@pytest.mark.parametrize("B,H,n_sms,max_smem", SMALL_CARDS)
def test_fwd_plan_on_small_cards(B, H, n_sms, max_smem):
    plan = gru_fwd_bf16_plan(B, H, n_sms, max_smem)
    assert plan.product.col_passes > 1 or plan.l2_floats > 0
    _check_fwd_plan(plan, B, H, n_sms, max_smem)


@pytest.mark.parametrize("args,what", [
    ((64, 94, *H100), "multiple of 16"),
    ((0, 512, *H100), "positive"),
    ((64, 512, 0, 232448), "positive"),
    ((64, 512, 132, 2048), "do not fit"),
])
def test_fwd_plan_raises(args, what):
    with pytest.raises(ValueError, match=what):
        gru_fwd_bf16_plan(*args)


@pytest.mark.parametrize("H", [94, 512, 1280])
@pytest.mark.parametrize("B", [64, 1024, 37])
def test_pair_plans_disjoint_and_co_resident(B, H):
    """Both directions in one grid (gru_fwd_pair_plan, gru_bwd_pair_plan):
    each direction's product on a CTA range of its own, the ranges
    disjoint and inside the grid, which fits the card one CTA a SM; each
    product covers every output once; the L2 slices, where any, one
    direction's after the other's."""
    Hp = padded_width(H)
    for plan, depth in ((gru_fwd_pair_plan(B, Hp, *H100), Hp),
                        (gru_bwd_pair_plan(B, Hp, *H100), 3 * Hp)):
        first, second = plan.products
        assert plan.ctas <= H100[0] and plan.smem_bytes <= H100[1]
        assert first.cta0 == 0 and first.ctas <= second.cta0
        assert second.cta0 + second.ctas <= plan.ctas
        assert len(plan.launch_args()) == 4 + 2 * 9
        for p in (first, second):
            assert p.depth == depth and 4 * (plan.scratch_off + p.part_floats) <= plan.smem_bytes
            assert (_coverage(p, B, plan.ctas) == 1).all()
        if plan.l2_floats:
            assert second.l2off == first.l2off + first.ctas * first.region_floats
            assert plan.l2_floats == 2 * first.ctas * first.region_floats


def test_pair_plans_on_small_cards():
    for plan in (gru_fwd_pair_plan(64, 512, 16, 232448),
                 gru_bwd_pair_plan(37, 96, 4, 16 * 1024)):
        first, second = plan.products
        assert first.cta0 + first.ctas <= second.cta0
        assert second.cta0 + second.ctas <= plan.ctas
    with pytest.raises(ValueError, match="at least 2"):
        gru_bwd_pair_plan(64, 512, 1, 232448)


# --- kernel 2b's model ------------------------------------------------------

def _kslices(p, K):
    """The warps' k-slices of a tile of product p: (lo, hi) depths of each,
    in the order the epilogue adds them (dec_scan.cuh's product_part)."""
    MT = p.tile_rows // 16
    KS = scan_tiles.WARPS // MT
    nslab = -(-K // 16)
    return [(16 * (ks * nslab // KS), min(K, 16 * ((ks + 1) * nslab // KS)))
            for ks in range(KS)]


def model_fwd_bf16(plan, xg_t, mask_t, uh, bh, h0, reverse):
    """Kernel 2b's arithmetic: per step each CTA's gate tiles of bf16(h) @
    bf16(Uh), each warp k-slice's sum of exact products in fp32, the slices
    added in order, then hg + bh, the cell and the mask in fp32 on the
    carry; the states out in bf16."""
    T, B, H3 = xg_t.shape
    H = H3 // 3
    p = plan.product
    w = rbf(uh)
    out = torch.empty((T, B, H), dtype=torch.bfloat16)
    h = h0.clone()
    slices = _kslices(p, H)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        a = rbf(h)
        hn = torch.full_like(h, float("nan"))
        for x in range(plan.ctas):
            cts, parts = _tiles_of(p, x)
            for ct in cts:
                units = torch.arange(ct * p.unit_block,
                                     min(H, (ct + 1) * p.unit_block))
                cols = torch.cat([g * H + units for g in range(3)])
                for rp in parts:
                    rows = torch.arange(rp * p.tile_rows,
                                        min(B, (rp + 1) * p.tile_rows))
                    if len(rows) == 0:
                        continue
                    acc = torch.zeros((len(rows), len(cols)))
                    for lo, hi in slices:
                        acc = acc + a[rows, lo:hi] @ w[lo:hi][:, cols]
                    hc = h[rows][:, units]
                    new = gru_gate_algebra(xg_t[t][rows][:, cols].float(),
                                           acc + bh[cols], hc)
                    keep = mask_t[t][rows][:, None] > 0
                    hn[rows[:, None], units[None, :]] = torch.where(keep, new, hc)
        assert not torch.isnan(hn).any()          # every (row, unit) written
        h = hn
        out[t] = h.to(torch.bfloat16)
    return out


def _case(B, T_, H, seed, E=12):
    """(params, x, mask, h0, g) from numpy: ragged lengths, one row full."""
    rng = np.random.RandomState(seed)
    p = {"wi": rng.randn(E, 3 * H) * 0.3, "bi": rng.randn(3 * H) * 0.1,
         "uh": rng.randn(H, 3 * H) * (0.8 / np.sqrt(H)),
         "bh": rng.randn(3 * H) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.randn(B, T_, E).astype(np.float32)
    lens = rng.randint(1, T_ + 1, B)
    lens[0] = T_
    mask = (np.arange(T_)[None, :] < lens[:, None]).astype(np.float32)
    h0 = (0.5 * rng.randn(B, H)).astype(np.float32)
    g = rng.randn(B, T_, H).astype(np.float32)
    return p, x, mask, h0, g


def _time_major(p, x, mask, h0, stream=torch.float32):
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xg_t = (torch.from_numpy(x) @ tp["wi"] + tp["bi"]).transpose(0, 1)
    return (xg_t.to(stream).contiguous(),
            torch.from_numpy(mask).transpose(0, 1).contiguous(), tp["uh"],
            tp["bh"], torch.from_numpy(h0))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T_,H,n_sms,max_smem,seed", [
    (9, 6, 48, *H100, 0),               # the card's plan: one tile a CTA
    (37, 5, 32, 3, 6 * 1024, 1),        # three SMs: several tiles a CTA
    (9, 4, 48, 2, 8 * 1024, 2),         # two SMs, little shared memory: L2
])
def test_fwd_model_matches_plain_and_pallas(B, T_, H, n_sms, max_smem, seed,
                                            reverse):
    p, x, mask, h0, _ = _case(B, T_, H, seed)
    args = _time_major(p, x, mask, h0, torch.bfloat16)
    plan = gru_fwd_bf16_plan(B, H, n_sms, max_smem)
    got = model_fwd_bf16(plan, *args, reverse)
    want = gru_fwd_plain(*args, reverse=reverse)
    assert got.dtype == want.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= BF16_ULP
    xg_t, mask_t, uh, bh, h0_t = args
    hs = pallas_scan(jnp.asarray(xg_t.float().numpy()).astype(jnp.bfloat16),
                     jnp.asarray(mask_t.numpy())[..., None], jnp.asarray(p["uh"]),
                     jnp.asarray(p["bh"]), jnp.asarray(h0), reverse)
    assert hs.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(hs.astype(jnp.float32)),
                               atol=BF16_ULP, rtol=0)


@pytest.mark.parametrize("B,T", [(1024, 32), (512, 120)])
def test_fwd_model_at_the_decode_shapes(B, T):
    """The decode encoders' shapes at H = 512 (the decode runs the k-order
    instance there, tests/test_torch_gru_fwd_plan.py; phase 19 also holds
    this one): the model over the first steps of the T-step scan, both
    directions, within one bf16 ulp of the plain version."""
    H, steps = 512, 3
    p, x, mask, h0, _ = _case(B, T, H, seed=B + T, E=16)
    xg_t, mask_t, uh, bh, h0_t = _time_major(p, x, mask, h0, torch.bfloat16)
    xg_t, mask_t = xg_t[:steps].contiguous(), mask_t[:steps].contiguous()
    plan = gru_fwd_bf16_plan(B, H, *H100)
    for reverse in (False, True):
        got = model_fwd_bf16(plan, xg_t, mask_t, uh, bh, h0_t, reverse)
        want = gru_fwd_plain(xg_t, mask_t, uh, bh, h0_t, reverse=reverse)
        assert float((got.float() - want.float()).abs().max()) <= BF16_ULP


# --- kernel 3b's carry on the precomputed coefficients ----------------------

def model_bwd_coef(xg_t, mask_t, uh, bh, h0, hs_t, g_t, reverse):
    """Kernel 3b's arithmetic in fp32: the recompute writes the cell's
    coefficients of every step at once, then the walk against the scan
    order runs the carry's epilogue on them (dh = carry + g[t], dxg, dhg
    and the carry's share as multiplies), a product a step; dUh and dbh
    from dHG. Returns (dxg_t, duh, dbh, dh0)."""
    T, B, H3 = xg_t.shape
    hprev = _prev_states(hs_t, h0, reverse)
    coef = torch.stack([gru_cell_coef(xg_t[t], hprev[t] @ uh + bh, hprev[t],
                                      mask_t[t][:, None]) for t in range(T)])
    assert coef.shape == (T, B, 5 * (H3 // 3))
    dxg, dhg = torch.zeros(T, B, H3), torch.zeros(T, B, H3)
    carry = torch.zeros_like(h0)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        dxg[t], dhg[t], base = gru_cell_bwd_coef(coef[t], carry + g_t[t])
        carry = base + dhg[t] @ uh.T
    duh = torch.einsum("tbh,tbg->hg", hprev, dhg)
    return dxg, duh, dhg.sum((0, 1)), carry


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T_,H,seed", [(9, 12, 48, 3), (37, 7, 32, 4)])
def test_coef_walk_matches_plain_and_pallas(B, T_, H, seed, reverse):
    p, x, mask, h0, g = _case(B, T_, H, seed)
    xg_t, mask_t, uh, bh, h0_t = _time_major(p, x, mask, h0)
    hs_t = gru_fwd_plain(xg_t, mask_t, uh, bh, h0_t, reverse=reverse)
    g_t = torch.from_numpy(g).transpose(0, 1).contiguous()
    args = (xg_t, mask_t, uh, bh, h0_t, hs_t, g_t)
    assert (mask_t == 0).any()
    got = model_bwd_coef(*args, reverse)
    want = gru_bwd_plain(*args, reverse=reverse)
    for name, a, b in zip(("dxg", "duh", "dbh", "dh0"), got, want):
        assert cs._rel_err(a, b) <= COEF_RTOL, name
    assert float(got[0][mask_t == 0].abs().max()) == 0.0   # masked: dxg = 0

    # the JAX Pallas scan's custom VJP (interpret mode) on the same inputs
    import jax

    _, vjp = jax.vjp(
        lambda xg, u, b, h: pallas_scan(xg, jnp.asarray(mask_t.numpy())[..., None],
                                        u, b, h, reverse),
        *(jnp.asarray(a.numpy()) for a in (xg_t, uh, bh, h0_t)))
    for name, a, b in zip(("dxg", "duh", "dbh", "dh0"), got,
                          vjp(jnp.asarray(g_t.numpy()))):
        assert cs._rel_err(a, torch.from_numpy(np.array(b))) <= cs.GRU_BWD_RTOL, name


def test_coef_share_is_the_plain_carry_share():
    """The carry's share dh * c_share equals gru_cell_bwd_plain's base =
    dh m z + dh (1 - m) bit for bit at m in {0, 1}, and a masked row's
    coefficients of dxg and dhg are 0."""
    rng = np.random.RandomState(5)
    N, H = 16, 8
    xg = torch.from_numpy(rng.randn(N, 3 * H).astype(np.float32))
    hg = torch.from_numpy(rng.randn(N, 3 * H).astype(np.float32))
    h = torch.from_numpy(rng.randn(N, H).astype(np.float32))
    dh = torch.from_numpy(rng.randn(N, H).astype(np.float32))
    m = torch.from_numpy((rng.rand(N, 1) > 0.5).astype(np.float32))
    m[0], m[1] = 0.0, 1.0
    from vag_nmt_tpu_torch.ops.gru_kernel import gru_cell_bwd_plain

    c = gru_cell_coef(xg, hg, h, m)
    _, _, base = gru_cell_bwd_coef(c, dh)
    assert torch.equal(base, gru_cell_bwd_plain(xg, hg, h, dh, m)[2])
    assert float(c[m[:, 0] == 0][:, :4 * H].abs().max()) == 0.0


# --- both directions in one call (BiGRUScan) --------------------------------

# As tests/test_torch_bf16.py: the same rounding points as the Pallas
# kernel in interpret mode, the sums in other orders (two bf16 ulps of a
# state); gradients relative to the largest |grad|.
PALLAS_TOL = 8e-3
GRAD_SCALE_TOL = 6e-2 / 4


def _graph_nodes(fn):
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        todo.extend(g for g, _ in f.next_functions)
    return {type(f).__name__ for f in seen}


def test_bidirectional_pair_matches_pallas():
    """bidirectional_gru on bf16 streams goes through BiGRUScan (on the
    CPU its plain route: gru_fwd_pair and gru_bwd_pair's plain versions)
    and gives the JAX package's bidirectional_gru through pallas_gru_scan
    (interpret mode) in the states, both final states and the grads of
    both directions' wi, bi, uh and bh."""
    import jax

    from vag_nmt_tpu.ops.gru import bidirectional_gru as j_bigru
    from vag_nmt_tpu.ops.gru import init_gru_params as j_init
    from vag_nmt_tpu_torch.ops.gru import bidirectional_gru

    B, T_, E, H = 8, 10, 16, 32
    jp = (j_init(jax.random.key(0), E, H, "f"), j_init(jax.random.key(1), E, H, "b"))
    rng = np.random.RandomState(7)
    x = jnp.asarray(rng.randn(B, T_, E).astype(np.float32)).astype(jnp.bfloat16)
    lens = rng.randint(1, T_ + 1, B)
    lens[0] = T_
    mask = jnp.asarray((np.arange(T_)[None, :] < lens[:, None]).astype(np.float32))
    w = np.arange(1, 2 * H + 1, dtype=np.float32)[None, None, :] / H

    def jloss(pf, pb):
        s, hf, hb = j_bigru(pf, pb, x, mask, impl="pallas")
        return ((s.astype(jnp.float32) * w).sum()
                + 2.0 * (hf.astype(jnp.float32) ** 2).sum()
                + (hb.astype(jnp.float32) ** 3).sum())

    js, jhf, jhb = j_bigru(*jp, x, mask, impl="pallas")
    jg = jax.grad(jloss, argnums=(0, 1))(*jp)

    tp = [{k: torch.from_numpy(np.array(v, np.float32)).requires_grad_(True)
           for k, v in p.items()} for p in jp]
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    s, hf, hb = bidirectional_gru(*tp, xt, torch.from_numpy(np.array(mask)),
                                  impl="plain")
    assert s.dtype == torch.bfloat16 and "BiGRUScanBackward" in _graph_nodes(s.grad_fn)
    for got, want in ((s, js), (hf, jhf), (hb, jhb)):
        np.testing.assert_allclose(got.float().detach().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=PALLAS_TOL, rtol=PALLAS_TOL)
    ((s.float() * torch.from_numpy(w)).sum() + 2.0 * (hf.float() ** 2).sum()
     + (hb.float() ** 3).sum()).backward()
    for d in range(2):
        for k in ("wi", "bi", "uh", "bh"):
            want = torch.from_numpy(np.array(jg[d][k], np.float32))
            assert cs._rel_err(tp[d][k].grad, want) <= GRAD_SCALE_TOL, (d, k)


def test_scans_that_need_no_gradient_take_the_k_order_instance(monkeypatch):
    """bidirectional_gru on bf16 streams: a decode's (no input needs a
    gradient) is two gru_scan calls whose gru_fwd takes the instance that
    sums in k order; a training scan's (params that need one) is one
    BiGRUScan, which calls no single-scan gru_fwd."""
    from vag_nmt_tpu_torch.ops import gru as tg

    calls, real = [], tg.gru_fwd

    def spy(*a, **k):
        calls.append(k.get("k_order"))
        return real(*a, **k)

    monkeypatch.setattr(tg, "gru_fwd", spy)
    B, T_, E, H = 3, 5, 6, 16
    g = torch.Generator().manual_seed(3)
    pf, pb = (tg.init_gru_params(g, E, H) for _ in range(2))
    x = torch.randn(B, T_, E, generator=g).to(torch.bfloat16)
    mask = torch.ones(B, T_)
    s, _, _ = tg.bidirectional_gru(pf, pb, x, mask)
    assert calls == [True, True] and s.grad_fn is None
    calls.clear()
    for p in (pf, pb):
        for v in p.values():
            v.requires_grad_(True)
    s, _, _ = tg.bidirectional_gru(pf, pb, x, mask)
    assert calls == [] and "BiGRUScanBackward" in _graph_nodes(s.grad_fn)
