"""Kernel 3's design (``csrc/gru_bwd.cu``: the recompute, the reverse
recurrence as one persistent grid, the weight grads) modelled in plain
torch on the CPU.

The plan (``ops/gru_kernel.py::gru_bwd_plan``) covers every (row, unit) of
the per-step product dh += dhg @ Uh^T exactly once and fits the limits it
was given: at chip_smoke.py's phase-6 shapes, at H = 256, at every width
``gru_fwd_plan`` accepts on the H100, and on toy shapes and small cards,
where CTAs take several column tiles and the slices go to L2; it raises
where nothing fits.

The model follows the kernel: HG = h_prev @ Uh as streamed tiles (3xTF32,
the operands truncated to TF32 and their remainders, split_tr), the walk
against the scan order with the first step's cell backward alone, then per
step the CTAs' tiles of dhg[t_prev] @ Uh^T (3xTF32 rounded on the bits,
split_tf32, over the warps' k-slices added in order) with dh = base + acc,
dh += g[t] and the masked cell backward in the epilogue, dh0 after the
last; dUh = h_prev^T dHG as streamed tiles and dbh as the column sums of
eight row lanes added in order. It is held against ``gru_bwd_plain``, the
custom VJP of the JAX package's ``pallas_gru_scan`` (interpret mode) and
``jax.grad`` of its XLA scan, both directions, ragged masks, inputs from
numpy seeds. Tolerance: chip_smoke.py's GRU_BWD_RTOL (1e-4) over the
reference's scale (``_rel_err``), as the card's check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from tests.test_torch_dec_scan_plan import (_coverage, _plain, _streamed,
                                            _two_accumulators, split_tr)
from vag_nmt_tpu.ops import gru as jgru
from vag_nmt_tpu.ops.pallas_gru import _scan as pallas_scan

from vag_nmt_tpu_torch.ops import scan_tiles
from vag_nmt_tpu_torch.ops.gru_kernel import (_prev_states, gru_bwd_plain,
                                              gru_bwd_plan, gru_cell_bwd_plain,
                                              gru_fwd_plain, gru_fwd_plan)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

RTOL = cs.GRU_BWD_RTOL
H100 = (132, 232448)        # SMs, opt-in shared memory of a block (bytes)
# (B, H, n_sms, max_smem): phase 6's cases on the H100 and H = 256, then
# toy shapes and small cards (several column tiles a CTA, slices in L2).
CARD_SHAPES = [(B, H, *H100) for _, B, _, H in cs.GRU_BWD_CASES] + [
    (64, 256, *H100), (1024, 512, *H100)]
SMALL_SHAPES = [(37, 94, 4, 16 * 1024), (64, 512, 8, 232448),
                (9, 48, 2, 8 * 1024), (70, 32, 3, 6 * 1024)]


def _check_plan(plan, B, H, n_sms, max_smem):
    p = plan.product
    assert plan.ctas == n_sms and p.ctas <= n_sms and p.cta0 == 0
    assert p.unit_block == 0 and p.depth == 3 * H and p.cols == H
    assert p.tile_rows in scan_tiles.TILE_ROWS
    assert p.tile_cols % 8 == 0 and p.tile_cols // 8 <= scan_tiles.NI_MAX
    assert 1 <= p.col_slots <= p.col_tiles and p.col_tiles * p.tile_cols >= H
    assert plan.smem_bytes <= max_smem and plan.scratch_off % 4 == 0
    assert 4 * (plan.scratch_off + p.part_floats) <= plan.smem_bytes
    if plan.l2_floats:        # every CTA's slices in the buffer, in order
        assert p.l2off == 0 and plan.l2_floats == p.ctas * p.region_floats
    else:                     # resident, before the scratch region
        assert p.woff == 0 and p.l2off < 0 and p.region_floats <= plan.scratch_off
    assert len(plan.launch_args()) == 4 + 9
    assert (_coverage(p, B, n_sms) == 1).all()


@pytest.mark.parametrize("B,H,n_sms,max_smem", CARD_SHAPES + SMALL_SHAPES)
def test_plan_covers_each_output_once_within_limits(B, H, n_sms, max_smem):
    _check_plan(gru_bwd_plan(B, H, n_sms, max_smem), B, H, n_sms, max_smem)


def test_plan_at_the_training_shape_splits_rows():
    """m30k training's (B, H) = (64, 512) on the H100: Uh^T resident, 128
    CTAs of 32 rows x 8 units, each reading half of dhg[t] a step."""
    plan = gru_bwd_plan(64, 512, *H100)
    p = plan.product
    assert plan.l2_floats == 0 and p.ctas == 128 and p.passes == 1
    assert (p.tile_rows, p.tile_cols, p.row_slots) == (32, 8, 2)


def test_plan_takes_every_width_the_forward_takes():
    """Every H (a multiple of 16) that gru_fwd_plan accepts on the H100 at
    training's batch has a backward plan within the card's limits; on the
    H100 the widest is 2112 (132 unit tiles of 16, Uh's slices in L2 from
    1280 on)."""
    widths = []
    for H in range(16, 4096, 16):
        try:
            gru_fwd_plan(64, H, *H100)
        except ValueError:
            break
        widths.append(H)
    assert widths[-1] == 2112
    for H in widths:
        _check_plan(gru_bwd_plan(64, H, *H100), 64, H, *H100)


@pytest.mark.parametrize("B,H,n_sms,max_smem", SMALL_SHAPES)
def test_small_cards_take_several_tiles_a_cta_or_l2_slices(B, H, n_sms, max_smem):
    p = gru_bwd_plan(B, H, n_sms, max_smem)
    assert p.product.col_passes > 1 or p.l2_floats > 0


def test_l2_slices_where_the_weights_do_not_fit():
    plan = gru_bwd_plan(64, 512, 8, 232448)
    assert plan.l2_floats > 0 and plan.product.col_passes > 1


@pytest.mark.parametrize("args,what", [
    ((64, 512, 132, 2048), "do not fit"),
    ((0, 512, 132, 232448), "positive"),
    ((64, 0, 132, 232448), "positive"),
    ((64, 512, 0, 232448), "positive"),
])
def test_plan_raises_where_nothing_fits(args, what):
    with pytest.raises(ValueError, match=what):
        gru_bwd_plan(*args)


# --- the model --------------------------------------------------------------

def model_bwd(plan, xg_t, mask_t, uh, bh, h0, hs_t, g_t, reverse, passes=3):
    """The kernel's arithmetic: (dxg_t, duh, dbh, dh0)."""
    T, B, H3 = xg_t.shape
    H = H3 // 3
    hprev = _prev_states(hs_t, h0, reverse)
    rows = T * B
    # 1. the recompute over all rows (bh added where HG is read)
    hg = _streamed(hprev.reshape(rows, H), uh, passes).reshape(T, B, H3)
    # 2. the walk: the first step's cell alone, then a product a step
    order = list(range(T)) if reverse else list(range(T - 1, -1, -1))
    dxg, dhg = torch.zeros(T, B, H3), torch.zeros(T, B, H3)

    def cell(t, carry):
        dxg[t], dhg[t], base = gru_cell_bwd_plain(
            xg_t[t], hg[t] + bh, hprev[t], carry + g_t[t], mask_t[t][:, None])
        return base

    base = cell(order[0], torch.zeros(B, H))
    for s in range(1, T + 1):
        acc = _plain(plan.product, plan.ctas, dhg[order[s - 1]], uh.T, passes)
        assert not torch.isnan(acc).any()         # every output covered
        dh = base + acc
        if s < T:
            base = cell(order[s], dh)
    # 3. the weight grads over all rows, dbh by eight row lanes in order
    flat = dhg.reshape(rows, H3)
    duh = _streamed(hprev.reshape(rows, H).T, flat, passes)
    lanes = [flat[w::scan_tiles.WARPS].cumsum(0)[-1] if w < rows else torch.zeros(H3)
             for w in range(scan_tiles.WARPS)]
    dbh = torch.zeros(H3)
    for lane in lanes:
        dbh = dbh + lane
    return dxg, duh, dbh, dh


def _case(B, T_, E, H, seed):
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


def _torch_args(p, x, mask, h0, g, reverse):
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xg_t = (torch.from_numpy(x) @ tp["wi"] + tp["bi"]).transpose(0, 1).contiguous()
    mask_t = torch.from_numpy(mask).transpose(0, 1).contiguous()
    h0_t = torch.from_numpy(h0)
    hs_t = gru_fwd_plain(xg_t, mask_t, tp["uh"], tp["bh"], h0_t, reverse=reverse)
    g_t = torch.from_numpy(g).transpose(0, 1).contiguous()
    return xg_t, mask_t, tp["uh"], tp["bh"], h0_t, hs_t, g_t


NAMES = ("dxg", "duh", "dbh", "dh0")


def _within(got, want, what):
    errs = {n: cs._rel_err(a, torch.from_numpy(np.array(b)))
            for n, a, b in zip(NAMES, got, want)}
    assert max(errs.values()) <= RTOL, (what, errs)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T_,H,n_sms,max_smem,seed", [
    (9, 6, 48, *H100, 0),               # the card's plan: one tile a CTA
    (37, 5, 32, 3, 6 * 1024, 1),        # three SMs: several tiles a CTA
    (9, 4, 48, 2, 8 * 1024, 2),         # two SMs, little shared memory: L2
])
def test_model_matches_plain_and_jax(B, T_, H, n_sms, max_smem, seed, reverse):
    E = 12
    p, x, mask, h0, g = _case(B, T_, E, H, seed)
    args = _torch_args(p, x, mask, h0, g, reverse)
    plan = gru_bwd_plan(B, H, n_sms, max_smem)
    if n_sms < 132:
        assert plan.product.col_passes > 1 or plan.l2_floats > 0
    got = model_bwd(plan, *args, reverse)
    _within(got, gru_bwd_plain(*args, reverse=reverse), "plain")
    assert float(got[0][args[1] == 0].abs().max()) == 0.0   # masked: dxg = 0

    # the JAX Pallas scan's custom VJP (interpret mode) on the same inputs
    xg_t, mask_t, uh, bh, h0_t, _, g_t = (a.numpy() for a in args)
    hs, vjp = jax.vjp(
        lambda xg, u, b, h: pallas_scan(xg, jnp.asarray(mask_t)[..., None], u,
                                        b, h, reverse),
        *(jnp.asarray(a) for a in (xg_t, uh, bh, h0_t)))
    np.testing.assert_allclose(np.asarray(hs), args[5].numpy(), atol=1e-5, rtol=0)
    dxg, duh, dbh, dh0 = vjp(jnp.asarray(g_t))
    _within(got, (dxg, duh, dbh, dh0), "pallas")

    # jax.grad of the XLA scan, through wi, bi and x: dxg enters them as
    # x^T dxg, sum dxg and dxg wi^T
    def jloss(params, x_, h0_):
        hs_, _ = jgru.gru_scan(params, x_, jnp.asarray(mask), h0_,
                               reverse=reverse, impl="xla")
        return (hs_ * g).sum()

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want_p, want_x, want_h0 = jax.grad(jloss, argnums=(0, 1, 2))(
        jp, jnp.asarray(x), jnp.asarray(h0))
    dxg_bm = got[0].transpose(0, 1)                      # (B, T, 3H)
    derived = {"wi": torch.einsum("bte,btg->eg", torch.from_numpy(x), dxg_bm),
               "bi": dxg_bm.sum((0, 1)), "uh": got[1], "bh": got[2]}
    for k, v in derived.items():
        assert cs._rel_err(v, torch.from_numpy(np.asarray(want_p[k]))) <= RTOL, k
    dx = dxg_bm @ torch.from_numpy(p["wi"]).T
    assert cs._rel_err(dx, torch.from_numpy(np.asarray(want_x))) <= RTOL
    assert cs._rel_err(got[3], torch.from_numpy(np.asarray(want_h0))) <= RTOL


def test_split_tr_recompute_and_weight_grads_within_the_tolerance():
    """The streamed products' 3xTF32 (truncated split) at the kernel's
    depths, H = 512 and T*B = 1536 rows, stay within RTOL / 100 of fp64."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(256, 512, generator=g)
    w = torch.randn(512, 96, generator=g) / 20
    big, cor = _two_accumulators(a, w, 3, split_tr)
    ref = a.double() @ w.double()
    assert float(((big + cor).double() - ref).abs().max() / ref.abs().max()) <= RTOL / 100
    a = torch.randn(1536, 64, generator=g)
    d = torch.randn(1536, 96, generator=g)
    big, cor = _two_accumulators(a.T, d, 3, split_tr)
    ref = a.double().T @ d.double()
    assert float(((big + cor).double() - ref).abs().max() / ref.abs().max()) <= RTOL / 100
