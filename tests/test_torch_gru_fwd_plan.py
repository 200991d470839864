"""The tiling plan of the persistent GRU forward kernel
(``ops/gru_kernel.py::gru_fwd_plan``, ``csrc/gru_fwd.cu``), on the CPU.

The plan covers every (row, unit) of the output exactly once and fits the
limits it was given, at the three shapes the paths launch the kernel with
and at toy shapes; it raises where nothing fits. A torch model of the
kernel's partition (each CTA's rows and units, its gate columns gathered as
``uh[:, g*H + unit]``, the state summed chunk by chunk in the plan's depth)
is held against the plain version, the JAX package's Pallas scan (interpret
mode) and its XLA scan, both directions, ragged masks. Inputs from numpy
seeds; fp32, tolerance 1e-5 absolute (sums in another order). The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.ops import gru as jgru
from vag_nmt_tpu.ops.pallas_gru import pallas_gru_scan

from vag_nmt_tpu_torch.ops.gru_kernel import (
    GRU_PAD,
    GRU_STAGES,
    gru_fwd_plain,
    gru_fwd_plan,
    gru_fwd_smem_bytes,
    gru_gate_algebra,
)

torch.set_num_threads(1)

ATOL = 1e-5
H100 = (132, 232448)        # SMs, opt-in shared memory of a block (bytes)
# (B, H, n_sms, max_smem): the paths' shapes on the H100 (decode super
# chunk, training batch, ikea encoder), then toy shapes and small cards
# that force several row blocks per CTA and a ragged last block.
PATH_SHAPES = [(1024, 512, *H100), (64, 512, *H100), (512, 512, *H100)]
TOY_SHAPES = [(5, 16, *H100), (37, 32, 3, 16384), (70, 48, 3, 20000),
              (9, 64, 4, 20000), (300, 32, 1, 48 * 1024)]
# The ragged batches chip_smoke.py holds the kernel to on the card: a last
# row block part full (Multi30k test2016's 1000 lines, a toy batch), and
# two passes over the row blocks under the plan for half the H100's SMs.
RAGGED_SHAPES = [(1000, 512, *H100), (37, 512, *H100),
                 (1000, 512, 66, 232448)]


def _cells(plan, B, H):
    """Yield (cta, row, unit) for every output the kernel writes, walking
    the launch as csrc/gru_fwd.cu does."""
    R, RB, UB = plan.rows_per_thread, plan.row_block, plan.unit_block
    RG, UG = RB // R, UB // 2
    for x in range(plan.row_slots):
        for y in range(plan.unit_tiles):
            for rb in range(x, plan.row_blocks, plan.row_slots):
                for tid in range(plan.threads):
                    up, rg = tid % UG, tid // UG
                    for i in range(R):
                        row = rb * RB + rg + RG * i
                        if row >= B:
                            continue
                        for j in range(2):
                            yield (x, y), row, y * UB + 2 * up + j


@pytest.mark.parametrize("B,H,n_sms,max_smem",
                         PATH_SHAPES + TOY_SHAPES + RAGGED_SHAPES)
def test_plan_covers_each_output_once_within_limits(B, H, n_sms, max_smem):
    plan = gru_fwd_plan(B, H, n_sms, max_smem)
    R, RB, UB = plan.rows_per_thread, plan.row_block, plan.unit_block
    assert R in (1, 2, 4, 8) and RB % R == 0 and UB % 2 == 0
    assert plan.threads == (RB // R) * (UB // 2) <= 256
    assert plan.threads % (plan.chunk // 4) == 0      # whole chunk rows
    assert H % UB == 0 and plan.unit_tiles == H // UB
    assert H % plan.chunk == 0 and plan.chunk % 4 == 0
    assert plan.row_blocks == -(-B // RB)
    assert 1 <= plan.row_slots <= plan.row_blocks
    assert plan.row_slots * plan.unit_tiles <= n_sms        # co-resident
    assert plan.smem_bytes == gru_fwd_smem_bytes(H, RB, UB, plan.chunk)
    assert plan.smem_bytes == 4 * (H * 3 * UB
                                   + GRU_STAGES * RB * (plan.chunk + GRU_PAD))
    assert plan.smem_bytes <= max_smem
    hits = np.zeros((B, H), np.int64)
    for _, row, unit in _cells(plan, B, H):
        hits[row, unit] += 1
    assert (hits == 1).all()


def test_plan_at_the_path_shapes():
    """The H100 plans the paths launch: every SM the grid can use busy at
    the decode and ikea shapes, one pass per step at all three."""
    dec, train, ikea = (gru_fwd_plan(B, H, *H100) for B, H, *_ in PATH_SHAPES)
    assert dec.grid == (8, 16) and dec.row_block == 128
    assert ikea.grid == (8, 16) and ikea.row_block == 64
    assert all(p.passes == 1 for p in (dec, train, ikea))
    assert all(p.unit_block == 32 for p in (dec, train, ikea))


@pytest.mark.parametrize("B,H,n_sms,max_smem,why", [
    (64, 512, 132, 900, "shared memory"),      # not even the state ring
    (64, 512, 7, 232448, "SMs"),               # 8+ unit tiles, 7 SMs
    (64, 40, 132, 232448, "multiple of 16"),   # H not a unit block multiple
    (64, 24, 132, 232448, "multiple of 16"),
    (0, 512, 132, 232448, "positive"),
])
def test_plan_raises_where_nothing_fits(B, H, n_sms, max_smem, why):
    with pytest.raises(ValueError, match=why):
        gru_fwd_plan(B, H, n_sms, max_smem)


def _tile_model(plan, xg_t, mask_t, uh, bh, h0, reverse):
    """The kernel's partition in torch: per step, each CTA's row blocks,
    its units' three gate columns uh[:, g*H + unit], the state summed in
    chunk-deep slices in k order, the gates and the carry."""
    T, B, H3 = xg_t.shape
    H = H3 // 3
    RB, UB, KC = plan.row_block, plan.unit_block, plan.chunk
    out = torch.empty((T, B, H), dtype=torch.float32)
    hp = h0
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        for x in range(plan.row_slots):
            for y in range(plan.unit_tiles):
                units = torch.arange(y * UB, (y + 1) * UB)
                cols = torch.cat([g * H + units for g in range(3)])
                for rb in range(x, plan.row_blocks, plan.row_slots):
                    rows = torch.arange(rb * RB, min(B, (rb + 1) * RB))
                    acc = torch.zeros((len(rows), 3 * UB))
                    for k0 in range(0, H, KC):
                        acc = acc + hp[rows, k0:k0 + KC] @ uh[k0:k0 + KC][:, cols]
                    h = hp[rows][:, units]
                    h_new = gru_gate_algebra(xg_t[t][rows][:, cols],
                                             acc + bh[cols], h)
                    keep = mask_t[t][rows][:, None] > 0
                    out[t, rows[:, None], units[None, :]] = torch.where(keep, h_new, h)
        hp = out[t]
    return out


def _case(B, T, E, H, seed):
    rng = np.random.RandomState(seed)
    p = {"wi": rng.randn(E, 3 * H) * 0.3, "bi": rng.randn(3 * H) * 0.1,
         "uh": rng.randn(H, 3 * H) * (0.6 / np.sqrt(H)),
         "bh": rng.randn(3 * H) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.randn(B, T, E).astype(np.float32)
    lens = rng.randint(1, T + 1, B)
    lens[0] = T
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    h0 = (0.5 * rng.randn(B, H)).astype(np.float32)
    return p, x, mask, h0


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,H,n_sms,max_smem,seed", [
    (37, 32, 3, 16384, 0),      # several row blocks per CTA, ragged tail
    (9, 64, 4, 20000, 1),
    (70, 48, 3, 20000, 2),
])
def test_tile_model_matches_plain_and_jax(B, H, n_sms, max_smem, seed,
                                          reverse):
    T_, E = 6, 12
    p, x, mask, h0 = _case(B, T_, E, H, seed)
    plan = gru_fwd_plan(B, H, n_sms, max_smem)
    assert plan.passes > 1 or plan.row_slots > 1 or plan.unit_tiles > 1
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xg_t = (torch.from_numpy(x) @ tp["wi"] + tp["bi"]).transpose(0, 1).contiguous()
    mask_t = torch.from_numpy(mask).transpose(0, 1).contiguous()
    h0_t = torch.from_numpy(h0)
    got = _tile_model(plan, xg_t, mask_t, tp["uh"], tp["bh"], h0_t, reverse)
    want = gru_fwd_plain(xg_t, mask_t, tp["uh"], tp["bh"], h0_t, reverse=reverse)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    args = (jp, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(h0))
    hs_x, _ = jgru.gru_scan(*args, reverse=reverse, impl="xla")
    hs_p, _ = pallas_gru_scan(*args, reverse=reverse)
    for ref in (hs_x, hs_p):
        np.testing.assert_allclose(got.transpose(0, 1).numpy(),
                                   np.asarray(ref), atol=ATOL, rtol=0)


# -- widths the resident plan cannot hold: zero-padding and the L2 path -----

from vag_nmt_tpu_torch.ops.gru_kernel import gru_bwd_plan, pad_units, padded_width  # noqa: E402

# (B, H, n_sms, max_smem): the H100's widths past 1184, where Uh's slices
# go to L2, and toy cards whose shared memory holds the staged ring but no
# slice
L2_SHAPES = [(64, 1280, *H100), (64, 2048, *H100), (1024, 2048, *H100),
             (37, 64, 4, 13500), (37, 64, 3, 20500)]


@pytest.mark.parametrize("B", [1, 37, 64, 1024])
def test_plan_takes_every_width_the_backward_takes(B):
    """Every H in 16..2048 that gru_bwd_plan plans on the H100 has a
    forward plan at its padded width (the next multiple of 16)."""
    for H in range(16, 2049):
        gru_bwd_plan(B, H, *H100)
        plan = gru_fwd_plan(B, padded_width(H), *H100)
        assert plan.smem_bytes <= H100[1]
        assert plan.l2 or padded_width(H) <= 1184


@pytest.mark.parametrize("B,H,n_sms,max_smem", L2_SHAPES)
def test_l2_plan_covers_each_output_once_within_limits(B, H, n_sms, max_smem):
    plan = gru_fwd_plan(B, H, n_sms, max_smem)
    assert plan.l2
    assert plan.smem_bytes == gru_fwd_smem_bytes(H, plan.row_block,
                                                 plan.unit_block, plan.chunk,
                                                 l2=True)
    assert plan.smem_bytes == 4 * GRU_STAGES * (
        plan.row_block * (plan.chunk + GRU_PAD) + plan.chunk * 3 * plan.unit_block)
    assert plan.smem_bytes <= max_smem
    assert plan.row_slots * plan.unit_tiles <= n_sms
    assert plan.threads % (plan.chunk // 4) == 0 and H % plan.chunk == 0
    hits = np.zeros((B, H), np.int64)
    for _, row, unit in _cells(plan, B, H):
        hits[row, unit] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("reverse", [False, True])
def test_l2_tile_model_matches_plain_and_jax(reverse):
    """The L2 path's partition (the same walk, its slices read from one
    copy a unit tile) in torch against the plain version and both JAX
    scans."""
    B, H, n_sms, max_smem = 37, 64, 4, 13500
    p, x, mask, h0 = _case(B, 5, 12, H, seed=5)
    plan = gru_fwd_plan(B, H, n_sms, max_smem)
    assert plan.l2 and plan.passes > 1 and plan.unit_tiles > 1
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xg_t = (torch.from_numpy(x) @ tp["wi"] + tp["bi"]).transpose(0, 1).contiguous()
    mask_t = torch.from_numpy(mask).transpose(0, 1).contiguous()
    h0_t = torch.from_numpy(h0)
    got = _tile_model(plan, xg_t, mask_t, tp["uh"], tp["bh"], h0_t, reverse)
    want = gru_fwd_plain(xg_t, mask_t, tp["uh"], tp["bh"], h0_t, reverse=reverse)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    args = (jp, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(h0))
    hs_x, _ = jgru.gru_scan(*args, reverse=reverse, impl="xla")
    np.testing.assert_allclose(got.transpose(0, 1).numpy(), np.asarray(hs_x),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("H", [94, 100])
@pytest.mark.parametrize("reverse", [False, True])
def test_zero_padding_is_exact(H, reverse):
    """The wrapper's padding to a multiple of 16: each gate's block keeps
    its units; with inputs whose products and sums are exact in fp32
    whatever their order (multiples of 1/64, small), the step's product
    h @ Uh + bh of the padded scan is the unpadded one's bit for bit on the
    real units and exactly 0 on the padded ones; the padded units' states
    stay 0 bit for bit at every step, and the real units agree with the
    unpadded scan to 1e-6 (the CPU's elementwise kernels take another path
    on a strided view of 94 of 96 columns than on 94 contiguous ones)."""
    rng = np.random.RandomState(H)
    T, B = 6, 37
    Hp = padded_width(H)
    assert Hp % 16 == 0 and Hp - H < 16

    def dyadic(*shape):
        return torch.from_numpy((rng.randint(-16, 17, shape) / 64.0)
                                .astype(np.float32))

    xg_t, uh, bh, h0 = dyadic(T, B, 3 * H), dyadic(H, 3 * H), dyadic(3 * H), \
        dyadic(B, H)
    mask_t = torch.from_numpy((rng.rand(T, B) < 0.8).astype(np.float32))
    mask_t[0 if not reverse else T - 1] = 1.0
    xp, up, bp, hp0 = pad_units(xg_t, uh, bh, h0, Hp)
    for g in range(3):       # each gate's block keeps its own units
        assert torch.equal(up[:H, g * Hp:g * Hp + H], uh[:, g * H:(g + 1) * H])
        assert torch.equal(xp[..., g * Hp:g * Hp + H], xg_t[..., g * H:(g + 1) * H])
    hg_p = (hp0 @ up + bp).reshape(B, 3, Hp)
    assert torch.equal(hg_p[..., :H], (h0 @ uh + bh).reshape(B, 3, H))
    assert not hg_p[..., H:].any()
    want = gru_fwd_plain(xg_t, mask_t, uh, bh, h0, reverse=reverse)
    got = gru_fwd_plain(xp, mask_t, up, bp, hp0, reverse=reverse)
    assert not got[..., H:].any()                   # padded units: exact 0
    np.testing.assert_allclose(got[..., :H].numpy(), want.numpy(), atol=1e-6,
                               rtol=0)


# -- kernel 2b at the decode encoders' shapes (bf16 streams) -----------------

# (B, T): the m30k decode's super chunk and the ikea_vag encoder, as
# chip_smoke.py's phase 19 launches kernel 2b in a bf16 decode
BF16_DECODE_SHAPES = [(1024, 32), (512, 120)]
# one bf16 ulp of a state in [-1, 1)
BF16_ULP = 2.0 ** -8


def _tile_model_bf16(plan, xg_t, mask_t, uh, bh, h0, reverse):
    """_tile_model on bf16 streams, as the bf16 instance: each step's
    product on the carry rounded to bf16 and Uh rounded to bf16 (exact
    products, each (row, unit)'s summed in fp32 one depth after another,
    chunk by chunk, as its thread's FMA chain), the gates and the carry in
    fp32, the states written rounded to bf16."""
    from vag_nmt_tpu_torch.ops.gru_kernel import rbf

    T, B, H3 = xg_t.shape
    H = H3 // 3
    RB, UB, KC = plan.row_block, plan.unit_block, plan.chunk
    out = torch.empty((T, B, H), dtype=torch.bfloat16)
    w = rbf(uh)
    hp = h0.clone()
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hn = hp.clone()
        a = rbf(hp)
        for y in range(plan.unit_tiles):
            units = torch.arange(y * UB, (y + 1) * UB)
            cols = torch.cat([g * H + units for g in range(3)])
            # the row blocks' chains side by side (each row's is its own)
            acc = torch.zeros((B, 3 * UB))
            for k0 in range(0, H, KC):
                for k in range(k0, k0 + KC):
                    acc.addcmul_(a[:, k:k + 1], w[k, cols])
            for rb in range(plan.row_blocks):
                rows = torch.arange(rb * RB, min(B, (rb + 1) * RB))
                h = hp[rows][:, units]
                h_new = gru_gate_algebra(xg_t[t][rows][:, cols].float(),
                                         acc[rows] + bh[cols], h)
                keep = mask_t[t][rows][:, None] > 0
                hn[rows[:, None], units[None, :]] = torch.where(keep, h_new, h)
        hp = hn
        out[t] = hp.to(torch.bfloat16)
    return out


@pytest.mark.parametrize("B,T", BF16_DECODE_SHAPES)
def test_bf16_decode_shapes_plan_and_tile_model(B, T):
    """At the decode shapes the bf16 instance runs the fp32 plan (the plan
    reads B and H only, not T or the streams' type): one pass a step, every
    (row, unit) once. Its tile model on bf16 streams, over the first steps
    of a T-step scan at the full B and H = 512, both directions: the plain
    version's states in bf16 within BF16_ULP (the two sum the exact
    products in fp32 in their own orders: a state rounds one bf16 ulp apart
    where the sums straddle a rounding boundary)."""
    H = 512
    plan = gru_fwd_plan(B, H, *H100)
    assert plan == gru_fwd_plan(B, H, *H100) and plan.passes == 1
    assert plan.smem_bytes <= H100[1]
    hits = np.zeros((B, H), np.int32)
    for _, row, unit in _cells(plan, B, H):
        hits[row, unit] += 1
    assert (hits == 1).all()
    steps = 3
    p, x, mask, h0 = _case(B, T, 16, H, seed=B + T)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xg_t = (torch.from_numpy(x) @ tp["wi"] + tp["bi"]).transpose(0, 1)
    xg_t = xg_t[:steps].to(torch.bfloat16).contiguous()
    mask_t = torch.from_numpy(mask).transpose(0, 1)[:steps].contiguous()
    h0_t = torch.from_numpy(h0)
    for reverse in (False, True):
        got = _tile_model_bf16(plan, xg_t, mask_t, tp["uh"], tp["bh"], h0_t,
                               reverse)
        want = gru_fwd_plain(xg_t, mask_t, tp["uh"], tp["bh"], h0_t,
                             reverse=reverse)
        assert want.dtype == torch.bfloat16 and got.dtype == want.dtype
        assert float((got.float() - want.float()).abs().max()) <= BF16_ULP
