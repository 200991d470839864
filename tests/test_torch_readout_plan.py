"""Kernel 1's design (``csrc/readout_topk.cu``) modelled in plain torch on
the CPU: its 3xTF32 product (each operand split into a TF32 part and a TF32
remainder, both rounded to nearest with ties away on the bits), its tiling
and 16-byte staging (``ops/readout_topk.py``'s split plan and tiles), and
its merge (per-split partials, merged in split order by the last block of a
row tile). The model is held against ``readout_topk_rows_plain`` and, through
``_combine``, against the JAX package's ``fused_readout_topk(impl="xla")``;
the CUDA kernel is held against the same plain version on the card by
chip_smoke.py.

Tolerances: top-K values and ids bit for bit where the model and the plain
version see the same fp32 logits; lse to 1e-6 relative (the merge sums the
splits' exponentials in another order than torch.logsumexp); the 3xTF32
product within a tenth of chip_smoke's READOUT_RTOL of fp64; the JAX
function's values to 1e-5 (the frameworks sum in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from vag_nmt_tpu.ops import pallas_readout_topk as jrt

from vag_nmt_tpu_torch.ops import readout_topk as rt
from vag_nmt_tpu_torch.ops.topk import stable_topk

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

FLOOR = -3.0e38                 # an empty slot's value
EMPTY = 2 ** 31 - 1             # an empty slot's id (INT_MAX)
TF32_DROPPED = 13               # mantissa bits an fp32 loses as TF32
# (R, V) of the plan cases: m30k and ikea_vag at beam 5 x 128 sentences,
# 7 sentences at a ragged V, a vocab of one tile, a row count past one
# block per SM, a single row
PLAN_SHAPES = [(640, 8000), (640, 16000), (35, 8003), (40, 100), (9000, 300),
               (1, 5)]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """The kernel's tf32_rna on fp32: add half of the last kept bit to the
    magnitude (int32 view), clear the dropped bits."""
    i = x.contiguous().view(torch.int32)
    return ((i + (1 << (TF32_DROPPED - 1))) & -(1 << TF32_DROPPED)).view(torch.float32)


def split_tf32(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def product_3xtf32(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """t @ w as the kernel's three TF32 products, each exact, summed in
    fp64 (the model of the products; the card sums them in fp32)."""
    (tb, ts), (wb, ws) = split_tf32(t), split_tf32(w)
    d = torch.float64
    return ts.to(d) @ wb.to(d) + tb.to(d) @ ws.to(d) + tb.to(d) @ wb.to(d)


def _phase2_random(R=640, E=256, V=8000):
    """chip_smoke's phase 2 "random" case, drawn the same way."""
    rng = np.random.RandomState(1)
    t = np.tanh(rng.randn(R, E)).astype(np.float32)
    w = (0.05 * rng.randn(E, V)).astype(np.float32)
    b = (0.1 * rng.randn(V)).astype(np.float32)
    return torch.from_numpy(t), torch.from_numpy(w), torch.from_numpy(b)


def _nearest_ties_away(x: np.ndarray) -> np.ndarray:
    """TF32 rounding by arithmetic in fp64: the two TF32 neighbours of each
    |x|, the nearer one, the larger magnitude on a tie."""
    a = np.abs(x.astype(np.float64))
    ulp = np.exp2(np.floor(np.log2(a)) - 10)
    lo = np.floor(a / ulp) * ulp
    up = lo + ulp
    r = np.where(a - lo < up - a, lo, up)
    return (np.sign(x) * r).astype(np.float32)


def test_tf32_rna_rounds_to_nearest_ties_away():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(4096), 1e-3 * rng.randn(1024),
                        1e4 * rng.randn(1024)]).astype(np.float32)
    one = np.float32(1.0)
    ties = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 3 * 2.0 ** -11 + 1,
                     0.75 + 2.0 ** -12], dtype=np.float32)
    x = np.concatenate([x, ties, [one, -one, 0.5]]).astype(np.float32)
    got = tf32_rna(torch.from_numpy(x)).numpy()
    assert (got.view(np.int32) & ((1 << TF32_DROPPED) - 1) == 0).all()
    np.testing.assert_array_equal(got, _nearest_ties_away(x))
    np.testing.assert_array_equal(got[-7:-3], np.array(
        [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -9, 0.75 + 2.0 ** -11],
        dtype=np.float32))


def test_split_is_exact_and_remainder_small():
    t, w, _ = _phase2_random(64, 256, 512)
    for x in (t, w):
        big, small = split_tf32(x)
        rest = x.double() - big.double()
        # x - big is exact in fp32, and the remainder is at most half a TF32
        # unit of x (2^-11 relative), rounded again to TF32
        assert torch.equal((x - big).double(), rest)
        assert (rest.abs() <= x.double().abs() * 2.0 ** -11).all()
        assert ((small.double() - rest).abs() <= rest.abs() * 2.0 ** -11).all()


def test_3xtf32_within_readout_rtol_of_fp64_and_one_pass_is_not():
    """At phase 2's shape and random generator: top-K values and lse of the
    3xTF32 logits within READOUT_RTOL / 10 of fp64, ids as the plain
    version's; a single TF32 product misses READOUT_RTOL."""
    t, w, b = _phase2_random()
    K = 5
    exact = t.double() @ w.double() + b.double()
    model = product_3xtf32(t, w) + b.double()
    one = tf32_rna(t).double() @ tf32_rna(w).double() + b.double()
    ev, ei = stable_topk(exact, K)
    exact_lse = torch.logsumexp(exact, -1)

    def rel(a, c):
        return float(((a - c).abs() / c.abs()).max())

    assert rel(model.gather(1, ei), ev) <= cs.READOUT_RTOL / 10
    assert rel(torch.logsumexp(model, -1), exact_lse) <= cs.READOUT_RTOL / 10
    assert rel(one.gather(1, ei), ev) > cs.READOUT_RTOL
    pv, pi, _ = rt.readout_topk_rows_plain(t, w, b, K)
    mi = stable_topk(model.float(), K)[1]
    assert torch.equal(mi.to(torch.int32), pi)


@pytest.mark.parametrize("kind", ["integer", "exact", "collision", "ban"])
def test_exact_checks_have_no_tf32_remainder(kind):
    """Phase 2's integer case and phase 13's _slots_case inputs: every
    remainder is 0 and the products' sums are exact in fp32, so the 3xTF32
    logits equal fp64's bit for bit."""
    R, E, V = 40, 256, 1000
    if kind == "integer":
        rng = np.random.RandomState(1)
        t = torch.from_numpy(rng.randint(-3, 4, (R, E)).astype(np.float32))
        w = torch.from_numpy(rng.randint(-3, 4, (E, V)).astype(np.float32))
    else:
        t, w, _, _ = cs._slots_case(torch, np, torch.device("cpu"), kind, R, E,
                                    V, seed=13)
    for x in (t, w):
        assert not split_tf32(x)[1].any()
    exact = t.double() @ w.double()
    assert torch.equal(product_3xtf32(t, w), exact)
    assert torch.equal(exact.float().double(), exact)


def _cta_grid(R, V):
    """The kernel's blocks: (row range, [column tiles as (first, end)]) of
    each (row tile, split), from the wrapper's plan and tiles."""
    n_split, split_cols = rt._split_plan(R, V)
    out = []
    for x in range(-(-R // rt._ROW_TILE)):
        rows = (x * rt._ROW_TILE, min(R, (x + 1) * rt._ROW_TILE))
        for y in range(n_split):
            c_begin, c_end = y * split_cols, min(V, (y + 1) * split_cols)
            tiles = [(c, min(c_end, c + rt._COL_TILE))
                     for c in range(c_begin, c_end, rt._COL_TILE)]
            out.append((rows, y, (c_begin, c_end), tiles))
    return out


@pytest.mark.parametrize("R,V", PLAN_SHAPES)
def test_tiling_covers_every_row_and_column_once(R, V):
    n_split, split_cols = rt._split_plan(R, V)
    row_tiles = -(-R // rt._ROW_TILE)
    assert split_cols % rt._COL_TILE == 0 and split_cols % rt._LANE_PERIOD == 0
    assert (n_split - 1) * split_cols < V <= n_split * split_cols
    assert row_tiles * n_split <= max(rt._TARGET_BLOCKS, row_tiles)
    seen = np.zeros((R, V), np.int32)
    for (r0, r1), _, _, tiles in _cta_grid(R, V):
        for c0, c1 in tiles:
            seen[r0:r1, c0:c1] += 1
    assert (seen == 1).all()


def _stage(t, w, b, rows, split, tile, e0):
    """One ring stage as the kernel's load_chunk fills it: t rows x BK,
    BK x BN of W and, with a tile's last chunk, its biases; by 16-byte
    copies (4 values in or out) where E (t) or V (W) is a multiple of 4,
    else 4-byte ones, zero-filled past R, E and the split's last column.
    Returns the stage and the element offsets of the 16-byte copies."""
    t, w, b = t.numpy(), w.numpy(), b.numpy()
    R, E = t.shape
    V = w.shape[1]
    BM, BN, BK = rt._ROW_TILE, rt._COL_TILE, rt._DEPTH_CHUNK
    (r0, _), (_, c_end), (c0, _) = rows, split, tile
    ts = np.zeros((BM, BK), np.float32)
    ws = np.zeros((BK, BN), np.float32)
    bs = np.zeros(BN, np.float32)
    offsets = []
    for r in range(BM):
        for k in range(0, BK, 4):
            row, e = r0 + r, e0 + k
            n = [j for j in range(4) if row < R and e + j < E]
            if E % 4 == 0 and n:
                assert len(n) == 4
                offsets.append(row * E + e)
            for j in n:
                ts[r, k + j] = t[row, e + j]
    for k in range(BK):
        for c in range(0, BN, 4):
            e, col = e0 + k, c0 + c
            n = [j for j in range(4) if e < E and col + j < c_end]
            if V % 4 == 0 and n:
                assert len(n) == 4
                offsets.append(e * V + col)
            for j in n:
                ws[k, c + j] = w[e, col + j]
    for c in range(0, BN, 4):
        for j in range(max(0, min(4, c_end - (c0 + c)))):
            bs[c + j] = b[c0 + c + j]
    return torch.from_numpy(ts), torch.from_numpy(ws), torch.from_numpy(bs), offsets


@pytest.mark.parametrize("R,E,V", [(640, 256, 8000), (35, 256, 8003),
                                   (35, 250, 8003), (3, 32, 200)])
def test_staging_of_ragged_rows_and_columns(R, E, V):
    """The stages of a row tile's last split (part-full rows where R is
    not a multiple of 64, the ragged last column tile) equal the zero-padded
    slices of t, W and b; the 16-byte copies start on 16-byte boundaries."""
    rng = np.random.RandomState(R + V)
    t = torch.from_numpy(rng.randn(R, E).astype(np.float32))
    w = torch.from_numpy(rng.randn(E, V).astype(np.float32))
    b = torch.from_numpy(rng.randn(V).astype(np.float32))
    BM, BN, BK = rt._ROW_TILE, rt._COL_TILE, rt._DEPTH_CHUNK
    rows, _, split, tiles = _cta_grid(R, V)[-1]
    pad = torch.zeros((rows[0] + BM, -(-E // BK) * BK + BK))
    pad[:R, :E] = t
    wpad = torch.zeros((-(-E // BK) * BK + BK, V + BN))
    wpad[:E, :split[1]] = w[:, :split[1]]
    for tile in (tiles[0], tiles[-1]):
        for e0 in range(0, E, BK):
            ts, ws, bs, offsets = _stage(t, w, b, rows, split, tile, e0)
            assert torch.equal(ts, pad[rows[0]:rows[0] + BM, e0:e0 + BK])
            assert torch.equal(ws, wpad[e0:e0 + BK, tile[0]:tile[0] + BN])
            assert all(o % 4 == 0 for o in offsets)
        want = torch.zeros(BN)
        want[:tile[1] - tile[0]] = b[tile[0]:tile[1]]
        assert torch.equal(bs, want)
    # where V is not a multiple of 4 some W rows start off a 16-byte
    # boundary, hence the 4-byte copies
    assert (V % 4 == 0) == all(e * V % 4 == 0 for e in range(E))


def _partials(x, K, split_cols):
    """Per split: the K best (value, id) of the row's columns there, its max
    and its sum of exp(x - max), as the kernel's blocks leave them."""
    V = x.shape[1]
    out = []
    for c0 in range(0, V, split_cols):
        xs = x[:, c0:c0 + split_cols]
        n = min(K, xs.shape[1])
        v, i = stable_topk(xs, n)
        v = torch.cat([v, torch.full((x.shape[0], K - n), FLOOR)], 1)
        i = torch.cat([i + c0, torch.full((x.shape[0], K - n), EMPTY)], 1)
        m = xs.amax(1)
        out.append((v, i, m, torch.exp(xs - m[:, None]).sum(1)))
    return out


def _merge(parts, K):
    """The last block's merge: splits in index order, (value desc, id asc),
    lse = M + log(sum_i s_i exp(m_i - M))."""
    v = torch.cat([p[0] for p in parts], 1)
    i = torch.cat([p[1] for p in parts], 1)
    key = torch.argsort(i, dim=1, stable=True)        # id asc ...
    v, i = v.gather(1, key), i.gather(1, key)
    top = torch.argsort(-v, dim=1, stable=True)[:, :K]  # ... under value desc
    M = torch.stack([p[2] for p in parts], 1).amax(1)
    S = sum(p[3] * torch.exp(p[2] - M) for p in parts)
    return v.gather(1, top), i.gather(1, top), M + torch.log(S)


@pytest.mark.parametrize("R,E,V", [(40, 32, 1000), (35, 64, 8003), (10, 16, 300)])
@pytest.mark.parametrize("ban", [False, True])
def test_split_merge_model_matches_plain(R, E, V, ban):
    rng = np.random.RandomState(V)
    t = torch.from_numpy(np.tanh(rng.randn(R, E)).astype(np.float32))
    w = torch.from_numpy((0.3 * rng.randn(E, V)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(V)).astype(np.float32))
    mask = torch.from_numpy((rng.rand(R, V) < 0.01).astype(np.uint8)) if ban else None
    K = 5
    pv, pi, pl = rt.readout_topk_rows_plain(t, w, b, K, mask)
    x = t @ w + b
    if mask is not None:
        x = torch.where(mask.bool(), torch.full_like(x, FLOOR), x)
    mv, mi, ml = _merge(_partials(x, K, rt._split_plan(R, V)[1]), K)
    assert torch.equal(mv, pv) and torch.equal(mi.to(torch.int32), pi)
    torch.testing.assert_close(ml, pl, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["exact", "collision"])
@pytest.mark.parametrize("sk", [1, 3])
def test_split_merge_model_of_shallow_slots(kind, sk):
    """Shallow slots through the kernel's split structure: each lane's top-sk
    and watermark, the union's top-K per split, the splits merged, viol =
    (largest watermark >= the merged K-th): the plain version's vals, ids
    and viol bit for bit."""
    R, E, V, K = 40, 256, 1000, 5
    t, w, b, _ = cs._slots_case(torch, np, torch.device("cpu"), kind, R, E, V,
                                seed=13)
    x = t @ w + b
    lanes = rt.kernel_lanes(R, V)
    kept = torch.full_like(x, FLOOR)
    wmark = torch.full((R,), FLOOR)
    for lane in lanes.unique():
        cols = (lanes == lane).nonzero()[:, 0]
        v, i = stable_topk(x[:, cols], min(sk + 1, len(cols)))
        kept.scatter_(1, cols[i[:, :sk]], v[:, :sk])
        if len(cols) > sk:
            wmark = torch.maximum(wmark, v[:, sk])
    kept_ids = torch.where(kept > FLOOR, torch.arange(V), EMPTY)
    rows = torch.arange(R)[:, None]
    split_cols = rt._split_plan(R, V)[1]
    parts = []
    for c0 in range(0, V, split_cols):      # (lse is not compared here)
        v, i = stable_topk(kept[:, c0:c0 + split_cols], K)
        parts.append((v, kept_ids[:, c0:][rows, i], v[:, 0], torch.ones(R)))
    mv, mi, _ = _merge(parts, K)
    viol = (wmark >= mv[:, K - 1]).to(torch.int32)
    pv, pi, _, pviol = rt.readout_topk_rows_plain(t, w, b, K, slots=sk)
    assert torch.equal(viol, pviol)
    assert torch.equal(mv, pv) and torch.equal(mi.to(torch.int32), pi)
    if kind == "collision":
        assert bool(viol.all())


@pytest.mark.parametrize("R,V", PLAN_SHAPES)
def test_kernel_lanes_follow_the_split_plan(R, V):
    """A lane is (split, (col % 64) / 4): the fold's thread of 4-column group
    g in every 64 columns of every column tile of a block's split."""
    lanes = rt.kernel_lanes(R, V)
    n_split, split_cols = rt._split_plan(R, V)
    per = rt._LANE_PERIOD // rt._LANE_COLS
    assert int(lanes.max()) < n_split * per
    for _, y, _, tiles in _cta_grid(R, V)[:n_split]:
        for c0, c1 in tiles:
            for col in range(c0, c1):
                g = (col - c0) % rt._LANE_PERIOD // rt._LANE_COLS
                assert int(lanes[col]) == y * per + g


def test_model_rows_through_combine_match_jax():
    """The 3xTF32 logits, per-split partials and merge, through _combine,
    against the JAX package's fused_readout_topk (impl="xla")."""
    B, K, E, V = 6, 5, 64, 1500
    rng = np.random.RandomState(7)
    t = np.tanh(rng.randn(B * K, E)).astype(np.float32)
    w = (0.2 * rng.randn(E, V)).astype(np.float32)
    b = (0.1 * rng.randn(V)).astype(np.float32)
    scores = rng.randn(B, K).astype(np.float32)
    fin = rng.rand(B, K) < 0.2
    x = (product_3xtf32(torch.from_numpy(t), torch.from_numpy(w))
         + torch.from_numpy(b).double()).float()
    rows = _merge(_partials(x, K, rt._split_plan(B * K, V)[1]), K)
    got = rt._combine(*rows, torch.from_numpy(scores), torch.from_numpy(fin),
                      V, 1)
    want = jrt.fused_readout_topk(jnp.asarray(t), jnp.asarray(w), jnp.asarray(b),
                                  jnp.asarray(scores), jnp.asarray(fin),
                                  pad_id=1, impl="xla")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)


# -- the K <= 16 instance (VAG_MAX_K = 16, the same tiling) ------------------

@pytest.mark.parametrize("K", [9, 12, 16])
@pytest.mark.parametrize("R,E,V", [(40, 32, 1000), (35, 64, 8003)])
def test_split_merge_model_at_the_k16_instance(R, E, V, K):
    """The per-split partials and the merge at K up to 16 (the K <= 16
    instance), against the plain version bit for bit; lse to 1e-6."""
    rng = np.random.RandomState(V + K)
    t = torch.from_numpy(np.tanh(rng.randn(R, E)).astype(np.float32))
    w = torch.from_numpy((0.3 * rng.randn(E, V)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(V)).astype(np.float32))
    pv, pi, pl = rt.readout_topk_rows_plain(t, w, b, K)
    mv, mi, ml = _merge(_partials(t @ w + b, K, rt._split_plan(R, V)[1]), K)
    assert torch.equal(mv, pv) and torch.equal(mi.to(torch.int32), pi)
    torch.testing.assert_close(ml, pl, rtol=1e-6, atol=0)


@pytest.mark.parametrize("K,sk", [(12, 1), (12, 3), (16, 8), (16, 15)])
def test_shallow_slots_at_the_k16_instance(K, sk):
    """The watermark mode at slot depths of the K <= 16 instance's SK
    templates (1..16): the lanes' top-sk and watermarks, the union's top-K
    merged over the splits, viol as the plain version's, bit for bit."""
    R, E, V = 40, 256, 1000
    t, w, b, _ = cs._slots_case(torch, np, torch.device("cpu"), "exact", R,
                                E, V, seed=K + sk)
    x = t @ w + b
    lanes = rt.kernel_lanes(R, V)
    kept = torch.full_like(x, FLOOR)
    wmark = torch.full((R,), FLOOR)
    for lane in lanes.unique():
        cols = (lanes == lane).nonzero()[:, 0]
        v, i = stable_topk(x[:, cols], min(sk + 1, len(cols)))
        kept.scatter_(1, cols[i[:, :sk]], v[:, :sk])
        if len(cols) > sk:
            wmark = torch.maximum(wmark, v[:, sk])
    kept_ids = torch.where(kept > FLOOR, torch.arange(V), EMPTY)
    rows = torch.arange(R)[:, None]
    split_cols = rt._split_plan(R, V)[1]
    parts = []
    for c0 in range(0, V, split_cols):
        v, i = stable_topk(kept[:, c0:c0 + split_cols], K)
        parts.append((v, kept_ids[:, c0:][rows, i], v[:, 0], torch.ones(R)))
    mv, mi, _ = _merge(parts, K)
    viol = (wmark >= mv[:, K - 1]).to(torch.int32)
    pv, pi, _, pviol = rt.readout_topk_rows_plain(t, w, b, K, slots=sk)
    assert torch.equal(viol, pviol)
    assert torch.equal(mv, pv) and torch.equal(mi.to(torch.int32), pi)


def test_k16_tiling_is_the_k8_tiling():
    """Both instances are built with one tiling; only VAG_MAX_K differs, and
    the lane merge of 16 slots a lane still fits the ring."""
    from vag_nmt_tpu_torch.ops import _build

    a = dict(_build._KERNELS["readout_topk"][1])
    b = dict(_build._KERNELS["readout_topk_k16"][1])
    assert (a.pop("VAG_MAX_K"), b.pop("VAG_MAX_K")) == (8, 16) and a == b
    BM, BN, BK = rt._ROW_TILE, rt._COL_TILE, rt._DEPTH_CHUNK
    TX = rt._LANE_PERIOD // rt._LANE_COLS
    assert BM * TX * (2 * 16 + 3) <= 3 * (BM * (BK + 4) + BK * (BN + 8) + BN)


# -- kernel 1b: the bf16 instances' sums ----------------------------------------
# (its design, csrc/readout_topk_bf16.cu: tests/test_torch_readout_bf16_plan.py)

BF = torch.bfloat16


def product_bf16_k16(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """t @ w as the bf16 build's mma chain: each 16-deep step's products
    exact (bf16 x bf16 is exact in fp32), its sum added to the fp32
    accumulator step by step (the model rounds each step's sum once)."""
    acc = torch.zeros((t.shape[0], w.shape[1]), dtype=torch.float32)
    td, wd = t.double(), w.double()
    for k in range(0, t.shape[1], 16):
        acc = (acc.double() + td[:, k:k + 16] @ wd[k:k + 16]).float()
    return acc


def test_bf16_products_within_readout_rtol_of_fp64():
    """At phase 17's shape and random generator, on bf16 t and W: the mma
    chain's logits (16-deep exact steps, fp32 accumulation) and the plain
    version's fp32 GEMM both within READOUT_RTOL / 10 of the exact products
    in fp64, with the plain version's ids; the fp32 operands the bf16 values
    were rounded from lie further than READOUT_RTOL off, so the bf16 and
    fp32 instances compute different functions (neither takes the other's
    operands by a cast)."""
    t, w, b = _phase2_random()
    t16, w16 = t.to(BF), w.to(BF)
    K = 5
    exact = t16.double() @ w16.double() + b.double()
    model = product_bf16_k16(t16, w16).double() + b.double()
    ev, ei = stable_topk(exact, K)

    def rel(a, c):
        return float(((a - c).abs() / c.abs()).max())

    assert rel(model.gather(1, ei), ev) <= cs.READOUT_RTOL / 10
    assert rel(torch.logsumexp(model, -1), torch.logsumexp(exact, -1)) <= \
        cs.READOUT_RTOL / 10
    pv, pi, pl = rt.readout_topk_rows_plain(t16, w16, b, K)
    assert rel(pv.double(), ev) <= cs.READOUT_RTOL / 10
    assert torch.equal(stable_topk(model.float(), K)[1].to(torch.int32), pi)
    f32 = t.double() @ w.double() + b.double()
    assert rel(f32.gather(1, ei), ev) > cs.READOUT_RTOL


@pytest.mark.parametrize("kind", ["integer", "exact", "collision", "ban"])
def test_bf16_exact_checks_are_exact(kind):
    """Phase 17's integer inputs and the _slots_case inputs it reuses are
    exact in bf16, and their products' sums exact in fp32: the bf16 build's
    logits equal fp64's bit for bit, whatever the order of the sums."""
    R, E, V = 40, 256, 1000
    if kind == "integer":
        rng = np.random.RandomState(1)
        t = torch.from_numpy(rng.randint(-3, 4, (R, E)).astype(np.float32))
        w = torch.from_numpy(rng.randint(-3, 4, (E, V)).astype(np.float32))
    else:
        t, w, _, _ = cs._slots_case(torch, np, torch.device("cpu"), kind, R, E,
                                    V, seed=13, bf16=True)
    t16, w16 = t.to(BF), w.to(BF)
    assert torch.equal(t16.float(), t.float()) and torch.equal(w16.float(),
                                                               w.float())
    exact = t16.double() @ w16.double()
    assert torch.equal(product_bf16_k16(t16, w16).double(), exact)
    assert torch.equal(exact.float().double(), exact)
