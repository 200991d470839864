"""PyTorch port ops against the JAX package: the GRU scan (against the XLA
scan and the Pallas kernel in interpret mode), the three attention
functions, the plain beam top-K (against the lane-parallel kernel in
interpret mode and the xla branch), and the fused readout->top-K (against
the JAX kernel in interpret mode and its xla branch). Inputs are made with
numpy from a seed and handed to both. All on the CPU, where the port's
wrappers run their plain versions; the CUDA kernels are held against the
same plain versions on the card by chip_smoke.py.

Tolerances: 1e-5 absolute for float outputs (fp32, sums in another
order); token ids exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.ops import attention as jatt
from vag_nmt_tpu.ops import gru as jgru
from vag_nmt_tpu.ops.pallas_gru import pallas_gru_scan
from vag_nmt_tpu.ops.pallas_readout_topk import fused_readout_topk as j_fused
from vag_nmt_tpu.ops.pallas_topk import beam_topk as j_beam_topk

from vag_nmt_tpu_torch.ops import attention as att
from vag_nmt_tpu_torch.ops import gru
from vag_nmt_tpu_torch.ops import readout_topk as rt
from vag_nmt_tpu_torch.ops.dec_scan import dec_scan_bwd, dec_scan_fwd
from vag_nmt_tpu_torch.ops.gru_kernel import gru_bwd, gru_fwd
from vag_nmt_tpu_torch.ops.topk import beam_topk

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ATOL = 1e-5


def T(x):
    return torch.from_numpy(np.array(x))


def _gru_case(B=5, T_=7, E=12, H=16, seed=0):
    rng = np.random.RandomState(seed)
    p = {"wi": rng.randn(E, 3 * H) * 0.3, "bi": rng.randn(3 * H) * 0.1,
         "uh": rng.randn(H, 3 * H) * 0.3, "bh": rng.randn(3 * H) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.randn(B, T_, E).astype(np.float32)
    lens = np.array([T_, 1, 3, T_ - 1, 4][:B])
    mask = (np.arange(T_)[None, :] < lens[:, None]).astype(np.float32)
    h0 = (0.5 * rng.randn(B, H)).astype(np.float32)
    return p, x, mask, h0


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_matches_jax_xla_and_pallas(reverse):
    p, x, mask, h0 = _gru_case()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    hs_x, hl_x = jgru.gru_scan(jp, jnp.asarray(x), jnp.asarray(mask),
                               jnp.asarray(h0), reverse=reverse, impl="xla")
    hs_p, hl_p = pallas_gru_scan(jp, jnp.asarray(x), jnp.asarray(mask),
                                 jnp.asarray(h0), reverse=reverse)
    hs, hl = gru.gru_scan({k: T(v) for k, v in p.items()}, T(x), T(mask),
                          T(h0), reverse=reverse, impl="plain")
    for ref_s, ref_l in ((hs_x, hl_x), (hs_p, hl_p)):
        np.testing.assert_allclose(hs.numpy(), np.asarray(ref_s), atol=ATOL)
        np.testing.assert_allclose(hl.numpy(), np.asarray(ref_l), atol=ATOL)


def test_bidirectional_gru_matches_jax():
    pf, x, mask, _ = _gru_case(seed=1)
    pb, _, _, _ = _gru_case(seed=2)
    out_j, hf_j, hb_j = jgru.bidirectional_gru(
        jax.tree.map(jnp.asarray, pf), jax.tree.map(jnp.asarray, pb),
        jnp.asarray(x), jnp.asarray(mask), impl="xla")
    out, hf, hb = gru.bidirectional_gru(
        {k: T(v) for k, v in pf.items()}, {k: T(v) for k, v in pb.items()},
        T(x), T(mask))
    for a, b in ((out, out_j), (hf, hf_j), (hb, hb_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_gru_cell_matches_jax():
    p, _, _, h0 = _gru_case(seed=3)
    xg = np.random.RandomState(4).randn(5, 48).astype(np.float32)
    want = jgru.gru_cell_from_xgates(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(xg), jnp.asarray(h0))
    got = gru.gru_cell_from_xgates({k: T(v) for k, v in p.items()}, T(xg),
                                   T(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_gru_impl_selection_on_cpu():
    p, x, mask, h0 = _gru_case(seed=5)
    tp = {k: T(v) for k, v in p.items()}
    ref, _ = gru.gru_scan(tp, T(x), T(mask), T(h0), impl="plain")
    for impl in ("auto", "xla"):
        got, _ = gru.gru_scan(tp, T(x), T(mask), T(h0), impl=impl)
        assert torch.equal(got, ref)
    for impl in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="CUDA"):
            gru.gru_scan(tp, T(x), T(mask), T(h0), impl=impl)
    with pytest.raises(ValueError, match="CUDA"):
        gru_fwd(T(np.zeros((2, 3, 48), np.float32)),
                T(np.ones((2, 3), np.float32)), tp["uh"], tp["bh"],
                T(np.zeros((3, 16), np.float32)), impl="kernel")


def _attn_case(N=4, K=3, T_=6, C=10, Q=8, A=7, seed=0):
    rng = np.random.RandomState(seed)
    p = {"wa": rng.randn(C, A), "ua": rng.randn(Q, A), "ba": rng.randn(A),
         "va": rng.randn(A)}
    p = {k: (0.5 * v).astype(np.float32) for k, v in p.items()}
    ctx = rng.randn(N, T_, C).astype(np.float32)
    lens = np.array([T_, 1, 4, 2][:N])
    mask = (np.arange(T_)[None, :] < lens[:, None]).astype(np.float32)
    query = rng.randn(N, Q).astype(np.float32)
    query_b = rng.randn(N, K, Q).astype(np.float32)
    return p, ctx, mask, query, query_b


def test_bahdanau_attend_matches_jax():
    p, ctx, mask, q, _ = _attn_case()
    jp = jax.tree.map(jnp.asarray, p)
    cp_j = jatt.precompute_ctx_proj(jp, jnp.asarray(ctx))
    c_j, w_j = jatt.bahdanau_attend(jp, jnp.asarray(q), jnp.asarray(ctx),
                                    cp_j, jnp.asarray(mask))
    tp = {k: T(v) for k, v in p.items()}
    cp = att.precompute_ctx_proj(tp, T(ctx))
    c, w = att.bahdanau_attend(tp, T(q), T(ctx), cp, T(mask))
    np.testing.assert_allclose(cp.numpy(), np.asarray(cp_j), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=ATOL)
    assert float(w[1, 1:].abs().max()) == 0.0     # pads get exactly 0


@pytest.mark.parametrize("pre_projected", [False, True])
def test_bahdanau_attend_beams_match_jax(pre_projected):
    p, ctx, mask, _, qb = _attn_case(seed=1)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: T(v) for k, v in p.items()}
    cp_j = jatt.precompute_ctx_proj(jp, jnp.asarray(ctx))
    cp = att.precompute_ctx_proj(tp, T(ctx))
    if pre_projected:
        q = (qb @ p["ua"]).astype(np.float32)
        c_j, w_j = jatt.bahdanau_attend_beams_q(jp, jnp.asarray(q),
                                                jnp.asarray(ctx), cp_j,
                                                jnp.asarray(mask))
        c, w = att.bahdanau_attend_beams_q(tp, T(q), T(ctx), cp, T(mask))
    else:
        c_j, w_j = jatt.bahdanau_attend_beams(jp, jnp.asarray(qb),
                                              jnp.asarray(ctx), cp_j,
                                              jnp.asarray(mask))
        c, w = att.bahdanau_attend_beams(tp, T(qb), T(ctx), cp, T(mask))
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=ATOL)


CASES = ["random", "integer", "all_finished", "ban"]


def _topk_case(kind, B=4, K=3, V=300, E=16, M=6, seed=0):
    rng = np.random.RandomState(seed + CASES.index(kind))
    if kind == "integer":
        t = rng.randint(-3, 4, (B * K, E)).astype(np.float32)
        w = rng.randint(-3, 4, (E, V)).astype(np.float32)
        b = rng.randint(-3, 4, V).astype(np.float32)
        scores = rng.randint(-5, 5, (B, K)).astype(np.float32)
    else:
        t = rng.randn(B * K, E).astype(np.float32)
        w = rng.randn(E, V).astype(np.float32)
        b = rng.randn(V).astype(np.float32)
        scores = rng.randn(B, K).astype(np.float32)
    fin = rng.rand(B, K) < (1.0 if kind == "all_finished" else 0.3)
    ban = None
    if kind == "ban":
        ban = rng.randint(0, V + 1, (B * K, M)).astype(np.int32)  # V = none
        ban[:, -1] = ban[:, 0]                                   # duplicates
    return t, w, b, scores, fin, ban


def _assert_topk(got, want, tol):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["random", "integer", "all_finished"])
def test_beam_topk_matches_jax(kind):
    t, w, b, scores, fin, _ = _topk_case(kind)
    logits = (t @ w + b).reshape(4, 3, -1)
    want = j_beam_topk(jnp.asarray(logits), jnp.asarray(scores),
                       jnp.asarray(fin), impl="xla")
    got = beam_topk(T(logits), T(scores), T(fin))
    # integer-valued logits are exact; only the log-sum-exp rounds
    _assert_topk(got, want, 1e-6 if kind == "integer" else ATOL)


def _lanes_case(B, K, V, ff, ties, seed):
    """tests/test_pallas_topk.py's inputs; with ties, integer logits whose
    rows repeat across a sentence's beams under equal scores, so candidates
    tie within a row, across rows and across beams."""
    rng = np.random.RandomState(seed)
    if ties:
        logits = np.repeat(rng.randint(-2, 3, (B, 1, V)), K, 1).astype(np.float32)
        scores = np.repeat(rng.randint(-3, 1, (B, 1)), K, 1).astype(np.float32)
    else:
        logits = (rng.randn(B, K, V) * 3.0).astype(np.float32)
        scores = rng.randn(B, K).astype(np.float32)
    return logits, scores, rng.rand(B, K) < ff


@pytest.mark.parametrize("jax_impl", ["pallas_lanes", "xla"])
@pytest.mark.parametrize("B,K,V,ff,ties", [
    (8, 5, 1000, 0.0, False),
    (8, 5, 1000, 0.4, False),      # mixed finished rows
    (16, 5, 1303, 0.2, False),     # V not a multiple of the vocab block
    (4, 3, 512, 1.0, False),       # everything finished
    (2, 1, 700, 0.0, False),       # K=1
    (8, 5, 1000, 0.0, True),       # forced ties
    (8, 5, 1000, 0.5, True),       # ties and frozen rows
    (3, 8, 129, 0.3, True),        # the kernel's largest K
])
def test_beam_topk_plain_matches_jax_lanes_and_xla(B, K, V, ff, ties,
                                                   jax_impl):
    """The plain beam_topk (what the CUDA kernel is held to exactly on the
    card) equals the JAX lane-parallel kernel in interpret mode and its xla
    branch: flat ids exactly, ties to the smaller flat id; values exactly
    on the integer-valued tie cases and else to ATOL, since the two
    frameworks sum the log-sum-exp in another order (a few ulp of lse)."""
    logits, scores, fin = _lanes_case(B, K, V, ff, ties, seed=B + V)
    want = j_beam_topk(jnp.asarray(logits), jnp.asarray(scores),
                       jnp.asarray(fin), impl=jax_impl)
    got = beam_topk(T(logits), T(scores), T(fin), impl="plain")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    tol = 0.0 if ties or ff == 1.0 else ATOL
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=tol)


def test_beam_topk_impl_selection(monkeypatch):
    logits, scores, fin = _lanes_case(2, 3, 50, 0.3, True, seed=1)
    ref = beam_topk(T(logits), T(scores), T(fin), impl="plain")
    for impl in ("auto", "xla"):
        got = beam_topk(T(logits), T(scores), T(fin), impl=impl)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for impl in ("kernel", "pallas_lanes"):
        with pytest.raises(ValueError, match="CUDA"):
            beam_topk(T(logits), T(scores), T(fin), impl=impl)
    monkeypatch.setenv("VAG_TOPK_IMPL", "pallas_lanes")
    with pytest.raises(ValueError, match="CUDA"):
        beam_topk(T(logits), T(scores), T(fin))
    for knob in ("pallas", "pallas_rows"):
        monkeypatch.setenv("VAG_TOPK_IMPL", knob)
        with pytest.raises(NotImplementedError, match="later slice"):
            beam_topk(T(logits), T(scores), T(fin))
    monkeypatch.setenv("VAG_TOPK_IMPL", "xla")
    got = beam_topk(T(logits), T(scores), T(fin))
    assert torch.equal(got[1], ref[1])


@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
@pytest.mark.parametrize("kind", CASES)
def test_fused_readout_topk_matches_jax(kind, jax_impl):
    t, w, b, scores, fin, ban = _topk_case(kind)
    want = j_fused(jnp.asarray(t), jnp.asarray(w), jnp.asarray(b),
                   jnp.asarray(scores), jnp.asarray(fin),
                   None if ban is None else jnp.asarray(ban), impl=jax_impl)
    got = rt.fused_readout_topk(T(t), T(w), T(b), T(scores), T(fin),
                                None if ban is None else T(ban), impl="plain")
    # The JAX kernel sums its log-sum-exp per lane, in another order.
    _assert_topk(got, want, 1e-6 if kind == "integer" and jax_impl == "xla"
                 else ATOL)


@pytest.mark.parametrize("kind", CASES)
def test_combine_of_plain_rows_matches_plain_path(kind):
    """The kernel path's PyTorch side (ban mask, per-row top-K + lse
    contract, _combine) on the kernel's plain version equals the plain
    materialize-then-beam_topk path."""
    t, w, b, scores, fin, ban = _topk_case(kind, seed=7)
    V = w.shape[1]
    mask = None if ban is None else rt.ban_mask(T(ban), V)
    rows = rt.readout_topk_rows(T(t), T(w), T(b), 3, mask)
    got = rt._combine(*rows, T(scores), T(fin), V, 0)
    want = rt.fused_readout_topk(T(t), T(w), T(b), T(scores), T(fin),
                                 None if ban is None else T(ban), impl="plain")
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-6,
                               atol=1e-6)


def test_readout_topk_rows_plain_definition():
    """Per-row top-k of t @ w + b with ties to the smaller id, banned ids
    floored, and the row's log-sum-exp over the same floored logits."""
    t = np.ones((2, 1), np.float32)
    b = np.array([[1, 3, 3, 0, 3, 2]], np.float32)
    w = b.copy()
    mask = np.zeros((2, 6), np.uint8)
    mask[1, 1] = 1
    vals, idx, lse = rt.readout_topk_rows(T(t), T(w), T(np.zeros(6, np.float32)),
                                          3, T(mask))
    np.testing.assert_array_equal(idx.numpy(), [[1, 2, 4], [2, 4, 5]])
    np.testing.assert_array_equal(vals.numpy(), [[3, 3, 3], [3, 3, 2]])
    logits = np.where(mask > 0, -3e38, np.repeat(b, 2, 0)).astype(np.float64)
    want = np.log(np.exp(logits - 3).sum(-1)) + 3
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6)
    assert idx.dtype == torch.int32


def test_ban_mask_drops_sentinel_and_duplicates():
    ban = T(np.array([[0, 5, 5], [5, 5, 5]], np.int64))
    m = rt.ban_mask(ban, 5)
    np.testing.assert_array_equal(m.numpy(), [[1, 0, 0, 0, 0], [0] * 5])


def test_kernel_impl_on_cpu_raises():
    t, w, b, scores, fin, _ = _topk_case("random")
    with pytest.raises(ValueError, match="CUDA"):
        rt.readout_topk_rows(T(t), T(w), T(b), 3, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        rt.fused_readout_topk(T(t), T(w), T(b), T(scores), T(fin),
                              impl="kernel")
    p, x, mask, h0 = _gru_case()
    xg_t = torch.zeros((7, 5, 48))
    mask_t = T(mask.T.copy())
    hs_t = torch.zeros((7, 5, 16))
    with pytest.raises(ValueError, match="CUDA"):
        gru_bwd(xg_t, mask_t, T(p["uh"]), T(p["bh"]), T(h0), hs_t, hs_t,
                impl="kernel")
    B, Tt, T_, H, A, C, R = 2, 3, 4, 8, 6, 10, 5
    weights = tuple(torch.zeros(s) for s in (
        (H, 3 * H), (3 * H,), (H, A), (A,), (C, 3 * H), (3 * H,), (H, 3 * H),
        (3 * H,), (H, R), (C, R)))
    args = (torch.zeros((Tt, B, R)), torch.zeros((Tt, B, 3 * H)),
            torch.zeros((B, H)), torch.zeros((B, T_, C)),
            torch.zeros((B, T_, A)), torch.ones((B, T_)))
    with pytest.raises(ValueError, match="CUDA"):
        dec_scan_fwd(*args, weights, impl="kernel")
    res = dec_scan_fwd(*args, weights, impl="plain")
    with pytest.raises(ValueError, match="CUDA"):
        dec_scan_bwd(res, args[1], args[3], args[4], args[5], weights,
                     torch.ones((Tt, B, R)), impl="kernel")


@pytest.mark.parametrize("R,V", [(640, 8000), (12, 300), (3, 64), (640, 16000)])
def test_split_plan_covers_vocab(R, V):
    n_split, cols = rt._split_plan(R, V)
    assert cols % rt._COL_TILE == 0
    assert n_split * cols >= V > (n_split - 1) * cols
    if (R, V) == (640, 8000):
        assert (-(-R // rt._ROW_TILE)) * n_split >= 132   # fills the SMs
