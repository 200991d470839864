"""The split design of the port's beam top-K kernels 6, 8 (gen 1) and 9
(gen 2), ``csrc/topk_split.cuh``, modelled in plain torch on the CPU:
stage 1 takes the K best of each (row, vocab slice) at the slice bounds
the kernels use (``split_plan``, ``split_bounds``) under each kernel's id
(flat index, gen 1's first-occurrence rank, vocab id), finished rows in
closed form; stage 2 merges a sentence's partials (kernel 6; gen 1 by
rank with the floored columns past V, the ranks turned back into flat
ids) or a row's partials with the floored columns past V, then the
beam-major K*K -> K combine (gen 2). The model must equal
``beam_topk_plain``, ``legacy_topk_blocks_plain`` and
``legacy_topk_rows_plain`` bit for bit, ids and values, and through them
the JAX functions and gen 1's JAX kernel (ids exactly, values to 1e-5: the
frameworks sum the log-sum-exp in another order). The CUDA kernels are
held against the same plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vag_nmt_tpu.ops.pallas_topk import beam_topk as j_beam_topk

from vag_nmt_tpu_torch.ops.topk import (
    LEGACY_BLOCK,
    NEG_INF,
    SPLIT_MIN_COLS,
    SPLIT_TARGET_CTAS,
    _base,
    beam_topk_plain,
    candidates,
    legacy_topk_blocks_plain,
    legacy_topk_rows_plain,
    split_bounds,
    split_plan,
    stable_topk,
)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ATOL = 1e-5
FLOOR = -3.0e38                 # an empty slot's value (topk_split.cuh)
EMPTY = 2 ** 31 - 1             # an empty slot's id (INT_MAX)
# (B, K, V) of the plan cases: m30k serving (d), ikea (g)/(h), one ragged
# sentence, K=8 over a short vocab
PLAN_SHAPES = [(128, 5, 8000), (128, 5, 16000), (1, 5, 8003), (3, 8, 1000)]


def T(x):
    return torch.from_numpy(np.array(x))


def _ordered(vals, ids, k):
    """The k best (value desc, id asc) along the last axis, padded with
    empty slots."""
    n = vals.shape[-1]
    if n < k:
        pad = vals.shape[:-1] + (k - n,)
        vals = torch.cat([vals, torch.full(pad, FLOOR)], -1)
        ids = torch.cat([ids, torch.full(pad, EMPTY, dtype=ids.dtype)], -1)
    o = torch.argsort(ids, dim=-1, stable=True)
    vals, ids = vals.gather(-1, o), ids.gather(-1, o)
    o = torch.argsort(vals, dim=-1, descending=True, stable=True)[..., :k]
    return vals.gather(-1, o), ids.gather(-1, o)


def block_rank(k, v, K):
    """Gen 1's id of beam k's column v (legacy_topk.cu's BlockRank): the
    TPU kernel's first-occurrence order (512-block, beam, v)."""
    return (v // LEGACY_BLOCK) * (K * LEGACY_BLOCK) + k * LEGACY_BLOCK + v % LEGACY_BLOCK


def stage1(logits, scores, finished, S, flat_ids, pad_id=0, ranked=False):
    """(R, S, K) partial values and ids of every (row, slice), R = B*K;
    ids are flat indices, vocab ids, or with ``ranked`` gen 1's ranks."""
    B, K, V = logits.shape
    R = B * K
    base = _base(logits, scores, finished).reshape(R, 1)
    cand = base + logits.reshape(R, V)
    ids = torch.arange(V, dtype=torch.int64).expand(R, V)
    if ranked:
        ids = block_rank((torch.arange(R) % K)[:, None], ids, K)
    elif flat_ids:
        ids = ids + (torch.arange(R) % K * V)[:, None]
    pv = torch.full((R, S, K), FLOOR)
    pi = torch.full((R, S, K), EMPTY, dtype=torch.int64)
    for s, (c0, c1) in enumerate(split_bounds(V, S)):
        pv[:, s], pi[:, s] = _ordered(cand[:, c0:c1], ids[:, c0:c1], K)
    # a finished row in closed form: its K best lie among ids 0..K-1 and
    # pad_id; slice 0 holds them, the other slices nothing
    cols = sorted(set(range(min(K, V))) | ({pad_id} if 0 <= pad_id < V else set()))
    c = torch.tensor(cols)
    fv = torch.where(c == pad_id, base, base + NEG_INF)
    cv, ci = _ordered(fv, ids[:, c], K)
    fr = finished.reshape(R)
    pv[fr], pi[fr] = FLOOR, EMPTY
    pv[fr, 0], pi[fr, 0] = cv[fr], ci[fr]
    return pv, pi


def stage2_sentences(pv, pi, B, K):
    """Kernel 6: each sentence's K*S*K partials -> (B, K)."""
    return _ordered(pv.reshape(B, -1), pi.reshape(B, -1), K)


def stage2_rows(pv, pi, B, K, V):
    """Gen 2: each row's S partials and the floored columns past the last
    512-block -> the per-row top-K (rvals, ridx); then the combine ordered by
    (value, position k*K + j) -> (vals, flat ids)."""
    R = B * K
    npad = min(K, -(-V // LEGACY_BLOCK) * LEGACY_BLOCK - V)
    padv = torch.full((R, npad), FLOOR)
    padi = (V + torch.arange(npad)).expand(R, npad)
    rv, ri = _ordered(torch.cat([pv.reshape(R, -1), padv], 1),
                      torch.cat([pi.reshape(R, -1), padi], 1), K)
    pos = torch.arange(K * K).expand(B, K * K)
    vals, p = _ordered(rv.reshape(B, K * K), pos, K)
    flat = (p // K) * V + ri.reshape(B, K * K).gather(1, p)
    return rv, ri, vals, flat


def _case(B, K, V, ff, seed, ties=False):
    rng = np.random.RandomState(seed)
    if ties:
        logits = np.repeat(rng.randint(-2, 3, (B, 1, V)), K, 1).astype(np.float32)
        scores = np.repeat(rng.randint(-3, 1, (B, 1)), K, 1).astype(np.float32)
    else:
        logits = (3.0 * rng.randn(B, K, V)).astype(np.float32)
        scores = rng.randn(B, K).astype(np.float32)
    return T(logits), T(scores), T(rng.rand(B, K) < ff)


def _check(args, S, pad_id=0):
    """Both kernels' models at S slices equal their plain versions exactly;
    gen 2's per-row output equals the per-row stable top-K. Returns the
    two (vals, ids)."""
    logits = args[0]
    B, K, V = logits.shape
    pv, pi = stage1(*args, S, flat_ids=True, pad_id=pad_id)
    got6 = stage2_sentences(pv, pi, B, K)
    want6 = beam_topk_plain(*args, pad_id=pad_id)
    assert torch.equal(got6[1], want6[1]) and torch.equal(got6[0], want6[0])
    pv, pi = stage1(*args, S, flat_ids=False, pad_id=pad_id)
    rv, ri, *got9 = stage2_rows(pv, pi, B, K, V)
    want9 = legacy_topk_rows_plain(*args, pad_id=pad_id)
    assert torch.equal(got9[1], want9[1]) and torch.equal(got9[0], want9[0])
    cand = candidates(*args, pad_id=pad_id).reshape(B * K, V)
    wv, wi = stable_topk(cand, K)
    assert torch.equal(ri, wi) and torch.equal(rv, wv)
    return got6, got9


@pytest.mark.parametrize("B,K,V", PLAN_SHAPES)
def test_split_plan_and_bounds(B, K, V):
    """The plan fills the card where the columns allow, no slice is shorter
    than SPLIT_MIN_COLS, and the bounds tile [0, V) in multiples of 4."""
    S = split_plan(B, K, V)
    assert S == {(128, 5, 8000): 1, (128, 5, 16000): 1, (1, 5, 8003): 15,
                 (3, 8, 1000): 1}[(B, K, V)]
    assert S == 1 or (S - 1) * B * K < SPLIT_TARGET_CTAS
    assert B * K * S >= SPLIT_TARGET_CTAS or S == max(1, V // SPLIT_MIN_COLS)
    bounds = split_bounds(V, S)
    assert bounds[0][0] == 0 and bounds[-1][1] == V
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all((c1 - c0) % 4 == 0 for c0, c1 in bounds[:-1])


@settings(max_examples=60, deadline=None, derandomize=True)
@given(V=st.integers(1, 5000), S=st.integers(1, 64))
def test_split_bounds_tile_the_row(V, S):
    bounds = split_bounds(V, S)
    assert len(bounds) == S
    assert bounds[0][0] == 0 and bounds[-1][1] == V
    assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(bounds, bounds[1:]))
    L = bounds[0][1] - bounds[0][0]
    assert L % 4 == 0 or L == V


@pytest.mark.parametrize("B,K,V", PLAN_SHAPES)
def test_split_model_matches_plain_and_jax_at_plan(B, K, V):
    """At the plan's S: random logits, a fifth of the beams finished."""
    args = _case(B, K, V, 0.2, seed=V + K)
    got6, got9 = _check(args, split_plan(B, K, V))
    want = j_beam_topk(*(jnp.asarray(a.numpy()) for a in args), impl="xla")
    for got in (got6, got9):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("B,K,V,ff", [
    (4, 5, 1000, 0.3),
    (2, 1, 1001, 0.0),         # K=1, V % 4 != 0
    (3, 8, 1003, 0.3),         # K=8, V % 4 != 0
    (2, 5, 1303, 0.25),        # a partial last 512-block
])
def test_split_model_matches_jax_kernels(B, K, V, ff):
    """Small shapes with several slices against the JAX lane kernel and
    gen 2 kernel in interpret mode."""
    args = _case(B, K, V, ff, seed=B * V, ties=True)
    got6, got9 = _check(args, 5)
    jargs = tuple(jnp.asarray(a.numpy()) for a in args)
    for got, impl in ((got6, "pallas_lanes"), (got9, "pallas_rows")):
        want = j_beam_topk(*jargs, impl=impl)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=ATOL)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(S=st.integers(1, 40), seed=st.integers(0, 2 ** 16),
       K=st.sampled_from([1, 2, 5, 8]), V=st.integers(8, 700),
       ties=st.booleans())
def test_split_model_any_slice_count(S, seed, K, V, ties):
    """Every S gives the plain versions' answer: the order is total."""
    _check(_case(3, K, V, 0.25, seed=seed, ties=ties), S)


def _boundary_ties(B, K, V, S):
    """Integer logits below 3, with 5.0 at the last column of slice 0 and
    the first of slice 1 in every beam, under equal scores: the best
    candidates tie on a slice boundary and across beams."""
    logits, scores, fin = _case(B, K, V, 0.0, seed=7, ties=True)
    edge = split_bounds(V, S)[1][0]
    logits[:, :, [edge - 1, edge]] = 5.0
    return (logits, scores, fin), edge


@pytest.mark.parametrize("B,K,V,S", [(1, 5, 8003, 15), (2, 8, 1003, 3),
                                     (4, 5, 1000, 2)])
def test_ties_on_slice_boundaries_and_across_beams(B, K, V, S):
    args, edge = _boundary_ties(B, K, V, S)
    got6, got9 = _check(args, S)
    want = [k * V + c for k in range(K) for c in (edge - 1, edge)][:K]
    for got in (got6, got9):
        assert (got[1] == torch.tensor(want)).all()
        assert (got[0] == got[0][:, :1]).all()


@pytest.mark.parametrize("pad_id", [0, 3, 9, 999])
@pytest.mark.parametrize("K", [1, 5, 8])
def test_finished_rows_in_closed_form(K, pad_id):
    """All beams finished: the closed form (ids 0..K-1 and pad_id, the
    plain version's adds) equals the plain versions bit for bit, and
    (base, pad_id) leads every sentence."""
    B, V = 3, 1000
    logits, scores, _ = _case(B, K, V, 0.0, seed=K + pad_id)
    args = (logits, scores, torch.ones((B, K), dtype=torch.bool))
    got6, got9 = _check(args, 4, pad_id=pad_id)
    for got in (got6, got9):
        assert (got[1][:, 0] % V == pad_id).all()


# --- gen 1 (kernel 8): the split keyed by rank --------------------------------

def stage2_blocks(pv, pi, B, K, V):
    """Gen 1: each sentence's K*S*K partials and the K floored columns past
    V that rank first (beam 0's first) -> the K best by (value, rank), the
    ranks turned back into flat ids k * V + v."""
    npad = -(-V // LEGACY_BLOCK) * LEGACY_BLOCK - V
    vals, ranks = pv.reshape(B, -1), pi.reshape(B, -1)
    if npad:
        lane = torch.arange(K)
        padi = block_rank(lane // npad, V + lane % npad, K).expand(B, K)
        vals = torch.cat([vals, torch.full((B, K), FLOOR)], 1)
        ranks = torch.cat([ranks, padi], 1)
    top, rk = _ordered(vals, ranks, K)
    rem = rk % (K * LEGACY_BLOCK)
    return top, (rem // LEGACY_BLOCK) * V + rk // (K * LEGACY_BLOCK) * LEGACY_BLOCK + rem % LEGACY_BLOCK


def _check_gen1(args, S, pad_id=0):
    """Gen 1's model at S slices equals legacy_topk_blocks_plain exactly."""
    B, K, V = args[0].shape
    pv, pi = stage1(*args, S, flat_ids=False, pad_id=pad_id, ranked=True)
    got = stage2_blocks(pv, pi, B, K, V)
    want = legacy_topk_blocks_plain(*args, pad_id=pad_id)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    return got


def test_block_rank_orders_as_block_beam_id_and_grows_with_v():
    """A strict total order over a sentence's (k, v), as (v // 512, k, v),
    and increasing in v within a row (the closed form of a finished row
    and the early reject rely on it)."""
    K, V = 5, 1303
    k, v = torch.meshgrid(torch.arange(K), torch.arange(V), indexing="ij")
    r = block_rank(k, v, K).flatten()
    assert len(set(r.tolist())) == K * V
    key = sorted(zip((v // LEGACY_BLOCK).flatten().tolist(), k.flatten().tolist(),
                     v.flatten().tolist()))
    order = torch.argsort(r)
    got = list(zip((v.flatten()[order] // LEGACY_BLOCK).tolist(),
                   k.flatten()[order].tolist(), v.flatten()[order].tolist()))
    assert got == key
    assert (block_rank(k, v, K).diff(dim=1) > 0).all()


@pytest.mark.parametrize("B,K,V", PLAN_SHAPES)
def test_gen1_split_model_matches_plain_at_plan(B, K, V):
    _check_gen1(_case(B, K, V, 0.2, seed=V + K + 1), split_plan(B, K, V))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(S=st.integers(1, 40), seed=st.integers(0, 2 ** 16),
       K=st.sampled_from([1, 2, 5, 8]), V=st.integers(8, 1700),
       ties=st.booleans())
def test_gen1_split_model_any_slice_count(S, seed, K, V, ties):
    """Every S gives gen 1's answer: the rank order is total."""
    _check_gen1(_case(3, K, V, 0.25, seed=seed, ties=ties), S)


@pytest.mark.parametrize("B,K,V,S", [(1, 5, 8003, 15), (2, 8, 1003, 3),
                                     (4, 5, 1303, 3), (2, 5, 1000, 2)])
def test_gen1_ties_across_slices_blocks_and_beams(B, K, V, S):
    """The maxima on both sides of a slice boundary and of the first
    512-block boundary, in every beam under equal scores: gen 1 lists the
    earlier block's columns of every beam first, then the later block's."""
    args, edge = _boundary_ties(B, K, V, S)
    args[0][:, :, [LEGACY_BLOCK - 1, LEGACY_BLOCK]] = 5.0
    got = _check_gen1(args, S)
    cols = sorted({edge - 1, edge, LEGACY_BLOCK - 1, LEGACY_BLOCK})
    want = sorted(((c // LEGACY_BLOCK, k, c) for k in range(K) for c in cols))[:K]
    assert got[1][0].tolist() == [k * V + c for _, k, c in want]


@pytest.mark.parametrize("pad_id", [0, 3, 9, 999])
@pytest.mark.parametrize("K", [1, 5, 8])
def test_gen1_finished_rows_in_closed_form(K, pad_id):
    """All beams finished, pad_id below K and at or past it: the closed form
    under ranks equals gen 1's plain version bit for bit."""
    B, V = 3, 1000
    logits, scores, _ = _case(B, K, V, 0.0, seed=K + pad_id + 1)
    got = _check_gen1((logits, scores, torch.ones((B, K), dtype=torch.bool)), 4,
                      pad_id=pad_id)
    assert (got[1][:, 0] % V == pad_id).all()


@pytest.mark.parametrize("B,K,V,ff,ties,S", [
    (8, 5, 1000, 0.0, True, 3),     # forced ties across blocks and beams
    (4, 5, 1303, 0.25, True, 5),    # ties, frozen rows, a partial last block
    (2, 1, 700, 0.0, False, 2),     # K=1
    (4, 3, 512, 1.0, False, 2),     # everything finished
])
def test_gen1_split_model_matches_the_jax_kernel(B, K, V, ff, ties, S):
    """Against gen 1's JAX kernel (beam_topk(impl="pallas"), interpret
    mode): ids exactly, values to ATOL (the log-sum-exp's order)."""
    args = _case(B, K, V, ff, seed=B * V + 1, ties=ties)
    if ties:
        args[0][:, :, [100, 600]] = 5.0
    got = _check_gen1(args, S)
    want = j_beam_topk(*(jnp.asarray(a.numpy()) for a in args), impl="pallas")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=ATOL)
