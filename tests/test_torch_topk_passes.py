"""Beams above 16: the passes of kernels 1, 6, 8 and 9, modelled on the CPU.

The candidates of every top-K kernel are ordered strictly and totally by
(value desc, id asc), so a top-K above 16 is ceil(K / 16) top-16s, pass p
taking only the candidates strictly after the entry 16 p - 1 that pass
p - 1 wrote (``ops/topk.py::k_plan``, ``csrc/topk_split.cuh``). The
models below follow the kernels step for step: per-slice (or per-lane)
lists of 16 under the after key, the finished rows' shortcut over columns
0..K-1 and pad_id with the full K, gen 1's floored columns past V counted
from the key, gen 2's per-row passes and its combine in rounds of 16, and
kernel 1's shallow slots (the lanes unfiltered, the key in the lane merge,
the flag of the last pass). Each model equals the plain version bit for
bit at K = 17, 20, 32, 40 and K = V, on integer-valued logits (many
ties); the plain versions are held against the JAX package's XLA top-K
there too. The kernels themselves are held against the plain versions on
the card by chip_smoke.py (phase 2b)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.ops import pallas_topk as jtopk

from vag_nmt_tpu_torch.ops import readout_topk as rt
from vag_nmt_tpu_torch.ops import topk

torch.set_num_threads(1)

P = topk.MAX_K                    # a pass's width
FLOOR = topk._FLOOR
KS = (17, 20, 32, 40)


def _after(vals, ids, key):
    """The (vals, ids) strictly after ``key`` = (value, id) (all if None)."""
    if key is None:
        return vals, ids
    av, ai = key
    keep = (vals < av) | ((vals == av) & (ids > ai))
    return vals[keep], ids[keep]


def _best(vals, ids, n=P):
    """The n best (value desc, id asc), fewer when there are fewer."""
    order = torch.argsort(ids)
    vals, ids = vals[order], ids[order]
    o2 = torch.sort(vals, descending=True, stable=True).indices[:n]
    return vals[o2], ids[o2]


def _cat(lists):
    return (torch.cat([v for v, _ in lists]), torch.cat([i for _, i in lists]))


def _row_lists(base, logits_row, fin, K, V, S, pad_id, idfn, key):
    """Stage 1 of one row: its slices' lists of 16 under ``key``; a
    finished row lists columns 0..min(K, V)-1 and pad_id (the full K)."""
    if fin:
        cols = torch.arange(min(K, V))
        if K <= pad_id < V:
            cols = torch.cat([cols, torch.tensor([pad_id])])
        vals = torch.where(cols == pad_id, base, base + topk.NEG_INF)
        return [_best(*_after(vals, idfn(cols), key))]
    out = []
    for c0, c1 in topk.split_bounds(V, S):
        cols = torch.arange(c0, c1)
        out.append(_best(*_after(base + logits_row[c0:c1], idfn(cols), key)))
    return out


def _case(B, K, V, seed, fin_rate=0.3, pad_id=0):
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randint(-3, 4, (B, K, V)).astype(np.float32))
    scores = torch.from_numpy(rng.randint(-4, 1, (B, K)).astype(np.float32))
    fin = torch.from_numpy(rng.rand(B, K) < fin_rate)
    return logits, scores, fin


def model_beam_topk(logits, scores, fin, pad_id=0):
    """Kernel 6 in passes (beam_topk_pass_kernel)."""
    B, K, V = logits.shape
    base = topk._base(logits, scores, fin)
    S = topk.split_plan(B, K, V)
    vals = torch.empty(B, K)
    idx = torch.empty(B, K, dtype=torch.long)
    for b in range(B):
        for kofs in range(0, K, P):
            key = (vals[b, kofs - 1], idx[b, kofs - 1]) if kofs else None
            parts = []
            for k in range(K):
                parts += _row_lists(base[b, k], logits[b, k], bool(fin[b, k]),
                                    K, V, S, pad_id,
                                    lambda c, k=k: k * V + c, key)
            v, i = _best(*_cat(parts))
            n = min(P, K - kofs)
            vals[b, kofs:kofs + n], idx[b, kofs:kofs + n] = v[:n], i[:n]
    return vals, idx


def model_blocks(logits, scores, fin, pad_id=0):
    """Kernel 8 (gen 1) in passes: BlockRank ids, the floored columns past
    V counted from the key (offer_floored), ranks back to flat ids."""
    B, K, V = logits.shape
    BLK = topk.LEGACY_BLOCK
    base = topk._base(logits, scores, fin)
    S = topk.split_plan(B, K, V)
    npad = -(-V // BLK) * BLK - V

    def rank(k, v):
        return (v // BLK) * (K * BLK) + k * BLK + v % BLK

    vals = torch.empty(B, K)
    idx = torch.empty(B, K, dtype=torch.long)
    for b in range(B):
        for kofs in range(0, K, P):
            key = None
            if kofs:
                f = int(idx[b, kofs - 1])
                key = (vals[b, kofs - 1], torch.tensor(rank(f // V, f % V)))
            parts = []
            for k in range(K):
                parts += _row_lists(base[b, k], logits[b, k], bool(fin[b, k]),
                                    K, V, S, pad_id,
                                    lambda c, k=k: rank(k, c), key)
            if npad:
                n_fl = K * npad
                start = 0
                if key is not None and key[0] < FLOOR:
                    start = n_fl
                if key is not None and key[0] == FLOOR:
                    b0 = (V // BLK) * (K * BLK)
                    ai = int(key[1])
                    if ai >= b0:
                        rem = ai - b0
                        c = rem % BLK - V % BLK
                        start = rem // BLK * npad + min(npad, max(0, c + 1))
                e = torch.arange(start, min(n_fl, start + P))
                fl_ids = torch.tensor([rank(int(x) // npad, V + int(x) % npad)
                                       for x in e], dtype=torch.long)
                parts.append((torch.full((len(e),), FLOOR), fl_ids))
            v, r = _best(*_cat(parts))
            n = min(P, K - kofs)
            rem = r % (K * BLK)
            flat = (rem // BLK) * V + r // (K * BLK) * BLK + rem % BLK
            vals[b, kofs:kofs + n], idx[b, kofs:kofs + n] = v[:n], flat[:n]
    return vals, idx


def model_rows(logits, scores, fin, pad_id=0):
    """Kernel 9 (gen 2) in passes: each row's passes after its own key
    (with the floored columns past V from the key on), then the beam-major
    K*K -> K combine in rounds of 16 after the round before."""
    B, K, V = logits.shape
    BLK = topk.LEGACY_BLOCK
    Vp = -(-V // BLK) * BLK
    base = topk._base(logits, scores, fin)
    S = topk.split_plan(B, K, V)
    rvals = torch.empty(B * K, K)
    ridx = torch.empty(B * K, K, dtype=torch.long)
    for b in range(B):
        for kofs in range(0, K, P):
            for k in range(K):
                r = b * K + k
                key = (rvals[r, kofs - 1], ridx[r, kofs - 1]) if kofs else None
                parts = _row_lists(base[b, k], logits[b, k], bool(fin[b, k]),
                                   K, V, S, pad_id, lambda c: c, key)
                start = (V if key is None or key[0] > FLOOR else
                         max(V, int(key[1]) + 1) if key[0] == FLOOR else Vp)
                fl = torch.arange(start, min(Vp, start + P))
                parts.append((torch.full((len(fl),), FLOOR), fl))
                v, i = _best(*_cat(parts))
                n = min(P, K - kofs)
                rvals[r, kofs:kofs + n], ridx[r, kofs:kofs + n] = v[:n], i[:n]
    vals = torch.empty(B, K)
    idx = torch.empty(B, K, dtype=torch.long)
    pos = torch.arange(K * K)
    for b in range(B):
        cv = rvals[b * K:(b + 1) * K].reshape(-1)
        ci = ridx[b * K:(b + 1) * K].reshape(-1)
        key = None
        for q in range(0, K, P):
            v, p = _best(*_after(cv, pos, key))
            n = min(P, K - q)
            vals[b, q:q + n] = v[:n]
            idx[b, q:q + n] = (p[:n] // K) * V + ci[p[:n]]
            key = (v[-1], p[-1])
    return rvals, ridx, vals, idx


def model_readout_rows(logits, k, sk, lanes):
    """Kernel 1's per-row top-k in passes on materialized (R, V) logits:
    at depth the key filters every candidate; with shallow slots (sk < k)
    each lane keeps its unfiltered top-sk, the key filters the union, and
    the last pass flags a row when a lane's watermark reaches the union's
    k-th entry."""
    R, V = logits.shape
    vals = torch.empty(R, k)
    idx = torch.empty(R, k, dtype=torch.long)
    viol = torch.zeros(R, dtype=torch.int32)
    ids = torch.arange(V)
    n_lanes = int(lanes.max()) + 1
    for r in range(R):
        if sk < k:
            kept, marks = [], []
            for ln in range(n_lanes):
                sel = lanes == ln
                v, i = _best(logits[r][sel], ids[sel], sk + 1)
                kept.append((v[:sk], i[:sk]))
                marks.append(v[sk] if len(v) > sk else torch.tensor(FLOOR))
            pool = _cat(kept)
        else:
            pool = (logits[r], ids)
        for kofs in range(0, k, P):
            key = (vals[r, kofs - 1], idx[r, kofs - 1]) if kofs else None
            v, i = _best(*_after(*pool, key))
            if len(v) < P:       # empty slots (FLOOR, INT_MAX)
                v = torch.cat([v, torch.full((P - len(v),), FLOOR)])
                i = torch.cat([i, torch.full((P - len(i),), 2 ** 31 - 1)])
            n = min(P, k - kofs)
            vals[r, kofs:kofs + n], idx[r, kofs:kofs + n] = v[:n], i[:n]
            if sk < k and kofs + P >= k:
                viol[r] = int(max(marks) >= v[n - 1])
    return vals, idx, viol


@pytest.mark.parametrize("K", KS + ("V",))
def test_beam_topk_passes_model(K):
    V = 24 if K == "V" else 150
    K = V if K == "V" else K
    case = _case(3, K, V, K)
    got = model_beam_topk(*case)
    want = topk.beam_topk_plain(*case)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("K", KS + ("V",))
def test_legacy_blocks_passes_model(K):
    V = 40 if K == "V" else 530        # the last 512-block partial
    K = V if K == "V" else K
    case = _case(2, K, V, 100 + K)
    got = model_blocks(*case)
    want = topk.legacy_topk_blocks_plain(*case)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _floored_start(K, V, key):
    """offer_floored's count of gen 1's floored columns at or before key."""
    BLK = topk.LEGACY_BLOCK
    npad = -(-V // BLK) * BLK - V
    if key[0] > FLOOR:
        return 0
    if key[0] < FLOOR:
        return K * npad
    b0 = (V // BLK) * (K * BLK)
    if key[1] < b0:
        return 0
    rem = key[1] - b0
    c = rem % BLK - V % BLK
    return rem // BLK * npad + min(npad, max(0, c + 1))


@pytest.mark.parametrize("K,V", [(20, 515), (17, 1000), (33, 600)])
def test_legacy_blocks_floored_columns_in_passes(K, V):
    """Gen 1's floored columns past V (value FLOOR, ranked k-major) a pass
    offers after a key: offer_floored counts those at or before the key in
    closed form; held against sorting all of them, for keys above, at and
    below FLOOR, on floored and on real ranks of the last block."""
    BLK = topk.LEGACY_BLOCK
    npad = -(-V // BLK) * BLK - V

    def rank(k, v):
        return (v // BLK) * (K * BLK) + k * BLK + v % BLK

    fl = sorted(rank(k, v) for k in range(K) for v in range(V, V + npad))
    keys = [(0.0, 5), (FLOOR - 1e37, 0)]
    keys += [(FLOOR, r) for r in fl[::7] + fl[-1:]]
    keys += [(FLOOR, rank(k, V - 1)) for k in range(K)]      # real, last block
    keys += [(FLOOR, rank(0, 0))]
    for key in keys:
        want = sum(1 for r in fl if not (FLOOR < key[0] or
                                         (FLOOR == key[0] and r > key[1])))
        assert _floored_start(K, V, key) == want, key


@pytest.mark.parametrize("K", KS + ("V",))
def test_legacy_rows_passes_model(K):
    V = 30 if K == "V" else 200
    K = V if K == "V" else K
    case = _case(2, K, V, 200 + K)
    rvals, ridx, vals, idx = model_rows(*case)
    want = topk.legacy_topk_rows_plain(*case)
    assert torch.equal(vals, want[0]) and torch.equal(idx, want[1])
    cand = topk.candidates(*case).reshape(2 * K, V)
    rv, ri = topk.stable_topk(cand, K)
    assert torch.equal(rvals, rv) and torch.equal(ridx, ri)


@pytest.mark.parametrize("K", KS + ("V",))
@pytest.mark.parametrize("slots", [0, 2, 16])
def test_readout_passes_model(K, slots):
    """Kernel 1's passes at depth and with shallow slots, against
    readout_topk_rows_plain (its vals, ids and viol) under the kernel's
    lane map."""
    V = 64 if K == "V" else 300
    K = V if K == "V" else K
    rng = np.random.RandomState(K + slots)
    R, E = 6, 8
    t = torch.from_numpy(rng.randint(-2, 3, (R, E)).astype(np.float32))
    w = torch.from_numpy(rng.randint(-2, 3, (E, V)).astype(np.float32))
    b = torch.zeros(V)
    logits = t @ w + b
    sk = min(slots, K) if slots else K
    lanes = rt.kernel_lanes(R, V)
    vals, idx, viol = model_readout_rows(logits, K, sk, lanes)
    want = rt.readout_topk_rows_plain(t, w, b, K, slots=slots)
    if sk < K:
        ok = viol == 0           # a flagged row may differ (recovered)
        assert torch.equal(viol, want[3])
        assert torch.equal(vals[ok], want[0][ok])
        assert torch.equal(idx[ok].int(), want[1][ok])
    else:
        assert torch.equal(vals, want[0]) and torch.equal(idx.int(), want[1])


@pytest.mark.parametrize("K", KS)
def test_pass_plan_plain_versions_match_jax(K):
    """The plain versions the passes are held to on the card, against the
    JAX package's XLA top-K: ids exactly, values to 1e-5."""
    B, V = 2, 300
    rng = np.random.RandomState(K)
    logits = torch.from_numpy((3 * rng.randn(B, K, V)).astype(np.float32))
    scores = torch.from_numpy(rng.randn(B, K).astype(np.float32))
    fin = torch.from_numpy(rng.rand(B, K) < 0.3)
    want = jtopk.beam_topk(jnp.asarray(logits.numpy()),
                           jnp.asarray(scores.numpy()),
                           jnp.asarray(fin.numpy()), impl="xla")
    got = topk.beam_topk_plain(logits, scores, fin)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5,
                               rtol=0)
    got = model_beam_topk(logits, scores, fin)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("K,passes", [(1, 1), (8, 1), (16, 1), (17, 2),
                                      (32, 2), (33, 3), (40, 3)])
def test_k_plan(K, passes):
    assert topk.k_plan(K) == (8 if K <= 8 else 16, passes)


@pytest.mark.parametrize("K", [17, 20])
def test_wrappers_on_cpu_tensors_above_16(K):
    """Above 16 beams on CPU tensors: impl="auto" takes the plain version
    (the kernels have no CPU mode), impl="kernel" raises."""
    case = _case(2, K, 300, K)
    for name in ("beam_topk", "legacy_topk_blocks", "legacy_topk_rows"):
        fn, plain = getattr(topk, name), getattr(topk, f"{name}_plain")
        got = fn(*case)
        assert all(torch.equal(a, b) for a, b in zip(got, plain(*case)))
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*case, impl="kernel")
    rng = np.random.RandomState(K)
    t = torch.from_numpy(rng.randn(2 * K, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 300).astype(np.float32))
    b = torch.zeros(300)
    got = rt.readout_topk_rows(t, w, b, K)
    assert all(torch.equal(a, c) for a, c in
               zip(got, rt.readout_topk_rows_plain(t, w, b, K)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rt.readout_topk_rows(t, w, b, K, impl="kernel")
