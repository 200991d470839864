"""Kernel 1b's design (``csrc/readout_topk_bf16.cu``) modelled in plain torch
on the CPU: its tiling (``ops/readout_topk.py``'s split plan and tiles, t's
row tile resident in 64-deep boxes, W's column tiles as two 64-column boxes
a 64-deep stage, the shared memory of ``bf16_smem``), its product (bf16
values, each 16-deep step's products exact, summed into one fp32
accumulator per output in ascending depth), its fold over the lane map
``kernel_lanes`` and its merges (a half-warp a row: the lane merge and the
last block's split merge as tournaments of 16 heads, the sums in lane and
split order). The model is held against ``readout_topk_rows_plain`` at depth
K and with shallow slots; the CUDA kernel is held against the same plain
version on the card by chip_smoke.py (phase 17).

Tolerances: ids and top-K values bit for bit where the model and the plain
version see the same fp32 logits (the merges move values, they do not add
them); lse to 1e-6 relative (the merges sum the lanes' and splits'
exponentials in another order than torch.logsumexp); the product model's
top-K values and lse within chip_smoke's READOUT_RTOL of the plain fp32
GEMM, ids equal."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tests.test_torch_readout_plan import _cta_grid, product_bf16_k16
from vag_nmt_tpu_torch.ops import _build
from vag_nmt_tpu_torch.ops import readout_topk as rt
from vag_nmt_tpu_torch.ops.topk import stable_topk

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

BF = torch.bfloat16
FLOOR = -3.0e38
EMPTY = 2 ** 31 - 1
BOX = rt._BF16_BOX
TX = rt._LANE_PERIOD // rt._LANE_COLS       # lanes a row a split: a half-warp
# (R, E, V): phase 17's shapes (m30k and ikea_vag at beam 5 x 128
# sentences, its ragged shapes with rows of W and t off 16 bytes), the
# wide-beam rows of K = 1, 16 and 20 (phase 17's K = 12, 16, 20 and the
# one-beam decode), a tensor-parallel vocab slice of 4000, a short vocab
SHAPES = [(640, 256, 8000), (640, 256, 16000), (35, 256, 8003), (35, 250, 8003),
          (128, 256, 8000), (2048, 256, 8000), (2560, 256, 8000),
          (640, 256, 4000), (40, 100, 700)]


@pytest.mark.parametrize("R,E,V", SHAPES)
def test_tiling_covers_every_output_once_and_fits(R, E, V):
    """Every (row, column) of t @ W in exactly one block's column tiles, each
    tile two 64-column W boxes; t's row tile in ceil(E / 64) boxes of 64
    depths, resident in shared memory at the decode's E = 256; the block's
    shared memory within 227 KB; the lane map that of the fp32 kernel."""
    seen = np.zeros((R, V), np.int32)
    for (r0, r1), _, (c_begin, c_end), tiles in _cta_grid(R, V):
        assert r1 - r0 <= rt._ROW_TILE
        for c0, c1 in tiles:
            boxes = [(c0 + j * BOX, c0 + (j + 1) * BOX)
                     for j in range(rt._COL_TILE // BOX)]
            assert boxes[0][0] == c0 and boxes[-1][1] >= c1
            seen[r0:r1, c0:c1] += 1
    np.testing.assert_array_equal(seen, 1)
    kc = -(-E // BOX)
    assert kc * BOX >= E > (kc - 1) * BOX
    resident, smem = rt.bf16_smem(E)
    assert smem <= rt._SMEM_LIMIT
    assert resident == (E <= 704)
    assert TX == 16
    lanes = rt.kernel_lanes(R, V)
    n_split, split_cols = rt._split_plan(R, V)
    col = torch.arange(V)
    assert torch.equal(lanes, (col // split_cols) * TX + (col % 64) // 4)


def test_deep_t_streams_with_w_and_still_fits():
    """Past E = 704 t's row tile does not stay resident: its 64-deep box
    travels with each stage of W, and the block still fits."""
    for E in (768, 1024, 4096):
        resident, smem = rt.bf16_smem(E)
        assert not resident and smem <= rt._SMEM_LIMIT


def test_residency_is_decided_here_and_passed_to_the_build():
    """t's row tile stays resident up to _BF16_RESIDENT_BOXES boxes (11, E
    up to 704), the deepest that fits the block; the bf16 builds take that
    count as VAG_RESIDENT_KC, and the kernel decides by it alone, its
    static_asserts failing the build if the count disagrees with its
    layout."""
    kc = rt._BF16_RESIDENT_BOXES
    assert kc == 11
    assert rt._bf16_block_bytes(kc, True) <= rt._SMEM_LIMIT
    assert rt._bf16_block_bytes(kc + 1, True) > rt._SMEM_LIMIT
    assert rt.bf16_smem(kc * BOX)[0] and not rt.bf16_smem(kc * BOX + 1)[0]
    for base in ("readout_topk_bf16", "readout_topk_k16_bf16"):
        assert _build._KERNELS[base][1]["VAG_RESIDENT_KC"] == kc
    src = (_build.CSRC / "readout_topk_bf16.cu").read_text()
    assert "p.resident = (E + BOX_K - 1) / BOX_K <= RESIDENT_KC;" in src
    assert "static_assert(layout(RESIDENT_KC, true).total + 1024 <= SMEM_LIMIT" in src


def test_bf16_builds_are_their_own_source():
    """The bf16 instances build csrc/readout_topk_bf16.cu with the fp32
    builds' grid, tiles and lane map (VAG_BM, VAG_BN, VAG_LANE_PERIOD,
    VAG_CPT) and their own ring depth; the fp32 builds keep theirs."""
    for base in ("readout_topk", "readout_topk_k16"):
        fns, defs, src = _build._KERNELS[f"{base}_bf16"]
        fp32 = _build._KERNELS[base][1]
        assert src == "readout_topk_bf16" and _build._KERNELS[base][2] == "readout_topk"
        assert defs["VAG_BF16"] == 1 and defs["VAG_STAGES"] == rt._BF16_STAGES
        assert all(defs[k] == fp32[k] for k in ("VAG_BM", "VAG_BN", "VAG_LANE_PERIOD",
                                                "VAG_CPT", "VAG_MAX_K"))
        assert "VAG_BF16" not in fp32
        assert list(fns) == ["readout_topk_launch"]
    src = (_build.CSRC / "readout_topk.cu").read_text()
    assert "VAG_RO_BF16" not in src and "VAG_BF16" not in src


def _inputs(R, E, V, seed, kind="random"):
    rng = np.random.RandomState(seed)
    if kind == "integer":
        t, w = rng.randint(-3, 4, (R, E)), rng.randint(-3, 4, (E, V))
        b = rng.randint(-3, 4, V)
    else:
        t, w, b = np.tanh(rng.randn(R, E)), 0.05 * rng.randn(E, V), 0.1 * rng.randn(V)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return f(t).to(BF), f(w).to(BF), f(b)


def _model(logits, K, sk, lanes, n_split, key=None):
    """The kernel's fold and merges on (R, V) fp32 logits (bias added, bans
    floored), in fp32 arithmetic: per lane, its columns in order, four at a
    time, the online (max, sum-exp), the running top-sk by (value desc, id
    asc) and the watermark (the largest value pushed out of the last slot);
    the lane merge of each split's 16 lanes of a row (K rounds of the best
    head, sum-exp in lane order); the split merge in index order. key: (R,)
    (value, id) of a pass, whose candidates are those strictly after it (in
    the lane merge). Returns (vals, ids, lse, viol)."""
    R, V = logits.shape
    x32 = logits.numpy().astype(np.float32)
    lanes = lanes.numpy()
    f = np.float32
    vals = np.full((R, K), FLOOR, np.float32)
    ids = np.full((R, K), EMPTY, np.int64)
    lse = np.empty(R, np.float32)
    viol = np.zeros(R, np.int32)
    cols_of = [np.nonzero(lanes == q)[0] for q in range(n_split * TX)]
    empty = (-FLOOR, EMPTY)
    for r in range(R):
        x = x32[r]
        parts = []
        for sp in range(n_split):
            heads, ms, ss, ws = [], [], [], []
            for j in range(TX):
                cols = cols_of[sp * TX + j]
                m, s, wm, slot = f(FLOOR), f(0), f(FLOOR), []
                for g in range(0, len(cols), 4):
                    c4 = cols[g:g + 4]
                    m_new = max(m, x[c4].max())
                    s = f(s * np.exp(f(m - m_new)))
                    for c in c4:
                        s = f(s + np.exp(f(x[c] - m_new)))
                        slot.append((-float(x[c]), int(c)))
                        slot.sort()
                        if len(slot) > sk:
                            wm = max(wm, f(-slot.pop()[0]))
                    m = m_new
                if key is not None:
                    kv, ki = key[r]
                    slot = [e for e in slot if (e[0], e[1]) > (-kv, ki)]
                heads.append(slot)
                ms.append(m)
                ss.append(s)
                ws.append(wm)
            M = max(ms)
            S = f(0)
            for j in range(TX):            # lane order
                S = f(S + f(ss[j] * np.exp(f(ms[j] - M))))
            top = []
            for _ in range(K):             # K rounds of the best head
                j = min(range(TX), key=lambda i: heads[i][0] if heads[i] else empty)
                top.append(heads[j].pop(0) if heads[j] else empty)
            parts.append((top, M, S, max(ws)))
        M = max(p[1] for p in parts)
        S = f(0)
        for p in parts:                    # split index order
            S = f(S + f(p[2] * np.exp(f(p[1] - M))))
        merged = sorted(e for p in parts for e in p[0])[:K]
        vals[r] = [-e[0] for e in merged]
        ids[r] = [e[1] for e in merged]
        lse[r] = M + np.log(S)
        viol[r] = int(max(p[3] for p in parts) >= vals[r, K - 1])
    return (torch.from_numpy(vals), torch.from_numpy(ids), torch.from_numpy(lse),
            torch.from_numpy(viol))


@pytest.mark.parametrize("slots", [0, 1, 5])
def test_fold_and_merges_match_the_plain_version(slots):
    """On one set of logits (R = 70: a part-full second row tile; V = 4000:
    several splits, a ragged last tile), the model's ids and values equal
    readout_topk_rows_plain's bit for bit at depth K (slots 0 and K) and
    with one slot (its shallow union and viol under kernel_lanes), lse to
    1e-6; some rows, not all, flagged at one slot (two strong ids share a
    lane), so the watermark is exercised."""
    R, E, V, K = 66, 64, 1500, 5
    t, w, b = _inputs(R, E, V, seed=7)
    b[[0, 64]] += 0.9                      # lane 0 of split 0: two strong ids
    logits = t.float() @ w.float() + b
    n_split, _ = rt._split_plan(R, V)
    assert n_split > 1
    lanes = rt.kernel_lanes(R, V)
    sk = slots or K
    mv, mi, ml, mviol = _model(logits, K, sk, lanes, n_split)
    out = rt.readout_topk_rows_plain(t, w, b, K, slots=slots)
    assert torch.equal(mi.to(torch.int32), out[1])
    assert torch.equal(mv, out[0])
    np.testing.assert_allclose(ml.numpy(), out[2].numpy(), rtol=1e-6)
    if slots:
        assert torch.equal(mviol, out[3])
    if slots == 1:
        assert 0 < int(mviol.sum()) < R


def test_pass_keys_keep_candidates_after_the_key():
    """A pass of K > 16 (here 5 a pass) keeps only candidates strictly
    after the row's last entry of the pass before: the model's second pass
    with the key of its first gives entries 5..9 of the depth-10 top-K."""
    R, E, V = 40, 32, 700
    t, w, b = _inputs(R, E, V, seed=9)
    logits = t.float() @ w.float() + b
    n_split, _ = rt._split_plan(R, V)
    lanes = rt.kernel_lanes(R, V)
    v1, i1, _, _ = _model(logits, 5, 5, lanes, n_split)
    key = [(float(v1[r, 4]), int(i1[r, 4])) for r in range(R)]
    v2, i2, _, _ = _model(logits, 5, 5, lanes, n_split, key=key)
    pv, pi, _ = rt.readout_topk_rows_plain(t, w, b, 10)
    assert torch.equal(torch.cat([i1, i2], 1).to(torch.int32), pi)
    assert torch.equal(torch.cat([v1, v2], 1), pv)


@pytest.mark.parametrize("V", [8000, 16000])
def test_product_within_readout_rtol_of_the_plain_gemm(V):
    """Phase 17's random case: the product model (16-deep exact steps into
    fp32 accumulators in ascending depth) gives the plain version's ids and
    its top-K values and lse within READOUT_RTOL (the plain version sums
    the same exact products in fp32 in another order)."""
    R, E, K = 640, 256, 5
    t, w, b = cs._readout_bf16_inputs(torch, np, torch.device("cpu"), "random",
                                      R, E, V, V + 3)
    model = product_bf16_k16(t, w) + b
    mv, mi = stable_topk(model, K)
    pv, pi, pl = rt.readout_topk_rows_plain(t, w, b, K)
    assert torch.equal(mi.to(torch.int32), pi)
    torch.testing.assert_close(mv, pv, rtol=cs.READOUT_RTOL, atol=0.0)
    torch.testing.assert_close(torch.logsumexp(model, -1), pl,
                               rtol=cs.READOUT_RTOL, atol=0.0)


def test_integer_inputs_give_exact_logits():
    """Phase 17's integer inputs: every product and sum exact in fp32, so
    the product model equals the plain version's logits bit for bit in any
    order of the sums (the card's check of exact values)."""
    t, w, b = _inputs(64, 256, 1000, seed=1, kind="integer")
    exact = t.double() @ w.double() + b.double()
    assert torch.equal((product_bf16_k16(t, w) + b).double(), exact)
    assert torch.equal((t.float() @ w.float() + b).double(), exact)
