"""The bf16 decoder scan's backward replay as time-parallel grids
(``ops/dec_scan.py::dec_scan_replay_plain``, ``csrc/dec_scan_fwd.cu``'s
``dec_scan_replay_launch``) and the bf16 tiles of the bf16 instances
(``csrc/bf16_tile.cuh``), on the CPU.

Step t of the replay reads only the saved state states[t], so the steps
are independent: the replay runs each product once over all Tt * B rows and
the attention over every (t, b) row at once. Held here: the batched plain
version against a step loop (``_step_loop_replay``: the forward's plain
loop, each step from its saved state) to fp32 round-off; the bf16 decoder scan's grads through that route against the
JAX package's Pallas backward kernel in interpret mode (``_bwd_call``
called directly: R1 is its custom VJP) and against ``jax.grad`` of the XLA
scan; and a torch model of the kernels' partition (the tiles of 64 x 64
outputs, 64-deep chunks zero-filled past the edges, the gate tiles of 16
units with GRU1 in the epilogue, the attention's groups of RG steps a
sentence; the forward recurrence's eight-wide context sums, in quarters
and rounds) against the plain version. Inputs come from numpy seeds at
small widths; tolerances are stated where used."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.models import decoder as jdec
from vag_nmt_tpu.ops import pallas_dec_scan as jpd

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.models import decoder as tdec
from vag_nmt_tpu_torch.ops import dec_scan as tds
from vag_nmt_tpu_torch.ops.gru_kernel import gru_gate_algebra, rbf
from vag_nmt_tpu_torch.train.state import tree_leaves, tree_unflatten

from tests.test_torch_bf16 import (BF, GRAD_SCALE_TOL, PALLAS_TOL,
                                   _dec_setup, _scale_close, _t,
                                   _time_major_case)
from tests.test_torch_params import _flat

torch.set_num_threads(1)

# fp32 round-off between two orders of the same fp32 sums, relative to
# each output's scale
ROUNDOFF = 2e-5
# (Tt, B, T): ragged batches, one target step, masked source positions
# (source lengths from 2 to T)
CASES = [(6, 8, 5), (1, 5, 4), (4, 3, 7)]
# the kernels' constants (csrc/bf16_tile.cuh, csrc/dec_scan_fwd.cu)
BM = BN = BK = 64
GATE_UNITS = 16
RG = 4
THREADS = 256


def _case(Tt, B, T, H=32, A=16, C=24, R=20, seed=3):
    """bf16-stream inputs as the port's kernels take them, the saved
    states (s0, then the forward's s' rounded to bf16) and a cotangent."""
    st, w, g = _time_major_case(Tt=Tt, B=B, T=T, H=H, A=A, C=C, R=R,
                                seed=seed)
    args = (_t(st["ty"]), _t(st["xg"], BF), _t(st["s0"]), _t(st["ctx"], BF),
            _t(st["ctxp"]), _t(st["mask"]))
    weights = [_t(x, BF if n in tds.MATRICES else torch.float32)
               for n, x in zip(tds.WEIGHTS, w)]
    with torch.no_grad():
        res = tds.dec_scan_fwd_plain(*args, weights)
    states = torch.cat([args[2][None], res["s"][1:].to(BF).float()])
    return args, weights, states, _t(g)


def _step_loop_replay(ty, xg, ctx, ctxp, mask, weights, states):
    """The oracle: the replay as the JAX kernel's backward runs it, one
    step a loop turn, each step from states[t] (not from the carry), then
    the readout on states[1:] (dec_scan_fwd_plain's loop otherwise)."""
    uh1, bh1, ua, va, wi2, bi2, uh2, bh2, ws, wc = weights
    out = {k: [] for k in ("st", "c", "w", "q", "hg1", "xg2", "hg2")}
    for t in range(xg.shape[0]):
        s = states[t]
        hg1 = tds._dot(s, uh1) + bh1
        st = gru_gate_algebra(xg[t].to(torch.float32), hg1, s)
        q = tds._dot(st, ua)
        hg2 = tds._dot(st, uh2) + bh2
        c, w = tds._attend(q, ctxp, ctx, mask, va)
        xg2 = tds._dot(c, wi2) + bi2
        for k, v in (("st", st), ("c", c), ("w", w), ("q", q), ("hg1", hg1),
                     ("xg2", xg2), ("hg2", hg2)):
            out[k].append(v)
    res = {k: torch.stack(v) for k, v in out.items()}
    res["s"] = states
    pre = tds._dot(res["c"], wc) + tds._dot(states[1:], ws)
    res["t"] = torch.tanh(ty + pre)
    return res


def _rel(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("Tt,B,T", CASES)
def test_replay_plain_matches_the_step_loop(Tt, B, T):
    """dec_scan_replay_plain (one product over all Tt * B rows, the
    attention over every row at once) against _step_loop_replay (one
    step a loop turn): every residual within ROUNDOFF, s the
    states themselves, the bf16 copies the residuals rounded once; and
    dec_scan_fwd(..., states=) on CPU tensors takes it."""
    args, weights, states, _ = _case(Tt, B, T)
    ty, xg, _, ctx, ctxp, mask = args
    got = tds.dec_scan_replay_plain(ty, xg, ctx, ctxp, mask, weights, states)
    loop = _step_loop_replay(ty, xg, ctx, ctxp, mask, weights, states)
    for k in tds.RESIDUALS:
        assert got[k].shape == loop[k].shape, k
        assert _rel(got[k], loop[k]) < ROUNDOFF, k
    assert got["s"] is states
    for k in tds.BF16_COPIES:
        assert got[k].dtype == BF and torch.equal(got[k], got[k[:-1]].to(BF))
    wrapped = tds.dec_scan_fwd(*args, weights, states=states)
    assert all(torch.equal(wrapped[k], got[k]) for k in tds.RESIDUALS)


def test_replay_kernel_route_raises_on_cpu_and_takes_no_timers(monkeypatch):
    """The replay's kernel route checks its arguments and raises on CPU
    tensors (no fallback); it takes bf16 streams only and no timers (it
    runs no recurrence to stamp)."""
    args, weights, states, _ = _case(2, 3, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tds.dec_scan_fwd(*args, weights, states=states, impl="kernel")
    monkeypatch.setattr(tds, "resolve_impl", lambda impl, x: "kernel")
    monkeypatch.setattr(tds, "check_kernel_arg", lambda *a, **k: None)
    with pytest.raises(ValueError, match="timers"):
        tds.dec_scan_fwd(*args, weights, states=states,
                         timers=torch.zeros(10, dtype=torch.int64))
    w32 = [w.float() for w in weights]
    a32 = (args[0], args[1].float(), args[2], args[3].float(), *args[4:])
    with pytest.raises(ValueError, match="bf16 streams only"):
        tds.dec_scan_fwd(*a32, w32, states=states)


@pytest.mark.parametrize("Tt,B,T", CASES)
def test_bf16_grads_through_the_replay_match_pallas_bwd(Tt, B, T, monkeypatch):
    """DecoderScan on bf16 streams (the forward saves the bf16 states
    alone; the backward replays through dec_scan_replay_plain, once a
    backward, then runs dec_scan_bwd_plain) against the JAX Pallas kernels
    in interpret mode: _fwd_call's bf16 states, then _bwd_call on them.
    Every cotangent within PALLAS_TOL of its scale (the same rounding
    points; the sums in other orders)."""
    st, w, g = _time_major_case(Tt=Tt, B=B, T=T)
    names = ("ty", "xg", "s0", "ctx", "ctxp", "mask")
    jbf = {"xg", "ctx"}
    jargs = [jnp.asarray(st[n]).astype(jnp.bfloat16) if n in jbf
             else jnp.asarray(st[n]) for n in names]
    for name, x in zip(tds.WEIGHTS, w):
        jargs.append(jnp.asarray(x).astype(jnp.bfloat16)
                     if name in tds.MATRICES else jnp.asarray(x)[None, :])
    _, js = jpd._fwd_call(*jargs)
    want = jpd._bwd_call(tuple(jargs) + (js,), jnp.asarray(g))
    want = want[:5] + want[6:]                   # no cotangent of the mask

    calls = []
    replay = tds.dec_scan_replay_plain
    monkeypatch.setattr(tds, "dec_scan_replay_plain",
                        lambda *a: calls.append(1) or replay(*a))
    targs = [_t(st[n], BF if n in jbf else torch.float32).requires_grad_(
        n != "mask") for n in names]
    tw = [_t(x, BF if n in tds.MATRICES else torch.float32).requires_grad_(True)
          for n, x in zip(tds.WEIGHTS, w)]
    t_t = tds.DecoderScan.apply("plain", *targs, *tw)
    assert not calls
    t_t.backward(_t(g))
    assert len(calls) == 1
    got = [a.grad for a in targs if a.requires_grad] + [x.grad for x in tw]
    labels = ("dty", "dxg", "ds0", "dctx", "dctxp") + tuple(
        "d" + n for n in tds.WEIGHTS)
    for k, a, b in zip(labels, got, want):
        _scale_close(a.float(), np.asarray(b, np.float32), PALLAS_TOL, k)


@pytest.mark.parametrize("B,Tt,T", [(5, 3, 4), (8, 1, 5)])
def test_bf16_grads_through_the_replay_match_xla_scan(B, Tt, T):
    """The bf16 decoder scan's grads through the replay route (the
    teacher-forced logits of the port's decoder, plain versions) against
    jax.grad of the JAX package's XLA scan at bf16 (bf16 carries),
    GRAD_SCALE_TOL of scale, at a ragged batch and a single target step."""
    jcfg, jp, tp, ctx, mask, s0, tgt_in = _dec_setup(B=B, Tt=Tt, T=T, seed=1)
    m = dataclasses.replace(jcfg.model, dec_scan_impl="xla", dropout=0.0)
    tm = vt.preset("toy").replace(model=dict(
        compute_dtype="bfloat16", multimodal=False, dropout=0.0)).model
    wts = np.random.RandomState(6).randn(*tgt_in.shape, m.tgt_vocab_size)
    wts = wts.astype(np.float32)

    def jf(p, c):
        return (jdec.teacher_forced_logits(p, m, tgt_in, s0, c, mask)
                * wts).sum()

    jg, jgc = jax.grad(jf, argnums=(0, 1))(jp, ctx)
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(tp)]
    c = _t(ctx, BF).requires_grad_(True)
    logits = tdec.teacher_forced_logits(tree_unflatten(tp, leaves), tm,
                                        _t(tgt_in).long(), _t(s0, BF), c,
                                        _t(mask))
    (logits * torch.from_numpy(wts)).sum().backward()
    got = dict(_flat(tree_unflatten(tp, [x.grad for x in leaves])))
    for k, v in _flat(jg):
        _scale_close(got[k], v, GRAD_SCALE_TOL, k)
    _scale_close(c.grad.float(), jgc, GRAD_SCALE_TOL, "ctx")


# -- a torch model of the kernels' partition ---------------------------------

def _tiles(M, N, gate):
    """bf16_tile.cuh's run(): (row0, col0) of each tile in launch order; a
    gate tile's col0 is its first unit."""
    tc = GATE_UNITS if gate else BN
    nt = -(-N // tc)
    for i in range(-(-M // BM) * nt):
        yield i // nt * BM, i % nt * tc


def _tile_cols(n0, N, gate, H):
    """W's column of each of a tile's 64 columns, -1 outside (side_run)."""
    j = torch.arange(BN)
    if gate:
        u = n0 + j % GATE_UNITS
        col = (j // GATE_UNITS) * H + u
        return torch.where((j < 3 * GATE_UNITS) & (u < H), col, -1)
    return torch.where(n0 + j < N, n0 + j, -1)


def _tile_product(segs, m0, cols):
    """One tile's accumulators: for each segment (A (M, K), W (K, *)) in
    order, 64-deep chunks of 64 rows and the tile's columns, zero past
    every edge, summed 16 deep at a time into fp32."""
    acc = torch.zeros(BM, BN)
    for a, w in segs:
        M, K = a.shape
        rows = torch.arange(m0, m0 + BM)
        for k0 in range(0, K, BK):
            ks = torch.arange(k0, k0 + BK)
            at = torch.zeros(BM, BK)
            bt = torch.zeros(BK, BN)
            rin, kin, cin = rows < M, ks < K, cols >= 0
            at[rin[:, None] & kin[None, :]] = a[rows[rin]][:, ks[kin]].reshape(-1)
            bt[kin[:, None] & cin[None, :]] = w[ks[kin]][:, cols[cin]].reshape(-1)
            for k in range(0, BK, 16):
                acc = acc + at[:, k:k + 16] @ bt[k:k + 16]
    return acc


def _job(segs, N, epi, out, H=0, add=None, xg=None, h=None, out2=None,
         seen=None):
    """One job of the tiles (bf16 operands as fp32 values): each tile's
    product and epilogue into out (and, GRU1, out2), counting each output
    written in seen."""
    M = segs[0][0].shape[0]
    gate = epi == "gru1"
    for m0, n0 in _tiles(M, N, gate):
        cols = _tile_cols(n0, N, gate, H)
        acc = _tile_product(segs, m0, cols)
        for r in range(min(BM, M - m0)):
            row = m0 + r
            if gate:
                us = torch.arange(n0, min(n0 + GATE_UNITS, H))
                uu = us - n0
                hg = torch.stack([acc[r, k * GATE_UNITS + uu] + add[k * H + us]
                                  for k in range(3)])
                for k in range(3):
                    out[row, k * H + us] = hg[k]
                    seen[row, k * H + us] += 1
                x = torch.stack([xg[row, k * H + us] for k in range(3)])
                out2[row, us] = gru_gate_algebra(
                    x.reshape(1, -1), hg.reshape(1, -1), h[row, us][None])[0]
                continue
            c = torch.arange(n0, min(n0 + BN, N))
            v = acc[r, c - n0]
            if epi == "bias":
                v = v + add[c]
            elif epi == "tanh_add":
                v = torch.tanh(add[row, c] + v)
            out[row, c] = v
            seen[row, c] += 1


def _att_groups(Tt, B):
    """dec_scan_replay_attention_kernel's grid: CTA (b, y) takes steps
    RG y .. RG y + nt - 1 of sentence b."""
    for y in range(-(-Tt // RG)):
        for b in range(B):
            t0 = y * RG
            yield b, t0, min(RG, Tt - t0)


def _replay_model(ty, xg, ctx, ctxp, mask, weights, states):
    """The replay's four grids as the launch runs them, on the CPU."""
    uh1, bh1, ua, va, wi2, bi2, uh2, bh2, ws, wc = [w.float() for w in weights]
    Tt, B, H3 = xg.shape
    H, C, A, R, T = H3 // 3, ctx.shape[2], ua.shape[1], ws.shape[1], ctx.shape[1]
    rows = Tt * B
    sb = rbf(states.reshape(-1, H))
    out = {k: torch.full((rows, n), float("nan")) for k, n in (
        ("hg1", H3), ("st", H), ("q", A), ("hg2", H3), ("xg2", H3), ("t", R),
        ("c", C), ("w", T))}
    seen = {k: torch.zeros(v.shape, dtype=torch.int32) for k, v in out.items()}
    # 1. gate tiles, GRU1 in the epilogue (s~ written beside hg1)
    _job([(sb[:rows], uh1)], H, "gru1", out["hg1"], H=H, add=bh1,
         xg=xg.reshape(rows, H3).float(), h=states[:-1].reshape(rows, H),
         out2=out["st"], seen=seen["hg1"])
    seen["st"] += 1   # each (row, unit) once with its three gate columns
    stb = rbf(out["st"])
    # 2. q and hg2
    _job([(stb, ua)], A, "store", out["q"], seen=seen["q"])
    _job([(stb, uh2)], H3, "bias", out["hg2"], add=bh2, seen=seen["hg2"])
    # 3. the attention: RG steps of a sentence a CTA, each context column
    # summed over the positions in order
    q = out["q"].reshape(Tt, B, A)
    for b, t0, nt in _att_groups(Tt, B):
        e = torch.tanh(ctxp[b][None] + q[t0:t0 + nt, b][:, None, :]) @ va
        e = torch.where(mask[b][None] > 0, e, torch.full_like(e, tds.NEG_INF))
        w = torch.softmax(e, dim=-1)                       # (nt, T)
        c = w @ ctx[b].float()
        for tt in range(nt):
            row = (t0 + tt) * B + b
            out["w"][row], out["c"][row] = w[tt], c[tt]
            seen["w"][row] += 1
            seen["c"][row] += 1
    cb = rbf(out["c"])
    # 4. xg2 and the readout, two segments into one accumulator
    _job([(cb, wi2)], H3, "bias", out["xg2"], add=bi2, seen=seen["xg2"])
    _job([(cb, wc), (sb[B:], ws)], R, "tanh_add", out["t"],
         add=ty.reshape(rows, R), seen=seen["t"])
    assert all(bool((s == 1).all()) for s in seen.values()), \
        {k: (int(s.min()), int(s.max())) for k, s in seen.items()}
    return {k: v.reshape(Tt, B, -1) for k, v in out.items()}


@pytest.mark.parametrize("Tt,B,T,H,A,C,R", [
    (6, 8, 5, 32, 16, 24, 20),       # one tile a product
    (9, 13, 7, 40, 72, 136, 70),     # ragged tiles, units past a gate tile
    (5, 3, 4, 24, 8, 16, 8),         # Tt not a multiple of RG
])
def test_replay_tiles_model_matches_plain(Tt, B, T, H, A, C, R):
    """The replay's partition, modelled in torch: every output written
    once (the tiles' row and column edges, the gate tiles' units past H,
    the attention's groups of RG steps), and the model within ROUNDOFF of
    dec_scan_replay_plain (the sums in the tiles' order: 64-deep chunks,
    16 deep at a time, segments in order)."""
    args, weights, states, _ = _case(Tt, B, T, H, A, C, R, seed=Tt + B)
    ty, xg, _, ctx, ctxp, mask = args
    want = tds.dec_scan_replay_plain(ty, xg, ctx, ctxp, mask, weights, states)
    got = _replay_model(ty, xg, ctx, ctxp, mask, weights, states)
    for k, v in got.items():
        assert _rel(v, want[k]) < ROUNDOFF, k


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False)])
@pytest.mark.parametrize("M,N,K", [(70, 130, 100), (64, 64, 64), (5, 9, 3)])
def test_bf16_tile_layouts_match_the_product(ta, tb, M, N, K):
    """A job of bf16 tiles in each operand layout the scans use: A (M, K)
    or A^T stored (K, M) (the weight grads: x^T dy over the rows), B (K,
    N) or B^T stored (N, K) (the readout terms: dpre @ w^T). The layout
    moves only where a chunk is staged from (the model reads A(m, k) and
    B(k, n) through strided views); at ragged M, N, K the modelled tiles
    cover each output once and give rbf(A) @ rbf(B) to ROUNDOFF."""
    rng = np.random.RandomState(M + N + K)
    a = rbf(torch.from_numpy(rng.randn(M, K).astype(np.float32)))
    b = rbf(torch.from_numpy(rng.randn(K, N).astype(np.float32)))
    av = a.T.contiguous().T if ta else a
    bv = b.T.contiguous().T if tb else b
    out = torch.full((M, N), float("nan"))
    seen = torch.zeros(M, N, dtype=torch.int32)
    _job([(av, bv)], N, "store", out, seen=seen)
    assert bool((seen == 1).all())
    assert _rel(out, a @ b) < ROUNDOFF


def _context_items(C, P, T):
    """context_bf16's partition of one sentence's row: for each part, its
    rounds of THREADS / 4 column groups of 8, each group's four quarters
    of the positions; returns how often each (column, position) is
    summed."""
    per = -(-(-(-C // P)) // 4) * 4                   # att_cols
    hits = np.zeros((C, T), dtype=np.int32)
    for part in range(P):
        c0 = part * per
        ng = (min(C, c0 + per) - c0) // 8
        for g0 in range(0, ng, THREADS // 4):
            ngr = min(THREADS // 4, ng - g0)
            for i in range(4 * ngr):
                gl, h = i % ngr, i // ngr
                col = c0 + 8 * (g0 + gl)
                hits[col:col + 8, h * T // 4:(h + 1) * T // 4] += 1
    return hits, per


@pytest.mark.parametrize("C,P,T", [(1024, 2, 128), (1024, 1, 24), (2048, 4, 24),
                                   (16, 2, 3), (520, 1, 1)])
def test_context_quarters_cover_each_column_and_position_once(C, P, T):
    """The forward recurrence's eight-wide bf16 context sums (taken where C
    and the part's columns are multiples of 8): every column of the row and
    every position summed exactly once, in rounds when a part has more
    than THREADS / 4 groups (B > 66 on 132 SMs gives one part of C
    columns); the halves' rows hold a round (8 x its groups <= the part's
    columns)."""
    hits, per = _context_items(C, P, T)
    assert per % 8 == 0               # the eight-wide path takes this row
    assert (hits == 1).all()
    assert 8 * min(THREADS // 4, per // 8) <= per


@pytest.mark.parametrize("Tt,B", [(24, 64), (128, 64), (1, 37), (9, 3)])
def test_replay_attention_groups_cover_each_row_once(Tt, B):
    """The replay's attention grid (B, ceil(Tt / RG)): each (t, b) row in
    exactly one CTA's group of at most RG steps of one sentence."""
    seen = np.zeros((Tt, B), dtype=np.int32)
    n = 0
    for b, t0, nt in _att_groups(Tt, B):
        assert 1 <= nt <= RG
        seen[t0:t0 + nt, b] += 1
        n += 1
    assert (seen == 1).all() and n == B * math.ceil(Tt / RG)
