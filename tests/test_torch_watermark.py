"""The readout top-K's shallow-slot watermark mode: the port's plain version
under the TPU kernel's own lane map (``id % 128``) against the JAX package's
Pallas kernel in interpret mode, row for row, and the public
``fused_readout_topk`` contract (slots, defer_exact, the per-step recovery)
against the JAX function. On the CPU; the CUDA kernel is held against the
same plain version under its own lane map (``kernel_lanes``) on the card by
chip_smoke.py.

Tolerances: per-row viol flags exactly; values exactly on integer-valued
data, else to 1e-5 (the two frameworks sum the GEMM and the log-sum-exp in
another order); ids exactly on every row that is not flagged. On a flagged
row the shallow ids may differ among equal values: a lane of the port keeps
its best by (value, smaller id), while the TPU cascade's strict ">" lets a
later equal value keep a slot that an earlier id is pushed out of. Either
way the slot values, hence the watermark and the flag, are the same, and a
flagged row is recovered at depth K."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vag_nmt_tpu.ops import pallas_readout_topk as jrt

from vag_nmt_tpu_torch.ops import readout_topk as rt

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ATOL = 1e-5
TV = 512                 # the JAX kernel's vocab block (fused_readout_topk's tv)


def T(x):
    return torch.from_numpy(np.array(x))


def _jax_rows(t, w, b, K, sk, mask=None):
    """The JAX package's _kernel at slot depth sk, called as its
    fused_readout_topk calls it (direct=True, tv=512), in interpret mode:
    (vals (R, K), idx (R, K), lse (R,), viol (R,))."""
    R, E = t.shape
    V = w.shape[1]
    ban_in = [] if mask is None else [pl.BlockSpec((R, TV), lambda j: (0, j))]
    out = pl.pallas_call(
        functools.partial(jrt._kernel, V=V, tv=TV, K=K, sk=sk, direct=True,
                          has_ban=mask is not None),
        grid=(-(-V // TV),),
        in_specs=[pl.BlockSpec((R, E), lambda j: (0, 0)),
                  pl.BlockSpec((E, TV), lambda j: (0, j)),
                  pl.BlockSpec((1, TV), lambda j: (0, j))] + ban_in,
        out_specs=[pl.BlockSpec((R, K), lambda j: (0, 0)),
                   pl.BlockSpec((R, K), lambda j: (0, 0)),
                   pl.BlockSpec((R, 1), lambda j: (0, 0)),
                   pl.BlockSpec((R, 1), lambda j: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((R, K), jnp.float32),
                   jax.ShapeDtypeStruct((R, K), jnp.int32),
                   jax.ShapeDtypeStruct((R, 1), jnp.float32),
                   jax.ShapeDtypeStruct((R, 1), jnp.int32)],
        scratch_shapes=([pltpu.VMEM((8, 128), jnp.float32)]
                        + [pltpu.VMEM((R, 128), jnp.float32)] * (2 + sk)
                        + [pltpu.VMEM((R, 128), jnp.int32)] * sk),
        interpret=True,
    )(*((jnp.asarray(t), jnp.asarray(w), jnp.asarray(b).reshape(1, V))
        + (() if mask is None else (jnp.asarray(mask),))))
    v, i, lse, viol = (np.asarray(x) for x in out)
    return v, i, lse[:, 0], viol[:, 0]


TPU_COLLISION = (7, 135, 263, 391, 519)      # lane 7 of the TPU's 128


def _case(kind, R=40, V=1000, E=32, seed=0, collision=TPU_COLLISION):
    """kind "collision": every row's best logits at the ids ``collision``
    (tests/test_pallas_readout_topk.py:119-140), which share one lane."""
    rng = np.random.RandomState(seed)
    if kind == "integer":
        # logits in {0, 1, 2}: lanes full of ties at the top of each row
        t = rng.randint(0, 2, (R, 2)).astype(np.float32)
        w = rng.randint(0, 2, (2, V)).astype(np.float32)
        b = np.zeros(V, np.float32)
    else:
        t = rng.randn(R, E).astype(np.float32)
        w = rng.randn(E, V).astype(np.float32)
        b = rng.randn(V).astype(np.float32)
    if kind == "collision":
        b = np.linspace(-1.0, 0.0, V).astype(np.float32)
        w = np.zeros_like(w)
        for rank, vid in enumerate(collision):
            b[vid] = 100.0 - rank
    mask = None
    if kind == "ban":
        ban = rng.randint(0, V + 1, (R, 12))
        mask = rt.ban_mask(T(ban), V).numpy()
    return t, w, b, mask


@pytest.mark.parametrize("kind", ["random", "integer", "collision", "ban"])
@pytest.mark.parametrize("sk", [1, 2, 3, 4])
def test_watermark_plain_matches_jax_kernel_row_for_row(kind, sk):
    K = 5
    t, w, b, mask = _case(kind, seed=sk)
    V = w.shape[1]
    want = _jax_rows(t, w, b, K, sk, mask)
    got = rt.readout_topk_rows_plain(T(t), T(w), T(b), K,
                                     None if mask is None else T(mask),
                                     slots=sk, lanes=torch.arange(V) % 128)
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    ok = want[3] == 0
    np.testing.assert_array_equal(got[1].numpy()[ok], want[1][ok])
    tol = 0.0 if kind in ("integer", "collision") else ATOL
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=tol)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=ATOL)
    if kind == "collision":
        assert got[3].all()
    if kind == "integer":
        assert got[3].any()              # ties at the top fire the watermark


def _fused_case(kind, B=8, K=5, V=1024, E=64, seed=0,
                collision=TPU_COLLISION):
    t, w, b, mask = _case("collision" if kind == "collision" else "random",
                          R=B * K, V=V, E=E, seed=seed, collision=collision)
    rng = np.random.RandomState(seed + 1)
    scores = rng.randn(B, K).astype(np.float32)
    fin = rng.rand(B, K) < {"frozen": 1.0, "collision": 0.0}.get(kind, 0.2)
    ban = None
    if kind == "ban":
        ban = rng.randint(0, V + 1, (B * K, 12)).astype(np.int32)
        ban[:, -1] = ban[:, 0]
    return t, w, b, scores, fin, ban


@pytest.mark.parametrize("kind", ["random", "collision", "frozen", "ban"])
@pytest.mark.parametrize("slots", [1, 2, 3, 4])
def test_fused_defer_matches_jax(kind, slots, monkeypatch):
    """fused_readout_topk(slots, defer_exact=True) of the port on the TPU's
    lane map against the JAX function: the candidates and the live flag. A
    collision flags every live row; frozen rows never arm the flag."""
    t, w, b, scores, fin, ban = _fused_case(kind, seed=slots)
    V = w.shape[1]
    jb = None if ban is None else jnp.asarray(ban)
    want = jrt.fused_readout_topk(jnp.asarray(t), jnp.asarray(w),
                                  jnp.asarray(b), jnp.asarray(scores),
                                  jnp.asarray(fin), jb, impl="pallas",
                                  slots=slots, defer_exact=True)
    monkeypatch.setattr(rt, "kernel_lanes", lambda R, V_: torch.arange(V_) % 128)
    got = rt.fused_readout_topk(T(t), T(w), T(b), T(scores), T(fin),
                                None if ban is None else T(ban),
                                impl="plain", slots=slots, defer_exact=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=ATOL, atol=ATOL)
    assert bool(got[2]) == bool(want[2])
    assert got[2].shape == () and got[2].dtype == torch.bool
    if kind == "collision":
        assert bool(got[2])
    if kind == "frozen":
        assert not bool(got[2])


@pytest.mark.parametrize("slots", [1, 3])
def test_per_step_recovery_equals_depth_k(slots, monkeypatch):
    """Without defer_exact the flagged live rows are recovered within the
    step, and the result is depth K's (the JAX per-step cond), with the
    recoveries counted; VAG_FRT_NOCOND=1 skips the recovery. The collision
    is built in one lane of the kernel's own map (at R=40, V=1024 a lane is
    4 columns: ids 4-7, the fifth best elsewhere)."""
    lanes = rt.kernel_lanes(40, 1024)
    assert len(set(lanes[[4, 5, 6, 7]].tolist())) == 1
    t, w, b, scores, fin, _ = _fused_case("collision", seed=slots,
                                          collision=(4, 5, 6, 7, 100))
    args = (T(t), T(w), T(b), T(scores), T(fin))
    full = rt.fused_readout_topk(*args, impl="plain")
    want = jrt.fused_readout_topk(*(jnp.asarray(np.array(a)) for a in args),
                                  impl="pallas", slots=slots)
    rt.readout_topk_rows.recoveries = None
    got = rt.fused_readout_topk(*args, impl="plain", slots=slots)
    np.testing.assert_array_equal(got[1].numpy(), full[1].numpy())
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), full[0].numpy(), rtol=1e-6,
                               atol=1e-6)
    R = t.shape[0]
    assert rt.readout_topk_rows.recoveries.tolist() == [R, 1]
    # the rows themselves: shallow ones lose the lane's fourth id
    rows = rt.readout_topk_rows_plain(*args[:3], 5, slots=slots)
    depth_k = rt.readout_topk_rows_plain(*args[:3], 5)
    assert rows[3].all() and not torch.equal(rows[1], depth_k[1])
    monkeypatch.setenv("VAG_FRT_NOCOND", "1")
    rt.fused_readout_topk(*args, impl="plain", slots=slots)
    assert rt.readout_topk_rows.recoveries.tolist() == [R, 1]   # none
    monkeypatch.setenv("VAG_FRT_SLOTS", str(slots))
    monkeypatch.delenv("VAG_FRT_NOCOND")
    via_env = rt.fused_readout_topk(*args, impl="plain")
    np.testing.assert_array_equal(via_env[1].numpy(), full[1].numpy())
    assert rt.readout_topk_rows.recoveries.tolist() == [2 * R, 2]


def test_kernel_lanes_follow_the_split_plan():
    for R, V in ((640, 16000), (640, 8000), (12, 300)):
        n_split, cols = rt._split_plan(R, V)
        lanes = rt.kernel_lanes(R, V)
        assert int(lanes.max()) < n_split * rt._COL_TILE // rt._LANE_COLS
        # a lane: one thread's 4 columns of every 64-column tile of a split
        v = torch.arange(V)
        same = lanes[:, None] == lanes[None, :300]
        want = ((v[:, None] // cols == v[None, :300] // cols)
                & ((v[:, None] % 64) // 4 == (v[None, :300] % 64) // 4))
        assert torch.equal(same, want)


def test_deferred_exactness_active(monkeypatch):
    for k in ("VAG_FRT_SLOTS", "VAG_FRT_DEFER", "VAG_FRT_NOCOND",
              "VAG_READOUT_TOPK"):
        monkeypatch.delenv(k, raising=False)
    assert not rt.deferred_exactness_active(5)           # depth K
    monkeypatch.setenv("VAG_FRT_SLOTS", "3")
    assert rt.deferred_exactness_active(5)               # fused by default
    assert not rt.deferred_exactness_active(3)
    monkeypatch.setenv("VAG_FRT_DEFER", "0")
    assert not rt.deferred_exactness_active(5)
    monkeypatch.delenv("VAG_FRT_DEFER")
    monkeypatch.setenv("VAG_FRT_NOCOND", "1")
    assert not rt.deferred_exactness_active(5)
    monkeypatch.delenv("VAG_FRT_NOCOND")
    monkeypatch.setenv("VAG_READOUT_TOPK", "unfused")
    assert not rt.deferred_exactness_active(5)


def test_slots_on_cpu_kernel_impl_raises():
    t, w, b, _ = _case("random", R=10, V=300)
    with pytest.raises(ValueError, match="CUDA"):
        rt.readout_topk_rows(T(t), T(w), T(b), 5, slots=2, impl="kernel")
    out = rt.readout_topk_rows(T(t), T(w), T(b), 5, slots=5)
    assert len(out) == 4 and not out[3].any()             # depth K: no flags
    assert len(rt.readout_topk_rows(T(t), T(w), T(b), 5)) == 3
