"""Beam sizes past 8 in the K-capped kernels (1, 6, 7, 8 and 9), on the CPU.

Kernels 1 and 7 size register arrays by VAG_MAX_K, so each is built twice
from one source (``ops/topk.py``'s ``K_INSTANCES``): VAG_MAX_K = 8 for
K <= 8, with the defines the beam-5 path has always been built with, and
VAG_MAX_K = 16 for K > 8. Kernels 6, 8 and 9 are built once, their K
switch over 1..16. Above 16 the top-K kernels run ``k_plan``'s passes
(entries ``*_passes_launch``) and kernel 7 its attention in groups of 16:
the kernel route is taken at every K (on CPU tensors it raises, the
kernels having no CPU mode), and impl="plain" runs the plain version. The
wide-beam plain versions are held against the JAX package's
``impl="xla"`` top-K at K = 12 and 16 (and at K = 17..40 in
``tests/test_torch_topk_passes.py``); the kernels against their plain
versions on the card by chip_smoke.py (phase 2b)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.ops import pallas_readout_topk as jrt
from vag_nmt_tpu.ops import pallas_topk as jtopk

from vag_nmt_tpu_torch.ops import _build
from vag_nmt_tpu_torch.ops import dec_step as ds
from vag_nmt_tpu_torch.ops import readout_topk as rt
from vag_nmt_tpu_torch.ops import topk

torch.set_num_threads(1)

CAPPED = ("readout_topk", "beam_topk", "legacy_topk", "dec_step")
INSTANCED = ("readout_topk", "dec_step")    # VAG_MAX_K sizes registers
ON_CPU = "CUDA tensor"     # the kernel route's raise on CPU tensors
# The K <= 8 builds' defines before the K <= 16 instances existed.
BEAM5_DEFINES = {
    "readout_topk": {"VAG_BM": 64, "VAG_BN": 128, "VAG_BK": 64,
                     "VAG_LANE_PERIOD": 64, "VAG_CPT": 4, "VAG_MAX_K": 8},
    "beam_topk": {"VAG_MAX_K": 8, "VAG_SPLIT_THREADS": 128},
    "legacy_topk": {"VAG_MAX_K": 8, "VAG_SPLIT_THREADS": 128},
    "dec_step": {"VAG_MAX_K": 8, "VAG_BM": 64, "VAG_BK": 32, "VAG_UB": 16,
                 "VAG_BN": 80, "VAG_RN": 32, "VAG_SPLIT": 4, "VAG_STAGES": 3,
                 "VAG_ATT_CLUSTER": 4},
}


@pytest.mark.parametrize("K", range(1, 21))
def test_instance_chosen_for_each_k(K):
    want = 8 if K <= 8 else 16
    passes = 1 if K <= 16 else -(-K // 16)
    assert topk.k_instance(K) == want
    assert topk.k_plan(K) == (want, passes)
    for base in CAPPED:
        text = _build._src(base).read_text()
        case = "VAG_TOPK_CASE" if base == "beam_topk" else "VAG_LEGACY_CASE"
        if base not in INSTANCED:       # one build, its K switch 1..16
            assert (f"{case}({K})" in text) == (K <= 16)
            assert "_passes_launch" in text
            continue
        name = topk.instance(base, K)
        assert name == (base if K <= 8 else f"{base}_k16")
        fns, defines, src = _build._KERNELS[name]
        assert src == base and defines["VAG_MAX_K"] == want
        assert _build._src(name).name == f"{base}.cu"


@pytest.mark.parametrize("base", CAPPED)
def test_beam5_builds_keep_their_defines(base):
    """K <= 8 keeps its build: the same defines, so the same code. The
    one build of kernels 6, 8 and 9 drops VAG_MAX_K, which no longer
    shapes anything but the K switch."""
    if base not in INSTANCED:
        want = dict(BEAM5_DEFINES[base])
        del want["VAG_MAX_K"]
        assert _build._KERNELS[base][1] == want
        assert f"{base}_k16" not in _build._KERNELS
        assert "VAG_MAX_K" not in _build._src(base).read_text()
        return
    assert _build._KERNELS[base][1] == BEAM5_DEFINES[base]
    k16 = dict(BEAM5_DEFINES[base], VAG_MAX_K=16)
    assert _build._KERNELS[f"{base}_k16"][1] == k16
    assert _build._KERNELS[f"{base}_k16"][0].keys() == _build._KERNELS[base][0].keys()


def test_readout_k16_lane_merge_fits_the_ring():
    """csrc/readout_topk.cu's static_assert at MAX_K = 16 with the one
    tiling both instances share: BM x TX lanes of 2 * 16 + 3 floats within
    the STAGES stages of the cp.async ring."""
    BM, BN, BK = rt._ROW_TILE, rt._COL_TILE, rt._DEPTH_CHUNK
    TX = rt._LANE_PERIOD // rt._LANE_COLS
    ring = 3 * (BM * (BK + 4) + BK * (BN + 8) + BN)
    assert BM * TX * (2 * 16 + 3) <= ring


def _kernel_route(monkeypatch, module):
    """The wrapper in ``module`` resolves CPU tensors to the kernel route
    unless impl="plain", as it would CUDA tensors."""
    monkeypatch.setattr(module, "resolve_impl",
                        lambda impl, x: "plain" if impl == "plain" else "kernel")


def _topk_case(B, K, V, seed):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy((3 * rng.randn(B, K, V)).astype(np.float32)),
            torch.from_numpy(rng.randn(B, K).astype(np.float32)),
            torch.from_numpy(rng.rand(B, K) < 0.3))


@pytest.mark.parametrize("name", ["beam_topk", "legacy_topk_blocks",
                                  "legacy_topk_rows"])
def test_topk_plain_route_above_16(monkeypatch, name):
    _kernel_route(monkeypatch, topk)
    """Above 16 beams the kernel route goes to the kernel (the passes),
    whatever impl selects it: on CPU tensors it raises at the kernel's
    argument check, and launches nothing; above V it raises before.
    impl="plain" gives the plain version's result."""
    fn = getattr(topk, name)
    plain = getattr(topk, f"{name}_plain")
    before = (fn.launches, fn.passes)
    for K in (17, 20):
        args = _topk_case(3, K, 700, K)
        for impl in ("auto", "kernel"):
            with pytest.raises(ValueError, match=ON_CPU):
                fn(*args, impl=impl)
        got = fn(*args, impl="plain")
        assert all(torch.equal(a, b) for a, b in zip(got, plain(*args)))
    with pytest.raises(ValueError, match="K <= V"):
        fn(*_topk_case(2, 20, 19, 1), impl="kernel")
    with pytest.raises(ValueError, match=ON_CPU):   # K = 16: the kernel
        fn(*_topk_case(3, 16, 700, 1), impl="kernel")
    assert (fn.launches, fn.passes) == before


def test_readout_plain_route_above_16(monkeypatch):
    _kernel_route(monkeypatch, rt)
    rng = np.random.RandomState(3)
    t = torch.from_numpy(rng.randn(40, 32).astype(np.float32))
    w = torch.from_numpy(rng.randn(32, 300).astype(np.float32))
    b = torch.from_numpy(rng.randn(300).astype(np.float32))
    for K in (17, 20):
        for kw in ({}, {"slots": 3}):
            with pytest.raises(ValueError, match=ON_CPU):
                rt.readout_topk_rows(t, w, b, K, **kw)
        got = rt.readout_topk_rows(t, w, b, K, impl="plain")
        assert all(torch.equal(a, c) for a, c in
                   zip(got, rt.readout_topk_rows_plain(t, w, b, K)))
    # shallow slots above 16 below K: no instance keeps them
    with pytest.raises(ValueError, match="slots a lane"):
        rt.readout_topk_rows(t, w, b, 20, slots=17)
    with pytest.raises(ValueError, match=ON_CPU):
        rt.readout_topk_rows(t, w, b, 16)


def test_dec_step_plain_route_above_16(monkeypatch):
    _kernel_route(monkeypatch, ds)
    rng = np.random.RandomState(4)
    B, T, H, A, C, R = 2, 5, 16, 16, 32, 8

    def r(*shape):
        return torch.from_numpy((0.3 * rng.randn(*shape)).astype(np.float32))

    weights = (r(H, 3 * H), r(3 * H), r(H, A + 3 * H), r(3 * H), r(A),
               r(C, 3 * H + R), r(3 * H), r(H, R), r(R))
    mask = torch.ones(B, T)
    for K in (17, 20):
        args = (r(B * K, 3 * H + R), r(B * K, H), r(B, T, C), r(B, T, A), mask)
        with pytest.raises(ValueError, match=ON_CPU):
            ds.dec_step(*args, weights)
        got = ds.dec_step(*args, weights, impl="plain")
        want = ds.dec_step_plain(*args, weights)
        assert all(torch.equal(a, c) for a, c in zip(got, want))
    K = 16
    with pytest.raises(ValueError, match=ON_CPU):
        ds.dec_step(r(B * K, 3 * H + R), r(B * K, H), r(B, T, C), r(B, T, A),
                    mask, weights)
    assert ds.dec_step.beam_groups == 0


@pytest.mark.parametrize("K", [12, 16])
def test_wide_beam_plain_versions_match_jax(K):
    """The plain versions the K <= 16 instances are held to on the card,
    against the JAX package's XLA top-K, at K = 12 and 16: ids exactly,
    values to 1e-5."""
    B, V, E = 3, 500, 24
    logits, scores, fin = _topk_case(B, K, V, 30 + K)
    want = jtopk.beam_topk(jnp.asarray(logits.numpy()),
                           jnp.asarray(scores.numpy()),
                           jnp.asarray(fin.numpy()), impl="xla")
    got = topk.beam_topk_plain(logits, scores, fin)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5,
                               rtol=0)
    rng = np.random.RandomState(K)
    t = rng.randn(B * K, E).astype(np.float32)
    w = (0.3 * rng.randn(E, V)).astype(np.float32)
    b = (0.1 * rng.randn(V)).astype(np.float32)
    want = jrt.fused_readout_topk(jnp.asarray(t), jnp.asarray(w),
                                  jnp.asarray(b), jnp.asarray(scores.numpy()),
                                  jnp.asarray(fin.numpy()), impl="xla")
    got = rt.fused_readout_topk(torch.from_numpy(t), torch.from_numpy(w),
                                torch.from_numpy(b), scores, fin, impl="plain")
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5,
                               rtol=0)
