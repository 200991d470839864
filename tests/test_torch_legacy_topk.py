"""The plain versions of the port's two legacy beam top-K kernels against
the JAX package's gen 1 and gen 2 Pallas kernels (``beam_topk(impl=
"pallas" | "pallas_rows")``, ``ops/topk_legacy.py``) in interpret mode, on
the CPU. The CUDA kernels are held against the same plain versions on the
card by chip_smoke.py.

Ids must be equal, ties resolved by each kernel's own rule (gen 1: vocab
block of 512, then beam, then id; gen 2: beam, then id), not merely "any
tied index". Values are equal on all-finished rows (the scores
themselves) and else to 1e-5: the two frameworks sum the log-sum-exp in
another order, which moves it by an ulp on some rows (every candidate of a
row carries the same lse, so the orders are not affected)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.ops.pallas_topk import beam_topk as j_beam_topk

from vag_nmt_tpu_torch.ops.topk import (
    beam_topk,
    beam_topk_plain,
    legacy_topk_blocks,
    legacy_topk_blocks_plain,
    legacy_topk_rows,
    legacy_topk_rows_plain,
)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ATOL = 1e-5
PLAIN = {"pallas": legacy_topk_blocks_plain, "pallas_rows": legacy_topk_rows_plain}


def T(x):
    return torch.from_numpy(np.array(x))


def _case(B, K, V, ff, seed, ties=False):
    """tests/test_pallas_topk.py's inputs; with ties, integer logits whose
    rows repeat across a sentence's beams under equal scores, with the
    maximum at v=100 and v=600: the best candidates tie across beams and
    across the first two vocab blocks, (k=1, v=100) against (k=0, v=600)."""
    rng = np.random.RandomState(seed)
    if ties:
        logits = np.repeat(rng.randint(-2, 3, (B, 1, V)), K, 1).astype(np.float32)
        logits[:, :, [100, 600]] = 5.0
        scores = np.repeat(rng.randint(-3, 1, (B, 1)), K, 1).astype(np.float32)
    else:
        logits = (rng.randn(B, K, V) * 3.0).astype(np.float32)
        scores = rng.randn(B, K).astype(np.float32)
    return logits, scores, rng.rand(B, K) < ff


CASES = [
    (8, 5, 1000, 0.0, False),
    (8, 5, 1000, 0.4, False),      # mixed finished rows
    (16, 5, 1303, 0.2, False),     # V not a multiple of the vocab block
    (4, 3, 512, 1.0, False),       # everything finished
    (2, 1, 700, 0.0, False),       # K=1
    (8, 5, 1000, 0.0, True),       # forced ties across blocks and beams
    (4, 5, 1303, 0.25, True),      # ties, frozen rows, a partial last block
]


@pytest.mark.parametrize("gen", ["pallas", "pallas_rows"])
@pytest.mark.parametrize("B,K,V,ff,ties", CASES)
def test_legacy_plain_matches_jax_kernel(B, K, V, ff, ties, gen):
    logits, scores, fin = _case(B, K, V, ff, seed=B + V, ties=ties)
    want = j_beam_topk(jnp.asarray(logits), jnp.asarray(scores),
                       jnp.asarray(fin), impl=gen)
    got = PLAIN[gen](T(logits), T(scores), T(fin))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    tol = 0.0 if ff == 1.0 else ATOL
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=tol)
    assert got[1].dtype == torch.int64


def test_cross_block_ties_follow_each_kernels_rule():
    """The forced tie: gen 1 takes (k=1, v=100) before (k=0, v=600) (the
    earlier vocab block first), gen 2 and beam_topk the other way round
    (the smaller beam first), and both agree with their JAX kernels."""
    B, K, V = 2, 5, 1000
    logits, scores, fin = _case(B, K, V, 0.0, seed=3, ties=True)
    args = (T(logits), T(scores), T(fin))
    g1 = legacy_topk_blocks_plain(*args)[1].numpy()
    g2 = legacy_topk_rows_plain(*args)[1].numpy()
    flat = beam_topk_plain(*args)[1].numpy()
    for b in range(B):
        assert list(g1[b, :4]) == [100, V + 100, 2 * V + 100, 3 * V + 100]
        assert list(g2[b, :4]) == [100, 600, V + 100, V + 600]
    np.testing.assert_array_equal(g2, flat)
    assert (g1 != g2).any()
    for gen, got in (("pallas", g1), ("pallas_rows", g2)):
        want = j_beam_topk(jnp.asarray(logits), jnp.asarray(scores),
                           jnp.asarray(fin), impl=gen)
        np.testing.assert_array_equal(got, np.asarray(want[1]))


def test_legacy_kernels_raise_on_cpu_tensors(monkeypatch):
    """The knob values and explicit impls launch the CUDA kernels, which a
    CPU tensor cannot take; impl="auto" or "plain" on the wrappers runs the
    plain versions."""
    logits, scores, fin = _case(2, 3, 700, 0.3, seed=1, ties=True)
    args = (T(logits), T(scores), T(fin))
    for gen, fn, plain in (("pallas", legacy_topk_blocks, legacy_topk_blocks_plain),
                           ("pallas_rows", legacy_topk_rows, legacy_topk_rows_plain)):
        ref = plain(*args)
        for impl in ("auto", "plain"):
            got = fn(*args, impl=impl)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, impl="kernel")
        with pytest.raises(ValueError, match="CUDA"):
            beam_topk(*args, impl=gen)
        monkeypatch.setenv("VAG_TOPK_IMPL", gen)
        with pytest.raises(ValueError, match="CUDA"):
            beam_topk(*args)
        monkeypatch.delenv("VAG_TOPK_IMPL")
