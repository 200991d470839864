"""The fused beam decode step of the PyTorch port (ops/dec_step.py, the
plain version of csrc/dec_step.cu) against the JAX package's Pallas kernel
(ops/pallas_dec_step.py, VAG_DEC_STEP=on, interpret mode on the CPU), and
the port's decoder dispatch with the step selected against its tabled step
without it. Inputs are made with numpy from a seed and handed to both.

Tolerance: rtol = atol = 1e-5, as the JAX package's own kernel tests use;
the step's sums and softmax run in another order than the tabled step's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import ModelConfig as JModelConfig
from vag_nmt_tpu.models import decoder as jdec
from vag_nmt_tpu.ops.attention import precompute_ctx_proj as j_ctx_proj

from vag_nmt_tpu_torch.core.config import ModelConfig
from vag_nmt_tpu_torch.models import decoder as dec
from vag_nmt_tpu_torch.ops import dec_step as ds
from vag_nmt_tpu_torch.ops.attention import precompute_ctx_proj

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

TOL = 1e-5


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _case(B=12, K=5, T=7, V=50, E=12, He=10, H=16, A=8, seed=0):
    """The JAX test's decoder (tests/test_pallas_dec_step.py) with random
    biases, ragged source lengths down to 1 and masked positions."""
    kw = dict(tgt_vocab_size=V, emb_dim=E, hidden_dim=He, dec_hidden_dim=H,
              attn_dim=A, dropout=0.0)
    jp = jdec.init_decoder(jax.random.key(seed), JModelConfig(**kw))
    rng = np.random.RandomState(seed)
    for g in ("gru1", "gru2"):
        for b in ("bi", "bh"):
            jp[g][b] = jnp.asarray(0.1 * rng.randn(3 * H).astype(np.float32))
    jp["attn"]["ba"] = jnp.asarray(0.1 * rng.randn(A).astype(np.float32))
    jp["readout"]["b"] = jnp.asarray(0.1 * rng.randn(E).astype(np.float32))
    tok = rng.randint(0, V, (B, K)).astype(np.int32)
    s = (0.3 * rng.randn(B, K, H)).astype(np.float32)
    ctx = (0.3 * rng.randn(B, T, 2 * He)).astype(np.float32)
    lens = rng.randint(1, T + 1, B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return ModelConfig(**kw), JModelConfig(**kw), jp, tok, s, ctx, mask


def _jax_step(jcfg, jp, tok, s, ctx, mask, env, monkeypatch, tables=True):
    monkeypatch.setenv("VAG_DEC_STEP", env)
    jt = jdec.decode_tables(jp) if tables else None
    ctxp = j_ctx_proj(jp["attn"], jnp.asarray(ctx))
    out = jdec.decode_step_beams_readout(
        jp, jcfg, jnp.asarray(tok), jnp.asarray(s), jnp.asarray(ctx), ctxp,
        jnp.asarray(mask), jt)
    return [np.asarray(x) for x in out[:2]]


def _port_step(cfg, jp, tok, s, ctx, mask, dec_step, tables=True):
    tp = _to_torch(jax.device_get(jp))
    tt = dec.decode_tables(tp) if tables else None
    ctx_t = torch.from_numpy(ctx)
    out = dec.decode_step_beams_readout(
        tp, cfg, torch.from_numpy(tok).long(), torch.from_numpy(s), ctx_t,
        precompute_ctx_proj(tp["attn"], ctx_t), torch.from_numpy(mask), tt,
        dec_step=dec_step)
    return [x.numpy() for x in out[:2]], out


@pytest.mark.parametrize("K", [1, 3, 5])
def test_plain_step_matches_jax_pallas_step(K, monkeypatch):
    cfg, jcfg, jp, tok, s, ctx, mask = _case(K=K, seed=K)
    want = _jax_step(jcfg, jp, tok, s, ctx, mask, "on", monkeypatch)
    got, _ = _port_step(cfg, jp, tok, s, ctx, mask, dec_step=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("K", [1, 3, 5])
def test_dec_step_plain_matches_jax_kernel_entry(K, monkeypatch):
    """ops/dec_step.dec_step_plain on the kernel's own argument layout
    against pallas_decode_step called directly."""
    from vag_nmt_tpu.ops.pallas_dec_step import pallas_decode_step

    cfg, jcfg, jp, tok, s, ctx, mask = _case(K=K, seed=10 + K)
    jt = jdec.decode_tables(jp)
    ctxp = j_ctx_proj(jp["attn"], jnp.asarray(ctx))
    ws, wt = pallas_decode_step(jp, jt, jnp.asarray(tok), jnp.asarray(s),
                                jnp.asarray(ctx), ctxp, jnp.asarray(mask))
    tp = _to_torch(jax.device_get(jp))
    tt = dec.decode_tables(tp)
    B, _, H = s.shape
    ctx_t = torch.from_numpy(ctx)
    ctxpb = precompute_ctx_proj(tp["attn"], ctx_t) + tp["attn"]["ba"]
    gy = tt["gy"][torch.from_numpy(tok).long().reshape(-1)]
    s_new, t = ds.dec_step(gy, torch.from_numpy(s).reshape(B * K, H), ctx_t,
                           ctxpb, torch.from_numpy(mask),
                           ds.step_weights(tp, tt))
    np.testing.assert_allclose(s_new.reshape(B, K, H).numpy(), np.asarray(ws),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(wt), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("K", [1, 3, 5])
def test_step_selected_matches_tabled_step(K, monkeypatch):
    """decode_step_beams_readout with the fused step selected (argument or
    VAG_DEC_STEP=on) equals the port's tabled step without it, and the JAX
    tabled step; without tables the knob has no effect."""
    cfg, jcfg, jp, tok, s, ctx, mask = _case(K=K, seed=20 + K)
    (s_on, t_on), out_on = _port_step(cfg, jp, tok, s, ctx, mask, True)
    (s_off, t_off), out_off = _port_step(cfg, jp, tok, s, ctx, mask, False)
    np.testing.assert_allclose(s_on, s_off, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_on, t_off, rtol=TOL, atol=TOL)
    assert torch.equal(out_on[2], out_off[2]) and torch.equal(out_on[3],
                                                              out_off[3])
    want = _jax_step(jcfg, jp, tok, s, ctx, mask, "off", monkeypatch)
    np.testing.assert_allclose(s_off, want[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_off, want[1], rtol=TOL, atol=TOL)
    monkeypatch.setenv("VAG_DEC_STEP", "on")
    (s_env, t_env), _ = _port_step(cfg, jp, tok, s, ctx, mask, None)
    np.testing.assert_array_equal(s_env, s_on)
    np.testing.assert_array_equal(t_env, t_on)
    (s_un, _), _ = _port_step(cfg, jp, tok, s, ctx, mask, None, tables=False)
    (s_un_off, _), _ = _port_step(cfg, jp, tok, s, ctx, mask, False,
                                  tables=False)
    np.testing.assert_array_equal(s_un, s_un_off)


def test_pad_columns_do_not_change_outputs():
    """Masked pad positions appended to ctx leave the step unchanged."""
    cfg, _, jp, tok, s, ctx, mask = _case(T=5, seed=3)
    (s1, t1), _ = _port_step(cfg, jp, tok, s, ctx, mask, True)
    ctx2 = np.concatenate([ctx, np.full((ctx.shape[0], 3, ctx.shape[2]), 7.7,
                                        np.float32)], axis=1)
    mask2 = np.concatenate([mask, np.zeros((mask.shape[0], 3), np.float32)], 1)
    (s2, t2), _ = _port_step(cfg, jp, tok, s, ctx2, mask2, True)
    np.testing.assert_allclose(s2, s1, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t2, t1, rtol=1e-6, atol=1e-6)


def test_kernel_impl_on_cpu_raises():
    cfg, _, jp, tok, s, ctx, mask = _case(B=2, K=2, seed=4)
    tp = _to_torch(jax.device_get(jp))
    tt = dec.decode_tables(tp)
    ctx_t = torch.from_numpy(ctx)
    with pytest.raises(ValueError, match="CUDA"):
        ds.decode_step_fused(tp, tt, torch.from_numpy(tok).long(),
                             torch.from_numpy(s), ctx_t,
                             precompute_ctx_proj(tp["attn"], ctx_t),
                             torch.from_numpy(mask), impl="kernel")
