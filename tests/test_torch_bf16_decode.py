"""bf16 decode through the port (decode.compute_dtype="bfloat16"), on the
CPU, against the JAX package.

The reference decodes in bf16 by casting its params once per decode
program (``utils/pytree.cast_floats``): every matrix product then runs on
bf16 operands with fp32 sums, the encoder on bf16 streams, the beam states
in bf16, the attention's energies in bf16 (``VAG_ATTN_E_DTYPE``), and the
readout top-K on bf16 t and W (kernel 1 in bf16, or ``VAG_FRT_GEMM_DTYPE``
in an fp32 decode). The port's plain versions follow the same rounding
points; the CUDA kernels' bf16 instances (1b, 7b, 2b) are held against
these plain versions on the card by chip_smoke.py (phases 17-20). Inputs
come from numpy seeds at the toy preset's widths; each test names its
oracle and tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import ModelConfig as JModelConfig
from vag_nmt_tpu.core.config import preset as jax_preset
from vag_nmt_tpu.data.datasets import make_toy_examples as jax_toy_examples
from vag_nmt_tpu.data.datasets import toy_vocab as jax_toy_vocab
from vag_nmt_tpu.decode.translate import translate_corpus as jax_translate
from vag_nmt_tpu.models import decoder as jdec
from vag_nmt_tpu.models import init_params as jax_init_params
from vag_nmt_tpu.models import prepare_decode as jax_prepare_decode
from vag_nmt_tpu.models.model import decode_step as jax_decode_step
from vag_nmt_tpu.models.model import decode_step_topk as jax_step_topk
from vag_nmt_tpu.ops.attention import bahdanau_attend_beams_q as j_attend_q
from vag_nmt_tpu.ops.attention import precompute_ctx_proj as j_ctx_proj
from vag_nmt_tpu.ops.pallas_dec_step import pallas_decode_step
from vag_nmt_tpu.ops.pallas_readout_topk import fused_readout_topk as j_frt
from vag_nmt_tpu.utils.pytree import cast_floats as j_cast_floats

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.core.config import ModelConfig
from vag_nmt_tpu_torch.data.datasets import make_toy_examples, toy_vocab
from vag_nmt_tpu_torch.models import decoder as tdec
from vag_nmt_tpu_torch.models.layers import mm
from vag_nmt_tpu_torch.models.model import (DecodeOpts, decode_opts,
                                            decode_params, decode_step_topk)
from vag_nmt_tpu_torch.ops import dec_step as ds
from vag_nmt_tpu_torch.ops import readout_topk as rt
from vag_nmt_tpu_torch.ops.attention import bahdanau_attend_beams_q
from vag_nmt_tpu_torch.ops.attention import precompute_ctx_proj

from tests.test_models import make_batch
from tests.test_torch_dec_step import _to_torch
from tests.test_torch_params import _flat

torch.set_num_threads(1)

BF = torch.bfloat16
# bf16 activations against bf16 activations on other rounding points (the
# encoder's carry fp32 here, bf16 in the JAX XLA scan; sums in other
# orders): relative to the tensor's largest magnitude.
SCALE_TOL = 2e-2
# Kernel 7's bf16 states against the JAX kernel's: one bf16 ulp of |s| < 1
# (2^-8) where the two land either side of a rounding boundary, twice.
STATE_ATOL = 1.6e-2
# The readout's values: the same exact products of bf16 values, fp32 sums
# in another order.
READOUT_RTOL = 1e-5
MIN_SAME_HYPS = 0.9
DTYPE_KNOBS = ("VAG_ATTN_E_DTYPE", "VAG_FRT_GEMM_DTYPE", "VAG_READOUT_TOPK",
               "VAG_DEC_STEP", "VAG_TOKEN_TABLES", "VAG_SUPER_CHUNK")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in DTYPE_KNOBS:
        monkeypatch.delenv(k, raising=False)


def _scale_close(a, b, tol, what=""):
    a = np.asarray(torch.as_tensor(np.asarray(a, np.float32)), np.float32)
    b = np.asarray(b, np.float32)
    denom = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(a - b).max()) / denom
    assert err < tol, (what, err)
    return err


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _cfgs(multimodal=True, **decode):
    upd = dict(model=dict(multimodal=multimodal),
               decode=dict(compute_dtype="bfloat16", **decode))
    return jax_preset("toy").replace(**upd), vt.preset("toy").replace(**upd)


def _params(jcfg, seed=0, spread=0.0):
    jp = jax_init_params(jax.random.key(seed), jcfg.model)
    # random biases, so every bias term of the step is exercised
    rng = np.random.RandomState(seed)
    for g in ("gru1", "gru2"):
        for b in ("bi", "bh"):
            n = jp["decoder"][g][b].shape[0]
            jp["decoder"][g][b] = jnp.asarray(0.1 * rng.randn(n), jnp.float32)
    jp["decoder"]["attn"]["ba"] = jnp.asarray(
        0.1 * rng.randn(jp["decoder"]["attn"]["ba"].shape[0]), jnp.float32)
    if spread:
        # an output bias spread wide enough that the top candidates of a
        # step stand apart (an untrained model's logits are nearly tied)
        V = jp["decoder"]["readout"]["b_out"].shape[0]
        jp["decoder"]["readout"]["b_out"] = jnp.asarray(
            spread * rng.randn(V), jnp.float32)
    return jp


def _both(jcfg, cfg, seed=0, spread=0.0):
    jp = _params(jcfg, seed, spread)
    tp = vt.params_from_numpy(jax.device_get(jp), cfg.model, device="cpu")
    return jp, j_cast_floats(jp, jnp.bfloat16), tp, vt.cast_floats(tp, BF)


def test_cast_floats_matches_jax_bit_for_bit():
    """cast_floats casts every float leaf to bf16 as JAX's astype (round
    to nearest even), bit for bit, and leaves integer leaves alone; a leaf
    already bf16 is returned as it is (a second cast is free)."""
    jcfg, cfg = _cfgs()
    jp, jc, tp, tc = _both(jcfg, cfg)
    flat_t = dict(_flat(tc))
    n = 0
    for path, leaf in _flat(jax.device_get(jc)):
        got = flat_t[path]
        assert got.dtype == BF, path
        want = np.asarray(leaf).view(np.uint16)
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              want), path
        n += 1
    assert n == len(flat_t) > 20
    tree = {"a": torch.arange(3), "b": [torch.ones(2)], "c": torch.ones(2, dtype=BF)}
    out = vt.cast_floats(tree, BF)
    assert out["a"].dtype == torch.int64 and torch.equal(out["a"], tree["a"])
    assert out["b"][0].dtype == BF and out["c"] is tree["c"]


@pytest.mark.parametrize("multimodal", [True, False])
def test_prepare_decode_bf16_matches_jax(multimodal):
    """prepare_decode on cast params: ctx (bf16), s0 (bf16) and ctx_proj
    (fp32) within SCALE_TOL of the JAX package's (its XLA scans carry bf16
    states, the port's plain scan an fp32 carry as the Pallas kernel)."""
    jcfg, cfg = _cfgs(multimodal)
    _, jc, _, tc = _both(jcfg, cfg, seed=1)
    m16 = dataclasses.replace(jcfg.model, compute_dtype="bfloat16")
    batch = make_batch(jcfg, B=6, T=8, seed=3)
    js = jax_prepare_decode(jc, m16, batch)
    ts = vt.prepare_decode(tc, dataclasses.replace(cfg.model,
                                                   compute_dtype="bfloat16"),
                           {k: np.array(v) for k, v in batch.items()},
                           device="cpu")
    assert (ts.ctx.dtype, ts.s0.dtype, ts.ctx_proj.dtype) == (
        BF, BF, torch.float32)
    for name in ("ctx", "s0", "ctx_proj"):
        _scale_close(_np(getattr(ts, name)), _np(getattr(js, name)), SCALE_TOL,
                     name)


def _step_case(K=4, seed=5, multimodal=True):
    jcfg, cfg = _cfgs(multimodal)
    _, jc, _, tc = _both(jcfg, cfg, seed=seed, spread=2.0)
    jm = dataclasses.replace(jcfg.model, compute_dtype="bfloat16")
    m = dataclasses.replace(cfg.model, compute_dtype="bfloat16")
    batch = make_batch(jcfg, B=5, T=7, seed=seed)
    js = jax_prepare_decode(jc, jm, batch)
    ts = vt.prepare_decode(tc, m, {k: np.array(v) for k, v in batch.items()},
                           device="cpu")
    # the JAX state fed to both packages, so the step alone is compared
    ts = ts._replace(ctx=torch.from_numpy(_np(js.ctx)).to(BF),
                     ctx_proj=torch.from_numpy(_np(js.ctx_proj)),
                     s0=torch.from_numpy(_np(js.s0)).to(BF))
    rng = np.random.RandomState(seed)
    B, V, H = 5, m.tgt_vocab_size, m.dec_hidden_dim
    tok = rng.randint(4, V, (B, K)).astype(np.int32)
    s = (0.5 * rng.randn(B, K, H)).astype(np.float32)
    s16 = jnp.asarray(s).astype(jnp.bfloat16)
    scores = (-rng.rand(B, K) * 3).astype(np.float32)
    return jm, jc, js, m, tc, ts, tok, s16, scores


@pytest.mark.parametrize("structure", ["fused", "unfused"])
def test_one_beam_step_bf16_matches_jax(structure, monkeypatch):
    """One beam step on cast params, fused (the plain version of kernel
    1b) and unfused: the top-K values within SCALE_TOL of the JAX step's
    (the JAX fused step runs its Pallas readout in interpret mode on bf16
    t and W), the new states bf16 within STATE_ATOL, and the ids equal in
    every sentence whose JAX K-th and (K+1)-th candidates lie further
    apart than the tolerance."""
    monkeypatch.setenv("VAG_READOUT_TOPK", structure)
    jm, jc, js, m, tc, ts, tok, s16, scores = _step_case()
    K = tok.shape[1]
    fin = np.zeros(scores.shape, bool)
    ws, wv, wi = jax_step_topk(jc, jm, jnp.asarray(tok), s16, js,
                               jnp.asarray(scores), jnp.asarray(fin),
                               impl=structure)
    gs, gv, gi = decode_step_topk(tc, m, torch.from_numpy(tok).long(),
                                  torch.from_numpy(_np(s16)).to(BF), ts,
                                  torch.from_numpy(scores),
                                  torch.from_numpy(fin), impl=structure)
    assert gs.dtype == BF and gv.dtype == torch.float32
    assert float((gs.float() - torch.from_numpy(_np(ws))).abs().max()) <= STATE_ATOL
    scale = max(1.0, float(np.abs(np.asarray(wv)).max()))
    _scale_close(gv.numpy(), np.asarray(wv), SCALE_TOL, "top-K values")
    # the JAX candidates in full: scores + log-softmax of its logits
    _, logits = jax_decode_step(jc, jm, jnp.asarray(tok), s16, js)
    lg = np.asarray(logits, np.float64)
    lse = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1)) + lg.max(-1)
    cand = (scores[..., None] + lg - lse[..., None]).reshape(scores.shape[0], -1)
    srt = -np.sort(-cand, axis=1)
    clear = (srt[:, K - 1] - srt[:, K]) > SCALE_TOL * scale
    assert clear.sum() >= 3
    for b in np.nonzero(clear)[0]:
        assert sorted(gi[b].tolist()) == sorted(np.asarray(wi)[b].tolist()), b


@pytest.mark.parametrize("structure,dec_step", [
    ("fused", False), ("fused", True), ("unfused", False)])
def test_decode_params_widen_only_fp32_reads(structure, dec_step):
    """decode_params (once a decode): each bf16 decoder leaf a step reads
    only in fp32 widened to fp32, its bf16 value exactly; the embedding,
    the fused readout's W (kernel 1b), the fused step's matrices (kernel
    7b) and, outside it, the bf16 energies' ba and va stay bf16; a tabled
    beam step on the widened params gives the bf16 params' result bit for
    bit."""
    _, _, _, m, tc, ts, tok, s16, scores = _step_case()
    opts = DecodeOpts(structure=structure, dec_step=dec_step, attn_bf16=True,
                      readout_bf16=True)
    wide = decode_params(tc, m, opts, beam=True, tables=True)
    fused = structure == "fused"
    d = wide["decoder"]
    f32 = torch.float32
    assert d["embed"]["table"].dtype == BF
    assert d["readout"]["w_out"].dtype == (BF if fused else f32)
    for mod, k in (("gru1", "uh"), ("readout", "ws"), ("gru2", "wi")):
        assert d[mod][k].dtype == (BF if dec_step else f32), (mod, k)
    assert d["attn"]["va"].dtype == (f32 if dec_step else BF)
    assert d["readout"]["wy"].dtype == f32 and d["gru1"]["bh"].dtype == f32
    assert wide["encoder"] is tc["encoder"]
    for (path, a), (_, b) in zip(_flat(wide), _flat(tc)):
        assert torch.equal(a.float(), b.float()), path
    fin = torch.zeros(scores.shape, dtype=torch.bool)
    args = (torch.from_numpy(tok).long(), torch.from_numpy(_np(s16)).to(BF),
            ts, torch.from_numpy(scores), fin)
    want = decode_step_topk(tc, m, *args, impl="plain", opts=opts,
                            tables=tdec.decode_tables(tc["decoder"]))
    got = decode_step_topk(wide, m, *args, impl="plain", opts=opts,
                           tables=tdec.decode_tables(d))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert decode_params(tc, m, opts, beam=False, tables=True)["decoder"][
        "readout"]["w_out"].dtype == f32


def _readout_inputs(kind, R=40, E=32, V=700, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "integer":
        t, w = rng.randint(-3, 4, (R, E)), rng.randint(-3, 4, (E, V))
        b = rng.randint(-3, 4, V)
    else:
        t, w = np.tanh(rng.randn(R, E)), 0.1 * rng.randn(E, V)
        b = 0.1 * rng.randn(V)
    t16 = jnp.asarray(t, jnp.float32).astype(jnp.bfloat16)
    w16 = jnp.asarray(w, jnp.float32).astype(jnp.bfloat16)
    return t16, w16, jnp.asarray(b, jnp.float32)


@pytest.mark.parametrize("slots", [0, 1])
@pytest.mark.parametrize("kind", ["integer", "random"])
def test_readout_bf16_plain_matches_jax(kind, slots):
    """Kernel 1b's plain version (fused_readout_topk on bf16 t and W, fp32
    b; depth K, or slots 1 with the per-step recovery) against the JAX
    package's fused_readout_topk, impl="xla" and its Pallas kernel in
    interpret mode, on the same bf16 inputs: values within READOUT_RTOL,
    ids exact on integer inputs (every product and sum exact)."""
    B, K = 8, 5
    t, w, b = _readout_inputs(kind, R=B * K, seed=7 + slots)
    rng = np.random.RandomState(3)
    scores = (-rng.rand(B, K) * 2).astype(np.float32)
    fin = rng.rand(B, K) < 0.25
    tt = torch.from_numpy(_np(t)).to(BF)
    tw = torch.from_numpy(_np(w)).to(BF)
    gv, gi = rt.fused_readout_topk(tt, tw, torch.from_numpy(np.asarray(b)),
                                   torch.from_numpy(scores),
                                   torch.from_numpy(fin), slots=slots,
                                   impl="plain")
    for impl in ("xla", "pallas"):
        wv, wi = j_frt(t, w, b, jnp.asarray(scores), jnp.asarray(fin),
                       impl=impl, slots=slots)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv),
                                   rtol=READOUT_RTOL, atol=0, err_msg=impl)
        if kind == "integer":
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    rows = rt.readout_topk_rows_plain(tt, tw, torch.from_numpy(np.asarray(b)), K)
    assert rows[0].dtype == torch.float32 and rows[2].dtype == torch.float32


def test_readout_wrapper_dtype_rules():
    """bf16 t with bf16 W takes kernel 1b's route (here its plain version);
    an fp32 t with bf16 W is cast once (the decode's t); the kernel route
    on CPU tensors raises whatever the dtypes."""
    t, w, b = _readout_inputs("integer", R=10, seed=2)
    tt, tw = torch.from_numpy(_np(t)), torch.from_numpy(_np(w))
    tb = torch.from_numpy(np.asarray(b))
    scores, fin = torch.zeros(2, 5), torch.zeros(2, 5, dtype=torch.bool)
    a = rt.fused_readout_topk(tt.to(BF), tw.to(BF), tb, scores, fin)
    c = rt.fused_readout_topk(tt, tw.to(BF), tb, scores, fin)
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    with pytest.raises(ValueError, match="CUDA"):
        rt.readout_topk_rows(tt.to(BF), tw, tb, 5, impl="kernel")


def _dec_step_case(K, seed, B=6, T=7, V=50, E=12, He=10, H=16, A=8):
    kw = dict(tgt_vocab_size=V, emb_dim=E, hidden_dim=He, dec_hidden_dim=H,
              attn_dim=A, dropout=0.0)
    jp = jdec.init_decoder(jax.random.key(seed), JModelConfig(**kw))
    rng = np.random.RandomState(seed)
    for g in ("gru1", "gru2"):
        for bname in ("bi", "bh"):
            jp[g][bname] = jnp.asarray(0.1 * rng.randn(3 * H).astype(np.float32))
    jp["attn"]["ba"] = jnp.asarray(0.1 * rng.randn(A).astype(np.float32))
    jp["readout"]["b"] = jnp.asarray(0.1 * rng.randn(E).astype(np.float32))
    tok = rng.randint(0, V, (B, K)).astype(np.int32)
    s = jnp.asarray((0.3 * rng.randn(B, K, H)).astype(np.float32)).astype(
        jnp.bfloat16)
    ctx = jnp.asarray((0.3 * rng.randn(B, T, 2 * He)).astype(np.float32)).astype(
        jnp.bfloat16)
    lens = rng.randint(1, T + 1, B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    jc = j_cast_floats(jp, jnp.bfloat16)
    tc = vt.cast_floats(_to_torch(jax.device_get(jp)), BF)
    return ModelConfig(**kw), JModelConfig(**kw), jc, tc, tok, s, ctx, mask


@pytest.mark.parametrize("K", [1, 3, 5])
def test_dec_step_bf16_plain_matches_jax_kernel(K):
    """Kernel 7b's plain version (dec_step on bf16 s, ctx and matrices,
    fp32 gy, ctxpb, biases) against pallas_decode_step in interpret mode
    on cast params: the new states bf16 within STATE_ATOL, t fp32 within
    SCALE_TOL of its scale."""
    _, _, jc, tc, tok, s, ctx, mask = _dec_step_case(K, seed=40 + K)
    jt = jdec.decode_tables(jc)
    ctxp = j_ctx_proj(jc["attn"], ctx)
    ws, wt = pallas_decode_step(jc, jt, jnp.asarray(tok), s, ctx, ctxp,
                                jnp.asarray(mask))
    tt = tdec.decode_tables(tc)
    assert tt["gy"].dtype == torch.float32 and tt["w_s"].dtype == BF
    B, _, H = s.shape
    ctx_t = torch.from_numpy(_np(ctx)).to(BF)
    ctxpb = precompute_ctx_proj(tc["attn"], ctx_t) + tc["attn"]["ba"]
    gy = tt["gy"][torch.from_numpy(tok).long().reshape(-1)]
    weights = ds.step_weights(tc, tt)
    assert [w.dtype for w in weights] == [
        BF if n in ds.MATRICES else torch.float32 for n in ds.WEIGHTS]
    s_new, t = ds.dec_step(gy, torch.from_numpy(_np(s)).to(BF).reshape(B * K, H),
                           ctx_t, ctxpb, torch.from_numpy(mask), weights)
    assert s_new.dtype == BF and t.dtype == torch.float32
    err = float((s_new.float().reshape(B, K, H)
                 - torch.from_numpy(_np(ws))).abs().max())
    assert err <= STATE_ATOL, err
    _scale_close(t.numpy(), _np(wt), SCALE_TOL, "t")


@pytest.mark.parametrize("K", [1, 5])
def test_decoder_fused_step_bf16_matches_jax(K, monkeypatch):
    """decode_step_beams_readout with the fused step (VAG_DEC_STEP=on) on
    cast params against the JAX tabled step with its Pallas step: t in
    ctx's dtype (bf16) within SCALE_TOL, b_out fp32."""
    cfg, jcfg, jc, tc, tok, s, ctx, mask = _dec_step_case(K, seed=50 + K)
    monkeypatch.setenv("VAG_DEC_STEP", "on")
    jt = jdec.decode_tables(jc)
    ctxp = j_ctx_proj(jc["attn"], ctx)
    wout = jdec.decode_step_beams_readout(jc, jcfg, jnp.asarray(tok), s, ctx,
                                          ctxp, jnp.asarray(mask), jt)
    ctx_t = torch.from_numpy(_np(ctx)).to(BF)
    got = tdec.decode_step_beams_readout(
        tc, cfg, torch.from_numpy(tok).long(), torch.from_numpy(_np(s)).to(BF),
        ctx_t, precompute_ctx_proj(tc["attn"], ctx_t), torch.from_numpy(mask),
        tdec.decode_tables(tc))
    assert got[0].dtype == BF and got[1].dtype == BF
    assert got[2].dtype == BF and got[3].dtype == torch.float32
    assert float((got[0].float() - torch.from_numpy(_np(wout[0]))).abs().max()
                 ) <= STATE_ATOL
    _scale_close(_np(got[1]), _np(wout[1]), SCALE_TOL, "t")


@pytest.mark.parametrize("setting", ["fp32_in_bf16", "bf16_in_fp32"])
def test_attn_e_dtype_variable(setting, monkeypatch):
    """VAG_ATTN_E_DTYPE both ways, in both packages: "fp32" keeps a bf16
    decode's energies fp32, "bf16" takes bf16 energies in an fp32 decode
    (the port reads it once a decode, ``decode_opts``, and passes it to the
    attention); the port's attention as JAX's under the same setting (bf16
    energies: SCALE_TOL; fp32: 1e-5), and the setting moves it."""
    rng = np.random.RandomState(9)
    B, K, T, A, C = 4, 3, 6, 8, 12
    ctx_dt = jnp.bfloat16 if setting == "fp32_in_bf16" else jnp.float32
    params = {"ba": 0.1 * rng.randn(A), "va": rng.randn(A) / np.sqrt(A)}
    jp = {k: jnp.asarray(v, jnp.float32).astype(ctx_dt) for k, v in params.items()}
    tp = {k: torch.from_numpy(_np(v)).to(BF if ctx_dt == jnp.bfloat16
                                          else torch.float32)
          for k, v in jp.items()}
    q = jnp.asarray(rng.randn(B, K, A), jnp.float32)
    ctx = jnp.asarray(rng.randn(B, T, C), jnp.float32).astype(ctx_dt)
    cp = jnp.asarray(rng.randn(B, T, A), jnp.float32)
    mask = jnp.asarray((np.arange(T)[None] < np.array([6, 3, 1, 5])[:, None]),
                       jnp.float32)
    targs = [torch.from_numpy(_np(x)) for x in (q, ctx, cp, mask)]
    targs[1] = targs[1].to(BF if ctx_dt == jnp.bfloat16 else torch.float32)
    before = bahdanau_attend_beams_q(tp, *targs)
    env = "fp32" if setting == "fp32_in_bf16" else "bf16"
    monkeypatch.setenv("VAG_ATTN_E_DTYPE", env)
    opts = decode_opts(targs[1].dtype)
    assert opts.attn_bf16 == (env == "bf16")
    wc, ww = j_attend_q(jp, q, ctx, cp, mask)
    gc, gw = bahdanau_attend_beams_q(tp, *targs, bf16_energies=opts.attn_bf16)
    tol = 1e-5 if env == "fp32" else SCALE_TOL
    _scale_close(gw.numpy(), _np(ww), tol, "weights")
    _scale_close(_np(gc), _np(wc), max(tol, 8e-3), "context")
    assert not torch.equal(before[1], gw)


def test_frt_gemm_dtype_variable(monkeypatch):
    """VAG_FRT_GEMM_DTYPE=bf16 in an fp32 decode (read once a decode,
    ``decode_opts``): the fused readout top-K on W cast to bf16 once (the
    decode tables) rounds t to bf16 too, as the JAX package's
    fused_readout_topk under the same variable, exactly on inputs whose
    bf16 values multiply and sum exactly (small integers plus a fraction
    bf16 rounds away); without it the fraction moves the result."""
    B, K, E, V = 6, 4, 24, 300
    rng = np.random.RandomState(11)
    t = (rng.randint(-3, 4, (B * K, E)) + 1e-3 * rng.rand(B * K, E)).astype(
        np.float32)
    w = (rng.randint(-3, 4, (E, V)) + 1e-3 * rng.rand(E, V)).astype(np.float32)
    b = rng.randint(-3, 4, V).astype(np.float32)
    scores = np.zeros((B, K), np.float32)
    fin = np.zeros((B, K), bool)
    targs = [torch.from_numpy(x) for x in (t, w, b, scores, fin)]
    jargs = [jnp.asarray(x) for x in (t, w, b, scores, fin)]
    off = rt.fused_readout_topk(*targs, impl="plain")
    monkeypatch.setenv("VAG_FRT_GEMM_DTYPE", "bf16")
    assert decode_opts(torch.float32).readout_bf16
    got = rt.fused_readout_topk(targs[0], targs[1].to(BF), *targs[2:],
                                impl="plain")
    want = j_frt(*jargs, impl="xla")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the same candidates; their lse summed in another order
    _scale_close(got[0].numpy(), np.asarray(want[0]), READOUT_RTOL, "values")
    assert not torch.equal(off[0], got[0])
    # the tables carry W in bf16, cast once
    cfg = vt.preset("toy")
    params = vt.init_params(cfg.model, torch.Generator().manual_seed(0),
                            device="cpu")
    tables = tdec.decode_tables(params["decoder"], w_out_bf16=True)
    assert tables["w_out"].dtype == BF and tables["w_out"].is_contiguous()
    monkeypatch.delenv("VAG_FRT_GEMM_DTYPE")
    assert not decode_opts(torch.float32).readout_bf16
    assert "w_out" not in tdec.decode_tables(params["decoder"])


@pytest.mark.parametrize("path", ["chunked", "greedy", "bucketed"])
def test_translate_corpus_bf16_matches_jax(path):
    """translate_corpus with decode.compute_dtype="bfloat16" (params cast
    once a call) against the JAX package's on the same params and
    examples: at least MIN_SAME_HYPS of the hypotheses identical (the
    encoders' carries and the sums' orders differ; an untrained model has
    near-tied logits), every unit a vocab entry; and the bf16 decode is not
    the fp32 one."""
    jcfg, cfg = _cfgs(max_len_factor=1.5, max_len_offset=2)
    jp, _, tp, _ = _both(jcfg, cfg, seed=2)
    jexs, exs = jax_toy_examples(40, seed=6), make_toy_examples(40, seed=6)
    kw = dict(batch_size=8, beam_size=1 if path == "greedy" else 3)
    fused = path != "bucketed"
    want, _ = jax_translate(jp, jcfg, jexs, jax_toy_vocab(), fused=fused, **kw)
    got, st = vt.translate_corpus(tp, cfg, exs, toy_vocab(), fused=fused,
                                  device="cpu", **kw)
    same = sum(a == b for a, b in zip(got, want))
    assert same >= MIN_SAME_HYPS * len(exs), f"{same} of {len(exs)} identical"
    stoi = toy_vocab().stoi
    assert all(u in stoi for h in got for u in h.split())
    f32 = cfg.replace(decode=dict(compute_dtype="float32"))
    got32, _ = vt.translate_corpus(tp, f32, exs, toy_vocab(), fused=fused,
                                   device="cpu", **kw)
    assert got32 != got or path == "greedy"


def test_translator_casts_once_and_decodes_bf16(tmp_path):
    """Translator with decode.compute_dtype="bfloat16" casts its params to
    bf16 once, at construction, and its decode is translate_corpus's bf16
    decode of the same lines."""
    _, cfg = _cfgs()
    params = vt.init_params(cfg.model, torch.Generator().manual_seed(3),
                            device="cpu")
    vocab = toy_vocab()
    tr = vt.Translator(cfg, params, None, vocab, vocab, device="cpu")
    assert {x.dtype for _, x in _flat(tr.params)} == {BF}
    assert {x.dtype for _, x in _flat(params)} == {torch.float32}
    lines = [" ".join(vocab.itos[t] for t in ex.src)
             for ex in make_toy_examples(6, seed=1)]
    got = tr.translate(lines)
    assert len(got) == 6 and tr.last_stats
    f32 = vt.Translator(cfg.replace(decode=dict(compute_dtype="float32")),
                        params, None, vocab, vocab, device="cpu")
    assert f32.params is params


def test_fp32_products_unchanged_by_mm():
    """The fp32 path is unchanged: ``mm`` on fp32 operands is bit for bit
    the ``@`` it replaced in the decode modules, matrix by matrix and for
    the (B, K, T, A) energies by va (the fp32 goldens pin the rest)."""
    g = torch.Generator().manual_seed(0)
    for a_shape, b_shape in (((7, 16), (16, 48)), ((3, 5, 6, 8), (8,)),
                             ((40, 12), (12, 300))):
        a, b = torch.randn(a_shape, generator=g), torch.randn(b_shape, generator=g)
        assert torch.equal(mm(a, b), a @ b)
