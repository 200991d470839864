"""bf16 training through the port (compute_dtype="bfloat16"), on the CPU,
against the JAX package.

The reference trains in bf16: activations in bf16 where JAX puts them,
params, Adam and the clip in fp32, every matrix product bf16 x bf16 ->
fp32, and the recurrences on bf16 time streams with an fp32 carry
(``ops/pallas_gru.py``, ``ops/pallas_dec_scan.py``). The port's plain
versions of kernels 2-5 follow the Pallas kernels' rounding points, so
they are held against the Pallas kernels in interpret mode closely, and
against the JAX package's XLA scans (whose carries are bf16) within bf16
noise. R1 (the Pallas decoder scan's custom VJP fails under this JAX)
puts the decoder scan's gradients through the model and the train steps
against ``jax.grad`` of the XLA scan; its backward kernel itself is called
directly. Each test names its oracle and tolerance; inputs come from
numpy seeds at small sizes. The kernels' bf16 instances are held against
these plain versions on the card by chip_smoke.py (phase 8b)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import preset as jax_preset
from vag_nmt_tpu.data.batching import BucketBatcher as JBatcher
from vag_nmt_tpu.models import decoder as jdec
from vag_nmt_tpu.models import init_params as jax_init_params
from vag_nmt_tpu.models import loss_fn as jax_loss_fn
from vag_nmt_tpu.ops.gru import gru_scan as j_gru_scan
from vag_nmt_tpu.ops.gru import init_gru_params as j_init_gru
from vag_nmt_tpu.ops.pallas_dec_scan import pallas_decoder_scan
from vag_nmt_tpu.ops.pallas_gru import pallas_gru_scan
from vag_nmt_tpu.train.state import create_train_state
from vag_nmt_tpu.train.step import make_train_step as j_make_train_step

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch import cli
from vag_nmt_tpu_torch.data.batching import BucketBatcher
from vag_nmt_tpu_torch.data.datasets import make_toy_examples
from vag_nmt_tpu_torch.data.vocab import Vocab
from vag_nmt_tpu_torch.models import decoder as tdec
from vag_nmt_tpu_torch.ops import dec_scan as tds
from vag_nmt_tpu_torch.ops import gru_kernel as tgk
from vag_nmt_tpu_torch.ops.gru import gru_scan
from vag_nmt_tpu_torch.train.checkpoint import load_checkpoint
from vag_nmt_tpu_torch.train.state import (state_from_params, tree_leaves,
                                           tree_unflatten)

from tests.test_models import make_batch
from tests.test_torch_cli import write_data_dir
from tests.test_torch_params import _flat

torch.set_num_threads(1)

BF = torch.bfloat16
# Same rounding points as the Pallas kernel (interpret mode): the sums'
# order and the fp32 transcendentals differ, and a state that lands next
# to a bf16 rounding boundary rounds the other way: two bf16 ulps.
PALLAS_TOL = 8e-3
# Against an XLA oracle whose scan carry is bf16 (JAX's own test of its
# kernel against that oracle uses 5e-2).
XLA_TOL = 5e-2
# Gradients against other rounding points (bf16 carries, bf16 states saved
# for the recompute, fp32 streams), relative to the largest |grad|, as
# JAX's own bf16-stream gradient test.
GRAD_SCALE_TOL = 6e-2


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _gru_setup(B=8, T=12, E=16, H=32, seed=0):
    params = j_init_gru(jax.random.key(seed), E, H, "t")
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(B, T, E).astype(np.float32)).astype(jnp.bfloat16)
    lens = rng.randint(1, T + 1, B)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    h0 = (0.5 * rng.randn(B, H)).astype(np.float32)
    tparams = {k: _t(v) for k, v in params.items()}
    return params, x, jnp.asarray(mask), jnp.asarray(h0), tparams


def _close(a, b, tol, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol,
                               err_msg=what)


def _scale_close(a, b, tol, what=""):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    denom = max(1.0, float(np.abs(b).max()))
    assert np.abs(a - b).max() / denom < tol, (what, np.abs(a - b).max())


# -- kernel 2 (and 3): the GRU scan on bf16 streams --------------------------

@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_bf16_forward_matches_pallas(reverse):
    """gru_scan on a bf16 x (fp32 params, fp32 h0): states in bf16, against
    pallas_gru_scan in interpret mode (PALLAS_TOL) and the XLA scan with a
    bf16 carry (XLA_TOL)."""
    params, x, mask, h0, tp = _gru_setup()
    want, want_last = pallas_gru_scan(params, x, mask, h0, reverse=reverse)
    got, got_last = gru_scan(tp, _t(x, BF), _t(mask), _t(h0), reverse=reverse,
                             impl="plain")
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _close(got.float(), want, PALLAS_TOL)
    _close(got_last.float(), want_last, PALLAS_TOL)
    xla, _ = j_gru_scan(params, x, mask, h0.astype(jnp.bfloat16),
                        reverse=reverse, impl="xla")
    _close(got.float(), xla, XLA_TOL)


def _gru_loss(hs, hl):
    w = torch.arange(1, hs.shape[1] + 1, dtype=torch.float32)[None, :, None]
    return (hs.float() * w).sum() + 2.0 * (hl.float() ** 2).sum()


def _j_gru_loss(hs, hl):
    w = jnp.arange(1, hs.shape[1] + 1, dtype=jnp.float32)[None, :, None]
    return (hs.astype(jnp.float32) * w).sum() + \
        2.0 * (hl.astype(jnp.float32) ** 2).sum()


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_bf16_grads_match_pallas_vjp(reverse):
    """The bf16-stream backward (kernel 3's plain version) through autograd:
    grads of wi, bi, uh, bh and h0 against the Pallas custom VJP in
    interpret mode (GRAD_SCALE_TOL / 4: the same rounding points; a
    cotangent rounded to bf16 the other way moves a sum by an ulp of bf16),
    and against the fp32-stream grads (GRAD_SCALE_TOL)."""
    params, x, mask, h0, tp = _gru_setup(B=8, T=8, E=8, H=16)

    def jf(p, h):
        return _j_gru_loss(*pallas_gru_scan(p, x, mask, h, reverse=reverse))

    jg, jh0 = jax.grad(jf, argnums=(0, 1))(params, h0)
    jg32 = jax.grad(lambda p: _j_gru_loss(*pallas_gru_scan(
        p, x.astype(jnp.float32), mask, h0, reverse=reverse)))(params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    h = _t(h0).requires_grad_(True)
    _gru_loss(*gru_scan(leaves, _t(x, BF), _t(mask), h, reverse=reverse,
                        impl="plain")).backward()
    for k in ("wi", "bi", "uh", "bh"):
        _scale_close(leaves[k].grad, jg[k], GRAD_SCALE_TOL / 4, k)
        _scale_close(leaves[k].grad, jg32[k], GRAD_SCALE_TOL, k)
    _scale_close(h.grad, jh0, GRAD_SCALE_TOL / 4, "h0")


def test_gru_kernel_plain_versions_take_bf16_streams():
    """gru_fwd_plain / gru_bwd_plain on bf16 streams: hs_t and dxg_t in
    bf16, dUh, dbh, dh0 fp32; a step's hg is rbf(h) @ rbf(uh) + bh and its
    gate math takes the fp32 carry."""
    rng = np.random.RandomState(3)
    T, B, H = 5, 4, 8
    xg = torch.from_numpy(rng.randn(T, B, 3 * H).astype(np.float32)).to(BF)
    mask = torch.ones(T, B)
    uh = torch.from_numpy((0.3 * rng.randn(H, 3 * H)).astype(np.float32))
    bh = torch.from_numpy((0.1 * rng.randn(3 * H)).astype(np.float32))
    h0 = torch.from_numpy(rng.randn(B, H).astype(np.float32))
    hs = tgk.gru_fwd_plain(xg, mask, uh, bh, h0)
    assert hs.dtype == BF
    h1 = tgk.gru_gate_algebra(xg[0].float(), tgk.rbf(h0) @ tgk.rbf(uh) + bh, h0)
    assert torch.equal(hs[0], h1.to(BF))
    dxg, duh, dbh, dh0 = tgk.gru_bwd_plain(xg, mask, uh, bh, h0, hs,
                                           torch.ones(T, B, H, dtype=BF))
    assert dxg.dtype == BF and {duh.dtype, dbh.dtype, dh0.dtype} == {
        torch.float32}


# -- kernels 4 and 5: the decoder scan on bf16 streams -----------------------

def _dec_setup(B=8, Tt=6, T=5, seed=0, multimodal=False):
    upd = dict(compute_dtype="bfloat16", multimodal=multimodal)
    jcfg = jax_preset("toy").replace(model=upd)
    m = jcfg.model
    jp = jax_init_params(jax.random.key(seed), m)["decoder"]
    rng = np.random.RandomState(seed)
    leaves, tree = jax.tree.flatten(jp)
    leaves = [x if x.ndim > 1 else jnp.asarray(0.1 * rng.randn(*x.shape),
                                               jnp.float32) for x in leaves]
    jp = jax.tree.unflatten(tree, leaves)
    C, H, E = m.ctx_dim, m.dec_hidden_dim, m.emb_dim
    ctx = jnp.asarray(rng.randn(B, T, C).astype(np.float32)).astype(jnp.bfloat16)
    lens = rng.randint(2, T + 1, B)
    mask = jnp.asarray((np.arange(T)[None, :] < lens[:, None]).astype(np.float32))
    s0 = jnp.asarray((0.5 * rng.randn(B, H)).astype(np.float32)).astype(jnp.bfloat16)
    tgt_in = jnp.asarray(rng.randint(4, m.tgt_vocab_size, (B, Tt)).astype(np.int32))
    tp = jax.tree.map(lambda x: _t(x), jax.device_get(jp))
    return jcfg, jp, tp, ctx, mask, s0, tgt_in


def _scan_inputs(jp, ctx, mask, s0, tgt_in):
    y = jnp.take(jp["embed"]["table"], tgt_in, axis=0).astype(ctx.dtype)
    xg1 = jnp.dot(y, jp["gru1"]["wi"], preferred_element_type=jnp.float32) \
        + jp["gru1"]["bi"]
    ty = jnp.dot(y, jp["readout"]["wy"], preferred_element_type=jnp.float32)
    ctx_proj = jnp.dot(ctx, jp["attn"]["wa"], preferred_element_type=jnp.float32)
    return ty, xg1, s0, ctx, ctx_proj, mask


def test_decoder_scan_bf16_forward_matches_pallas():
    """decoder_scan (kernel 4's plain version) under bf16 streams against
    pallas_decoder_scan in interpret mode: t_all fp32 within PALLAS_TOL (the
    same rounding points: s, s~, c rounded for the products, the six
    matrices bf16)."""
    jcfg, jp, tp, ctx, mask, s0, tgt_in = _dec_setup()
    args = _scan_inputs(jp, ctx, mask, s0, tgt_in)
    want = pallas_decoder_scan(jp, *args)
    ty, xg1, s0_, ctx_, cp, m = (_t(a, BF if a.dtype == jnp.bfloat16 else
                                    torch.float32) for a in args)
    with torch.no_grad():
        got = tds.decoder_scan(tp, ty, xg1, s0_, ctx_, cp, m, impl="plain")
    assert got.dtype == torch.float32
    _close(got, want, PALLAS_TOL)


def test_decoder_scan_bf16_grads_match_xla_scan():
    """The bf16 decoder scan's grads (kernel 5's plain version on the
    replay's residuals, products on bf16-rounded operands, the matrices'
    grads rounded to bf16 once) against jax.grad of the JAX package's XLA
    teacher-forced scan at bf16, through teacher_forced_logits, for every
    decoder param and ctx: GRAD_SCALE_TOL of scale (R1 breaks the Pallas
    scan's custom VJP; its kernels are held directly in the next test)."""
    jcfg, jp, tp, ctx, mask, s0, tgt_in = _dec_setup()
    m = dataclasses.replace(jcfg.model, dec_scan_impl="xla", dropout=0.0)
    tm = vt.preset("toy").replace(model=dict(
        compute_dtype="bfloat16", multimodal=False, dropout=0.0)).model
    rng = np.random.RandomState(5)
    wts = rng.randn(*tgt_in.shape, m.tgt_vocab_size).astype(np.float32)

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
    assert c.grad.dtype == BF
    got = dict(_flat(tree_unflatten(tp, [x.grad for x in leaves])))
    for k, v in _flat(jg):
        _scale_close(got[k], v, GRAD_SCALE_TOL, k)
    _scale_close(c.grad.float(), jgc, GRAD_SCALE_TOL, "ctx")


def _time_major_case(Tt=6, B=8, T=5, H=32, A=16, C=24, R=20, seed=3):
    """Time-major decoder-scan inputs on bf16 streams, as
    pallas_decoder_scan hands them to its kernels (biases and va as (1, n)
    rows there, vectors in the port), and a readout cotangent."""
    rng = np.random.RandomState(seed)

    def f(*shape, scale=0.5):
        return (scale * rng.randn(*shape)).astype(np.float32)

    lens = rng.randint(2, T + 1, B)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    streams = dict(ty=f(Tt, B, R), xg=f(Tt, B, 3 * H), s0=f(B, H),
                   ctx=f(B, T, C), ctxp=f(B, T, A), mask=mask)
    weights = [f(H, 3 * H), f(3 * H), f(H, A), f(A), f(C, 3 * H), f(3 * H),
               f(H, 3 * H), f(3 * H), f(H, R), f(C, R)]
    return streams, weights, f(Tt, B, R, scale=1.0)


def test_decoder_scan_bf16_backward_matches_pallas_bwd():
    """Kernel 5's plain version on bf16 streams, through DecoderScan (the
    forward saves the bf16 states alone; the backward replays the steps
    from them, then runs dec_scan_bwd_plain) against the JAX Pallas
    kernels called directly in interpret mode: _fwd_call's bf16 states,
    then _bwd_call on them (the custom_vjp around them is what R1 breaks,
    not the kernels). Every cotangent within PALLAS_TOL of scale (the same
    rounding points; the bf16 grads one ulp apart where their fp32 sums
    round the other way). Fed the fp32 carry's residuals instead of the
    replay's, the port's grads miss that tolerance."""
    from vag_nmt_tpu.ops import pallas_dec_scan as jpd

    st, w, g = _time_major_case()
    names = ("ty", "xg", "s0", "ctx", "ctxp", "mask")
    jbf = {"xg", "ctx"}
    jargs = [jnp.asarray(st[n]).astype(jnp.bfloat16) if n in jbf
             else jnp.asarray(st[n]) for n in names]
    for name, x in zip(tds.WEIGHTS, w):
        jargs.append(jnp.asarray(x).astype(jnp.bfloat16)
                     if name in tds.MATRICES else jnp.asarray(x)[None, :])
    jt, js = jpd._fwd_call(*jargs)
    assert js.dtype == jnp.bfloat16
    want = jpd._bwd_call(tuple(jargs) + (js,), jnp.asarray(g))
    want = want[:5] + want[6:]                   # no cotangent of the mask

    targs = [_t(st[n], BF if n in jbf else torch.float32).requires_grad_(
        n != "mask") for n in names]
    tw = [_t(x, BF if n in tds.MATRICES else torch.float32).requires_grad_(True)
          for n, x in zip(tds.WEIGHTS, w)]
    t_t = tds.DecoderScan.apply("plain", *targs, *tw)
    _close(t_t.detach(), jt, PALLAS_TOL, "t")
    t_t.backward(_t(g))
    got = [a.grad for a in targs if a.requires_grad] + [x.grad for x in tw]
    labels = ("dty", "dxg", "ds0", "dctx", "dctxp") + tuple(
        "d" + n for n in tds.WEIGHTS)
    for k, a, b in zip(labels, got, want):
        assert a.dtype == _t(np.zeros(1), BF if b.dtype == jnp.bfloat16
                             else torch.float32).dtype, k
        _scale_close(a.float(), np.asarray(b, np.float32), PALLAS_TOL, k)

    # the backward on the fp32 carry's residuals (not the JAX numerics)
    # misses the tolerance: the test sees the difference
    with torch.no_grad():
        res = tds.dec_scan_fwd_plain(*targs, tw)
        carry = tds.dec_scan_bwd_plain(res, targs[1], targs[3], targs[4],
                                       targs[5], tw, _t(g))
    errs = [float((a.float() - torch.tensor(np.asarray(b, np.float32))
                   ).abs().max()) / max(1.0, float(np.abs(np.asarray(
                       b, np.float32)).max())) for a, b in zip(carry, want)]
    assert max(errs) > PALLAS_TOL, errs


def test_decoder_scan_bf16_kernel_route_checks_dtypes(monkeypatch):
    """The kernel route takes the bf16 streams (xg_t, ctx and the six
    matrices bf16, the rest fp32) to the argument check, which raises on
    CPU tensors (the kernels have no CPU mode); impl="plain" returns the
    readout in fp32."""
    monkeypatch.setattr(tds, "resolve_impl",
                        lambda impl, x: "plain" if impl == "plain" else "kernel")
    Tt, B, T, H, A, C, R = 2, 3, 4, 8, 8, 16, 8
    f = torch.float32
    w = [torch.zeros(s, dtype=BF if n in tds.MATRICES else f) for n, s in zip(
        tds.WEIGHTS, [(H, 3 * H), (3 * H,), (H, A), (A,), (C, 3 * H), (3 * H,),
                      (H, 3 * H), (3 * H,), (H, R), (C, R)])]
    args = (torch.zeros(Tt, B, R), torch.zeros(Tt, B, 3 * H, dtype=BF),
            torch.zeros(B, H), torch.zeros(B, T, C, dtype=BF),
            torch.zeros(B, T, A), torch.ones(B, T))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tds.dec_scan_fwd(*args, w)
    out = tds.dec_scan_fwd(*args, w, impl="plain")
    assert out["t"].dtype == f


def test_bf16_plans_hold_the_slices_in_half_the_floats():
    """The bf16 instances' plans (dec_scan_plan / gru_bwd_plan with
    bf16=True): every product's weight slice takes half the floats of the
    fp32 plan's, so widths whose fp32 slices spill to L2 on the H100 (132
    SMs, 227 KB) stay resident: the decoder at H = A = 1024, C = 2048 and
    the GRU backward at H = 1536 and 2048."""
    from vag_nmt_tpu_torch.ops.scan_tiles import ScanProduct

    args = (1024, 1024, 2048, 512, 132, 232448)
    p32 = tds.dec_scan_plan(64, 24, *args)
    p16 = tds.dec_scan_plan(64, 24, *args, bf16=True)
    assert p32.fwd.l2_floats > 0 and p32.bwd.l2_floats > 0
    assert p16.fwd.l2_floats == p16.bwd.l2_floats == 0
    assert all(q.bf16 for q in p16.fwd.products + p16.bwd.products)
    for H in (1536, 2048):
        assert tgk.gru_bwd_plan(64, H, 132, 232448).l2_floats > 0
        assert tgk.gru_bwd_plan(64, H, 132, 232448, bf16=True).l2_floats == 0
    q = ScanProduct("x", 64, 100, 96, 32, 0, 24, 32, 1, 4, 4)
    q16 = ScanProduct("x", 64, 100, 96, 32, 0, 24, 32, 1, 4, 4, bf16=True)
    assert 2 * q16.slice_floats == q.slice_floats == 112 * 24


# -- the slice as a whole ----------------------------------------------------

def _bf16_cfgs(**model):
    upd = dict(compute_dtype="bfloat16", dropout=0.0, **model)
    return jax_preset("toy").replace(model=upd), vt.preset("toy").replace(
        model=upd)


@pytest.mark.parametrize("multimodal", [True, False])
def test_bf16_loss_matches_jax(multimodal):
    """The port's bf16 loss_fn (plain versions) against JAX's at the same
    params: against the Pallas kernels in interpret mode (the same rounding
    points; the loss and its aux within 1e-4 absolute), and against the
    XLA scans (bf16 carries) within 5e-3."""
    jcfg, cfg = _bf16_cfgs(multimodal=multimodal)
    jp = jax_init_params(jax.random.key(0), jcfg.model)
    tp = vt.params_from_numpy(jax.device_get(jp), cfg.model, device="cpu")
    batch = dict(make_batch(jcfg, B=6, T=6, Tt=7, seed=2))
    got, aux = vt.loss_fn(tp, cfg.model, {k: torch.as_tensor(np.array(v))
                                          for k, v in batch.items()},
                          None, train=False)
    for impl, tol in (("pallas", 1e-4), ("xla", 5e-3)):
        m = dataclasses.replace(jcfg.model, gru_impl=impl, dec_scan_impl=impl)
        want, jaux = jax_loss_fn(jp, m, batch, None, train=False)
        np.testing.assert_allclose(float(got), float(want), atol=tol,
                                   err_msg=impl)
        for k in jaux:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                       atol=tol, err_msg=f"{impl} {k}")


def _toy_steps(cfg, jcfg, n):
    """n train steps of both packages from the same params and batches:
    (port losses, JAX losses, port params, JAX params)."""
    jstate = create_train_state(jax.random.key(cfg.train.seed), jcfg)
    state = state_from_params(cfg, vt.params_from_numpy(
        jax.device_get(jstate.params), cfg.model, device="cpu"))
    exs = make_toy_examples(48, seed=11, img_dim=cfg.model.img_feat_dim)
    batches = list(BucketBatcher(exs, cfg.data.batch_size,
                                 cfg.data.length_buckets, seed=3,
                                 include_image=cfg.model.multimodal,
                                 img_dim=cfg.model.img_feat_dim).epoch(0))
    jbatches = list(JBatcher(exs, jcfg.data.batch_size,
                             jcfg.data.length_buckets, seed=3,
                             include_image=jcfg.model.multimodal,
                             img_dim=jcfg.model.img_feat_dim).epoch(0))
    step = vt.make_train_step(cfg)
    jstep, _ = j_make_train_step(jcfg)
    rng = jax.random.key(1)
    got, want = [], []
    for i in range(n):
        state, aux = step(state, batches[i % len(batches)])
        jstate, jaux = jstep(jstate, jbatches[i % len(jbatches)], rng)
        got.append(float(aux["loss"]))
        want.append(float(jaux["loss"]))
    return got, want, state.params, jax.device_get(jstate.params)


def test_five_bf16_train_steps_match_jax():
    """Five bf16 train steps of the port (plain versions) against the JAX
    package's jitted step (XLA scans: R1) from the same params and batches:
    each step's loss within 2e-3 (the XLA scans' bf16 carries against the
    Pallas kernels' fp32 ones; measured 3.5e-4) and the params after five
    Adam steps within 5 lr of each other (an update moves a param by at
    most ~lr: the two runs' updates may differ in sign only where a grad
    is near 0)."""
    jcfg, cfg = _bf16_cfgs(gru_impl="xla", dec_scan_impl="xla")
    got, want, tparams, jparams = _toy_steps(cfg, jcfg, 5)
    np.testing.assert_allclose(got, want, atol=2e-3)
    lr = cfg.train.learning_rate
    ft = dict(_flat(tparams))
    for k, v in _flat(jparams):
        assert np.abs(ft[k].numpy() - np.asarray(v)).max() <= 5 * lr + 1e-6, k


def test_bf16_training_converges():
    """A bf16 toy run of 30 steps through the port's train step: the loss
    is finite and falls (as tests/test_train.py's JAX bf16 run), and the
    params stay fp32."""
    cfg = vt.preset("toy").replace(model=dict(compute_dtype="bfloat16"))
    state = vt.create_train_state(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    exs = make_toy_examples(64, seed=11, img_dim=cfg.model.img_feat_dim)
    batcher = BucketBatcher(exs, cfg.data.batch_size, cfg.data.length_buckets,
                            seed=0, include_image=cfg.model.multimodal,
                            img_dim=cfg.model.img_feat_dim)
    step = vt.make_train_step(cfg)
    losses, epoch = [], 0
    while len(losses) < 30:
        for b in batcher.epoch(epoch):
            state, aux = step(state, b)
            losses.append(float(aux["loss"]))
            if len(losses) == 30:
                break
        epoch += 1
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert {x.dtype for x in tree_leaves(state.params)} == {torch.float32}


def test_gru_stream_fp32_knob(monkeypatch):
    """VAG_GRU_STREAM=fp32 under bf16 compute: the scans run on fp32 streams
    (the fp32 kernels' plain versions), so gru_scan equals the fp32 scan of
    the same (bf16-valued) x cast to bf16 at the end, bit for bit, and the
    decoder scan equals the fp32 scan on ctx cast up; both as JAX's Pallas
    kernels with the same variable (PALLAS_TOL)."""
    params, x, mask, h0, tp = _gru_setup()
    monkeypatch.setenv("VAG_GRU_STREAM", "fp32")
    got, _ = gru_scan(tp, _t(x, BF), _t(mask), _t(h0), impl="plain")
    ref, _ = gru_scan(tp, _t(x), _t(mask), _t(h0), impl="plain")
    assert got.dtype == BF and torch.equal(got, ref.to(BF))
    want, _ = pallas_gru_scan(params, x, mask, h0)
    _close(got.float(), want, PALLAS_TOL)
    jcfg, jp, tpd, ctx, dmask, s0, tgt_in = _dec_setup()
    args = _scan_inputs(jp, ctx, dmask, s0, tgt_in)
    ty, xg1, s0_, ctx_, cp, m = (_t(a) for a in args)
    with torch.no_grad():
        a = tds.decoder_scan(tpd, ty, xg1, s0_, ctx_.to(BF), cp, m, impl="plain")
        b = tds.decoder_scan(tpd, ty, xg1, s0_, ctx_, cp, m, impl="plain")
    assert torch.equal(a, b)
    _close(a, pallas_decoder_scan(jp, *args), PALLAS_TOL)


def test_cli_trains_bf16_then_translates_at_fp32(tmp_path, capsys):
    """``train --set model.compute_dtype=bfloat16`` on a data directory (the
    run records the dtype), then ``translate`` of that run: it decodes at
    fp32 (decode.compute_dtype's default), and with ``--set
    decode.compute_dtype=bfloat16`` in bf16, its output well formed (every
    unit a vocab entry, as JAX tests/test_translate.py's bf16 decode)."""
    data, run = str(tmp_path / "data"), str(tmp_path / "run")
    os.makedirs(data)
    write_data_dir(data)
    cli.main(["train", "--preset", "toy", "--data-dir", data, "--out-dir", run,
              "--max-steps", "3", "--set", "train.eval_every_steps=0",
              "--set", "model.compute_dtype=bfloat16", "--device", "cpu"])
    with open(os.path.join(run, "config.json")) as f:
        assert json.load(f)["model"]["compute_dtype"] == "bfloat16"
    state, meta = load_checkpoint(os.path.join(run, "checkpoints"), "last",
                                  device="cpu")
    assert state.step == 3 and meta["compute_dtype"] == "bfloat16"
    assert {x.dtype for x in tree_leaves(state.params)} == {torch.float32}
    hyp = tmp_path / "hyp.txt"
    capsys.readouterr()
    cli.main(["translate", "--data-dir", data, "--checkpoint", run, "--tag",
              "last", "--split", "test", "--output", str(hyp), "--device",
              "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["sentences"] == 12 and len(hyp.read_text().splitlines()) == 12
    hyp16 = tmp_path / "hyp16.txt"
    cli.main(["translate", "--data-dir", data, "--checkpoint", run,
              "--tag", "last", "--split", "test", "--output", str(hyp16),
              "--set", "decode.compute_dtype=bfloat16", "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    lines = hyp16.read_text().splitlines()
    assert stats["sentences"] == 12 and len(lines) == 12
    stoi = Vocab.load(os.path.join(data, "vocab.de.json")).stoi
    for line in lines:
        for u in line.split():
            assert u in stoi, u
