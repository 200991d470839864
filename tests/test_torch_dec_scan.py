"""PyTorch port, the training-side recurrences against the JAX package: the
GRU backward (through GRUScan, against jax.grad of the XLA scan and of the
Pallas scan in interpret mode) and the teacher-forced decoder scan (forward
against the Pallas kernel in interpret mode and the XLA scan; backward
against jax.grad through the XLA scan, every input and weight grad,
including ba and b through the bias folding). Inputs are made with numpy
from a seed and handed to both. All on the CPU, where the port's wrappers
run their plain versions; the CUDA kernels are held against the same plain
versions on the card by chip_smoke.py.

Tolerance: 1e-5 absolute for float outputs (fp32, sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import ModelConfig
from vag_nmt_tpu.models import decoder as jdec
from vag_nmt_tpu.ops import gru as jgru
from vag_nmt_tpu.ops.attention import precompute_ctx_proj as j_ctx_proj
from vag_nmt_tpu.ops.pallas_dec_scan import pallas_decoder_scan
from vag_nmt_tpu.ops.pallas_gru import pallas_gru_scan

from vag_nmt_tpu_torch.models import decoder as dec
from vag_nmt_tpu_torch.ops import gru
from vag_nmt_tpu_torch.ops.dec_scan import (
    RESIDUALS,
    decoder_scan,
    dec_scan_bwd,
    dec_scan_fwd,
    dec_scan_fwd_plain,
    scan_weights,
)
from vag_nmt_tpu_torch.ops.gru_kernel import gru_bwd_plain, gru_fwd_plain

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ATOL = 1e-5


def T(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=what)


# --- GRU backward ----------------------------------------------------------

def _gru_case(B=5, T_=7, E=12, H=16, seed=0):
    rng = np.random.RandomState(seed)
    p = {"wi": rng.randn(E, 3 * H) * 0.3, "bi": rng.randn(3 * H) * 0.1,
         "uh": rng.randn(H, 3 * H) * 0.3, "bh": rng.randn(3 * H) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.randn(B, T_, E).astype(np.float32)
    lens = np.array([T_, 1, 3, T_ - 1, 4][:B])
    mask = (np.arange(T_)[None, :] < lens[:, None]).astype(np.float32)
    h0 = (0.5 * rng.randn(B, H)).astype(np.float32)
    g = rng.randn(B, T_, H).astype(np.float32)
    g_last = rng.randn(B, H).astype(np.float32)
    return p, x, mask, h0, g, g_last


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_backward_matches_jax_grad(reverse, jax_impl):
    """GRUScan's gradients (dxg through wi/bi/x, duh, dbh, dh0) equal
    jax.grad of the JAX scan: states and final state both carry a
    cotangent, lengths are ragged and h0 is nonzero."""
    p, x, mask, h0, g, g_last = _gru_case()

    def jloss(params, x, h0):
        if jax_impl == "xla":
            hs, hl = jgru.gru_scan(params, x, jnp.asarray(mask), h0,
                                   reverse=reverse, impl="xla")
        else:
            hs, hl = pallas_gru_scan(params, x, jnp.asarray(mask), h0,
                                     reverse=reverse)
        return (hs * g).sum() + (hl * g_last).sum()

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(x),
                                              jnp.asarray(h0))
    tp = {k: T(v).requires_grad_(True) for k, v in p.items()}
    tx, th0 = T(x).requires_grad_(True), T(h0).requires_grad_(True)
    hs, hl = gru.gru_scan(tp, tx, T(mask), th0, reverse=reverse, impl="plain")
    ((hs * T(g)).sum() + (hl * T(g_last)).sum()).backward()
    for k in p:
        _close(tp[k].grad, want[0][k], what=k)
    _close(tx.grad, want[1], what="x")
    _close(th0.grad, want[2], what="h0")


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_bwd_plain_matches_pallas_vjp(reverse):
    """gru_bwd_plain's (dxg, duh, dbh, dh0) equal the custom VJP of the
    JAX Pallas scan (interpret mode) on the same time-major inputs."""
    from vag_nmt_tpu.ops.pallas_gru import _scan

    p, x, mask, h0, g, _ = _gru_case(seed=3)
    xg_t = np.einsum("bte,eg->tbg", x, p["wi"]) + p["bi"]
    mask_t = mask.T.copy()
    g_t = g.transpose(1, 0, 2).copy()
    hs_t, vjp = jax.vjp(
        lambda xg, uh, bh, h: _scan(xg, jnp.asarray(mask_t)[..., None], uh,
                                    bh, h, reverse),
        jnp.asarray(xg_t), jnp.asarray(p["uh"]), jnp.asarray(p["bh"]),
        jnp.asarray(h0))
    want = vjp(jnp.asarray(g_t))
    got = gru_bwd_plain(T(xg_t), T(mask_t), T(p["uh"]), T(p["bh"]), T(h0),
                        T(np.asarray(hs_t)), T(g_t), reverse=reverse)
    for name, a, b in zip(("dxg", "duh", "dbh", "dh0"), got,
                          (want[0], want[1], want[2], want[3])):
        _close(a, b, what=name)


def test_gru_backward_sends_masked_steps_to_the_carry():
    """At a masked step dxg is exactly 0 and the carry passes through."""
    p, x, mask, h0, g, _ = _gru_case(seed=1)
    xg_t = torch.einsum("bte,eg->tbg", T(x), T(p["wi"])) + T(p["bi"])
    mask_t = T(mask).T.contiguous()
    hs_t = gru_fwd_plain(xg_t, mask_t, T(p["uh"]), T(p["bh"]), T(h0))
    dxg, _, _, dh0 = gru_bwd_plain(xg_t, mask_t, T(p["uh"]), T(p["bh"]),
                                   T(h0), hs_t, T(g).transpose(0, 1))
    assert float(dxg[mask_t == 0].abs().max()) == 0.0
    # row 1 has one real step: its dh0 is the sum of the cotangents of the
    # carried steps plus that step's contribution, never dropped
    assert float(dh0.abs().sum()) > 0.0


def test_gru_scan_without_grad_skips_the_function():
    p, x, mask, h0, _, _ = _gru_case(seed=2)
    tp = {k: T(v) for k, v in p.items()}
    with torch.no_grad():
        hs, _ = gru.gru_scan(tp, T(x), T(mask), T(h0))
    hs2, _ = gru.gru_scan(tp, T(x), T(mask), T(h0))
    assert hs.grad_fn is None and torch.equal(hs, hs2.detach())


# --- decoder scan ----------------------------------------------------------

def _dec_setup(B=4, Tt=8, T_=5, V=50, E=12, He=10, H=16, A=8, seed=0):
    cfg = ModelConfig(tgt_vocab_size=V, emb_dim=E, hidden_dim=He,
                      dec_hidden_dim=H, attn_dim=A, dropout=0.0,
                      dec_scan_impl="xla")
    params = jdec.init_decoder(jax.random.key(seed), cfg)
    rng = np.random.RandomState(seed)
    leaves, tree = jax.tree.flatten(params)
    leaves = [x if x.ndim > 1 else jnp.asarray(0.1 * rng.randn(*x.shape),
                                               jnp.float32) for x in leaves]
    params = jax.tree.unflatten(tree, leaves)
    C = 2 * He
    inputs = {
        "ty": rng.randn(B, Tt, E) * 0.5, "xg1": rng.randn(B, Tt, 3 * H) * 0.5,
        "s0": rng.randn(B, H) * 0.5, "ctx": rng.randn(B, T_, C) * 0.5,
    }
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    lens = np.array([T_, 1, 3, 2][:B])
    inputs["src_mask"] = (np.arange(T_)[None] < lens[:, None]).astype(np.float32)
    inputs["ctx_proj"] = np.asarray(j_ctx_proj(params["attn"],
                                               jnp.asarray(inputs["ctx"])))
    return cfg, params, inputs


def _torch_tree(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, grad) for k, v in tree.items()}
    return T(tree).requires_grad_(grad)


def _jax_xla_scan(params, ty, xg1, s0, ctx, ctx_proj, src_mask):
    """The XLA scan of teacher_forced_logits(dec_scan_impl="xla"), before
    the readout dropout and the vocab GEMM."""
    def step(s, inp):
        ty_t, xg_t = inp
        s_new, t, _ = jdec.step_acts_from_xgates(params, ty_t, xg_t, s, ctx,
                                                 ctx_proj, src_mask)
        return s_new, t

    _, t_all = jax.lax.scan(step, s0, (jnp.swapaxes(ty, 0, 1),
                                       jnp.swapaxes(xg1, 0, 1)))
    return jnp.swapaxes(t_all, 0, 1)


def _order(d):
    return [d[k] for k in ("ty", "xg1", "s0", "ctx", "ctx_proj", "src_mask")]


def test_dec_scan_forward_matches_pallas_and_xla():
    cfg, params, inp = _dec_setup()
    jin = [jnp.asarray(x) for x in _order(inp)]
    want_p = pallas_decoder_scan(params, *jin)
    want_x = _jax_xla_scan(params, *jin)
    got = decoder_scan(_torch_tree(params), *[T(x) for x in _order(inp)],
                       impl="plain")
    _close(got, want_p, what="pallas")
    _close(got, want_x, what="xla")


def test_step_acts_from_xgates_matches_jax():
    cfg, params, inp = _dec_setup(seed=1)
    want = jdec.step_acts_from_xgates(
        params, jnp.asarray(inp["ty"][:, 0]), jnp.asarray(inp["xg1"][:, 0]),
        jnp.asarray(inp["s0"]), jnp.asarray(inp["ctx"]),
        jnp.asarray(inp["ctx_proj"]), jnp.asarray(inp["src_mask"]))
    got = dec.step_acts_from_xgates(
        _torch_tree(params), T(inp["ty"][:, 0]), T(inp["xg1"][:, 0]),
        T(inp["s0"]), T(inp["ctx"]), T(inp["ctx_proj"]), T(inp["src_mask"]))
    for a, b in zip(got, want):
        _close(a, b)


def test_dec_scan_backward_matches_jax_grad():
    """Every input grad and every weight grad of the scan, ba and b through
    the folding included, against jax.grad through the XLA scan."""
    cfg, params, inp = _dec_setup(seed=2)
    g = np.random.RandomState(3).randn(*inp["ty"].shape[:2], params[
        "readout"]["wy"].shape[1]).astype(np.float32)

    def jloss(params, ty, xg1, s0, ctx, ctx_proj):
        t_all = _jax_xla_scan(params, ty, xg1, s0, ctx, ctx_proj,
                              jnp.asarray(inp["src_mask"]))
        return (t_all * g).sum()

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        params, *[jnp.asarray(x) for x in _order(inp)[:5]])
    tp = _torch_tree(params, grad=True)
    tin = [T(x).requires_grad_(True) for x in _order(inp)[:5]]
    t_all = decoder_scan(tp, *tin, T(inp["src_mask"]), impl="plain")
    (t_all * T(g)).sum().backward()
    for name, a, b in zip(("ty", "xg1", "s0", "ctx", "ctx_proj"), tin,
                          want[1:]):
        _close(a.grad, b, what=name)
    used = {"gru1": ("uh", "bh"), "attn": ("ua", "ba", "va"),
            "gru2": ("wi", "bi", "uh", "bh"), "readout": ("ws", "wc", "b")}
    for grp, keys in used.items():
        for k in keys:
            _close(tp[grp][k].grad, want[0][grp][k], what=f"{grp}/{k}")


def test_dec_scan_residuals_and_wrapper_agree():
    """dec_scan_fwd returns the readout and every residual the backward
    needs; its impl="auto" on CPU tensors is the plain version; without
    grad decoder_scan skips the Function."""
    cfg, params, inp = _dec_setup(seed=4)
    tp = _torch_tree(params)
    weights = scan_weights(tp)
    ty_t = T(inp["ty"]).transpose(0, 1).contiguous() + tp["readout"]["b"]
    xg_t = T(inp["xg1"]).transpose(0, 1).contiguous()
    ctxp = T(inp["ctx_proj"]) + tp["attn"]["ba"]
    args = (ty_t, xg_t, T(inp["s0"]), T(inp["ctx"]), ctxp, T(inp["src_mask"]))
    res = dec_scan_fwd(*args, weights)
    assert sorted(res) == sorted(RESIDUALS)
    ref = dec_scan_fwd_plain(*args, weights)
    for k in RESIDUALS:
        assert torch.equal(res[k], ref[k]), k
    assert torch.equal(res["s"][0], T(inp["s0"]))
    with torch.no_grad():
        t_ng = decoder_scan(tp, *[T(x) for x in _order(inp)])
    assert t_ng.grad_fn is None
    _close(t_ng, res["t"].transpose(0, 1))
    grads = dec_scan_bwd(res, xg_t, T(inp["ctx"]), ctxp, T(inp["src_mask"]),
                         weights, torch.ones_like(ty_t))
    assert len(grads) == 15
    # masked source positions get no dctx_proj
    assert float(grads[4][T(inp["src_mask"]) == 0].abs().max()) == 0.0


@pytest.mark.parametrize("tied", [False, True])
def test_teacher_forced_logits_matches_jax(tied):
    cfg, params, inp = _dec_setup(seed=5)
    cfg = ModelConfig(**{**cfg.__dict__, "tied_readout_embedding": tied})
    params = jdec.init_decoder(jax.random.key(5), cfg)
    rng = np.random.RandomState(6)
    B, Tt = inp["ty"].shape[:2]
    tgt_in = rng.randint(0, cfg.tgt_vocab_size, (B, Tt)).astype(np.int32)
    want = jdec.teacher_forced_logits(params, cfg, jnp.asarray(tgt_in),
                                      jnp.asarray(inp["s0"]),
                                      jnp.asarray(inp["ctx"]),
                                      jnp.asarray(inp["src_mask"]))
    got = dec.teacher_forced_logits(_torch_tree(params), cfg,
                                    T(tgt_in).long(), T(inp["s0"]),
                                    T(inp["ctx"]), T(inp["src_mask"]))
    _close(got, want)
