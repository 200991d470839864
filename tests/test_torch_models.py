"""PyTorch port models against the JAX package at the toy preset: encoder
(1 and 2 layers), image embedding and grounding, prepare_decode, decode
tables, and the beam decoder steps tabled and untabled. The same JAX
parameters go to both sides through the weight bridge; inputs come from
numpy. Float outputs agree to 1e-5 absolute (fp32, sums in another
order); token ids exactly. All on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import preset as jax_preset
from vag_nmt_tpu.models import decoder as jdec
from vag_nmt_tpu.models import encoder as jenc
from vag_nmt_tpu.models import init_params as jax_init_params
from vag_nmt_tpu.models import model as jmodel
from vag_nmt_tpu.models import vse as jvse

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.models import decoder as dec
from vag_nmt_tpu_torch.models import encoder as enc
from vag_nmt_tpu_torch.models import model as tmodel
from vag_nmt_tpu_torch.models import vse

from tests.test_models import make_batch

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _setup(**model_updates):
    jcfg = jax_preset("toy").replace(model=dict(model_updates))
    cfg = vt.preset("toy").replace(model=dict(model_updates))
    jp = jax_init_params(jax.random.key(0), jcfg.model)
    # non-zero biases so every bias term is exercised
    leaves, tree = jax.tree.flatten(jp)
    rng = np.random.RandomState(0)
    leaves = [x if x.ndim > 1 else jnp.asarray(0.1 * rng.randn(*x.shape),
                                               jnp.float32)
              for x in leaves]
    jp = jax.tree.unflatten(tree, leaves)
    tp = vt.params_from_numpy(jax.device_get(jp), cfg.model, device="cpu")
    batch = make_batch(jcfg, B=4, T=6, seed=1)
    tbatch = {k: np.array(v) for k, v in batch.items()}
    return jcfg.model, jp, cfg.model, tp, batch, tbatch


@pytest.fixture(scope="module")
def toy():
    return _setup()


@pytest.mark.parametrize("layers", [1, 2])
def test_encode_matches_jax(layers):
    jm, jp, m, tp, batch, tb = _setup(enc_layers=layers)
    want = jenc.encode(jp["encoder"], jm, batch["src"], batch["src_mask"])
    got = enc.encode(tp["encoder"], m, torch.as_tensor(tb["src"]).long(),
                     torch.as_tensor(tb["src_mask"]))
    assert got.shape == (4, 6, 2 * m.hidden_dim)
    _close(got, want)


def test_image_embedding_and_ground_match_jax(toy):
    jm, jp, m, tp, batch, tb = toy
    ctx_j = jenc.encode(jp["encoder"], jm, batch["src"], batch["src_mask"])
    img_j = jvse.image_embedding(jp["vse"], batch["img"])
    txt_j, tvec_j, beta_j = jvse.ground(jp["vse"], img_j, ctx_j,
                                        batch["src_mask"])
    ctx = torch.as_tensor(np.array(ctx_j))
    img = vse.image_embedding(tp["vse"], torch.as_tensor(tb["img"]))
    txt, tvec, beta = vse.ground(tp["vse"], img, ctx,
                                 torch.as_tensor(tb["src_mask"]))
    for a, b in ((img, img_j), (txt, txt_j), (tvec, tvec_j), (beta, beta_j)):
        _close(a, b)


@pytest.mark.parametrize("multimodal", [True, False])
def test_prepare_decode_matches_jax(multimodal):
    jm, jp, m, tp, batch, tb = _setup(multimodal=multimodal)
    want = jmodel.prepare_decode(jp, jm, batch)
    got = vt.prepare_decode(tp, m, tb, device="cpu")
    for a, b in zip(got, want):
        _close(a, b)


def _decode_inputs(jm, jp, batch, K=3, seed=2):
    state = jmodel.prepare_decode(jp, jm, batch)
    rng = np.random.RandomState(seed)
    B = batch["src"].shape[0]
    tok = rng.randint(0, jm.tgt_vocab_size, (B, K)).astype(np.int32)
    s = (0.5 * rng.randn(B, K, jm.dec_hidden_dim)).astype(np.float32)
    return state, tok, s


def _torch_state(state):
    return tmodel.DecodeState(*(torch.as_tensor(np.array(x)) for x in state))


def test_decode_tables_match_jax(toy):
    jm, jp, m, tp, batch, tb = toy
    want = jdec.decode_tables(jp["decoder"])
    got = dec.decode_tables(tp["decoder"])
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("tabled", [False, True])
def test_decode_step_beams_matches_jax(toy, tabled):
    jm, jp, m, tp, batch, tb = toy
    state, tok, s = _decode_inputs(jm, jp, batch)
    jt = jdec.decode_tables(jp["decoder"]) if tabled else None
    tt = dec.decode_tables(tp["decoder"]) if tabled else None
    want = jdec.decode_step_beams(jp["decoder"], jm, jnp.asarray(tok),
                                  jnp.asarray(s), *state[:3], tables=jt)
    ts = _torch_state(state)
    got = dec.decode_step_beams(tp["decoder"], m, torch.as_tensor(tok).long(),
                                torch.as_tensor(s), *ts[:3], tables=tt)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("tabled", [False, True])
def test_decode_step_beams_readout_matches_jax(toy, tabled):
    jm, jp, m, tp, batch, tb = toy
    state, tok, s = _decode_inputs(jm, jp, batch)
    jt = jdec.decode_tables(jp["decoder"]) if tabled else None
    tt = dec.decode_tables(tp["decoder"]) if tabled else None
    want = jdec.decode_step_beams_readout(jp["decoder"], jm, jnp.asarray(tok),
                                          jnp.asarray(s), *state[:3],
                                          tables=jt)
    ts = _torch_state(state)
    got = dec.decode_step_beams_readout(tp["decoder"], m,
                                        torch.as_tensor(tok).long(),
                                        torch.as_tensor(s), *ts[:3], tables=tt)
    for a, b in zip(got, want):
        _close(a, b)


def test_tied_readout_matches_jax():
    jm, jp, m, tp, batch, tb = _setup(tied_readout_embedding=True)
    assert "w_out" not in tp["decoder"]["readout"]
    state, tok, s = _decode_inputs(jm, jp, batch)
    want = jdec.decode_step_beams(jp["decoder"], jm, jnp.asarray(tok),
                                  jnp.asarray(s), *state[:3])
    ts = _torch_state(state)
    got = dec.decode_step_beams(tp["decoder"], m, torch.as_tensor(tok).long(),
                                torch.as_tensor(s), *ts[:3])
    _close(got[1], want[1])


@pytest.mark.parametrize("with_ban", [False, True])
@pytest.mark.parametrize("tabled", [False, True])
@pytest.mark.parametrize("impl", ["plain", "unfused"])
def test_decode_step_topk_matches_jax(toy, impl, tabled, with_ban):
    """Port fused-plain and unfused steps against the JAX unfused step (the
    JAX CPU default): ids exactly, scores and states to 1e-5."""
    jm, jp, m, tp, batch, tb = toy
    state, tok, s = _decode_inputs(jm, jp, batch)
    rng = np.random.RandomState(5)
    B, K = tok.shape
    scores = rng.randn(B, K).astype(np.float32)
    fin = rng.rand(B, K) < 0.3
    ban = None
    if with_ban:
        ban = rng.randint(0, jm.tgt_vocab_size + 1, (B, K, 4)).astype(np.int32)
    jt = jdec.decode_tables(jp["decoder"]) if tabled else None
    tt = dec.decode_tables(tp["decoder"]) if tabled else None
    want = jmodel.decode_step_topk(
        jp, jm, jnp.asarray(tok), jnp.asarray(s), state, jnp.asarray(scores),
        jnp.asarray(fin), impl="unfused", tables=jt,
        ban=None if ban is None else jnp.asarray(ban))
    got = tmodel.decode_step_topk(
        tp, m, torch.as_tensor(tok).long(), torch.as_tensor(s),
        _torch_state(state), torch.as_tensor(scores), torch.as_tensor(fin),
        impl=impl, tables=tt, ban=None if ban is None else torch.as_tensor(ban))
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
