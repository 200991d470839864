"""The decode selection variables of core/knobs.py against the JAX package
under the same settings, on the CPU at the toy preset, from the same
parameters (through the weight bridge): VAG_BLOCK_NGRAM and VAG_BEAM_PRUNE
drive beam search, the streaming pool and translate_corpus (greedy
included) of both packages alike; an explicit argument to a port function
still wins. Tokens, lengths and loop trips exactly; scores to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import EOS_ID, preset as jax_preset
from vag_nmt_tpu.data.datasets import make_toy_examples as jax_toy_examples
from vag_nmt_tpu.data.datasets import toy_vocab as jax_toy_vocab
from vag_nmt_tpu.decode import beam as jbeam
from vag_nmt_tpu.decode.translate import translate_corpus as jax_translate
from vag_nmt_tpu.models import prepare_decode as jax_prepare_decode

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.core.knobs import decode_knobs
from vag_nmt_tpu_torch.data.datasets import make_toy_examples, toy_vocab

from tests.test_models import make_batch
from tests.test_torch_serve import _params

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

SCORE_ATOL = 1e-5
KNOBS = ("VAG_BLOCK_NGRAM", "VAG_BEAM_PRUNE", "VAG_BEAM_UNROLL",
         "VAG_TWO_PHASE", "VAG_FRT_SLOTS", "VAG_FRT_DEFER", "VAG_FRT_NOCOND")


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_preset("toy")
    jp = _params(jcfg.model)
    m = vt.preset("toy").model
    tp = vt.params_from_numpy(jax.device_get(jp), m, device="cpu")
    batch = make_batch(jcfg, B=6, T=8, seed=3)
    jstate = jax_prepare_decode(jp, jcfg.model, batch)
    tstate = vt.prepare_decode(tp, m, {k: np.array(v) for k, v in batch.items()},
                               device="cpu")
    return jcfg.model, jp, jstate, m, tp, tstate


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _same(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=SCORE_ATOL, rtol=0)


def test_block_ngram_variable_drives_both_packages(setup, monkeypatch):
    jm, jp, jstate, m, tp, tstate = setup
    kw = dict(beam_size=3, max_len=16)
    plain = vt.beam_search(tp, m, tstate, device="cpu", **kw)
    monkeypatch.setenv("VAG_BLOCK_NGRAM", "2")
    want = jbeam.beam_search(jp, jm, jstate, **kw)
    got = vt.beam_search(tp, m, tstate, device="cpu", **kw)
    _same(got, want)
    assert not torch.equal(got.tokens, plain.tokens)    # the ban took effect
    want_s, wsteps, wrefills = jbeam.beam_search_streaming(
        jp, jm, jstate, slots=4, **kw)
    got_s, steps, refills = vt.beam_search_streaming(tp, m, tstate, slots=4,
                                                     device="cpu", **kw)
    _same(got_s, want_s)
    assert (steps, refills) == (int(wsteps), int(wrefills))
    # an explicit argument to a port function wins over the variable
    explicit = vt.beam_search(tp, m, tstate, device="cpu", block_ngram=0, **kw)
    assert torch.equal(explicit.tokens, plain.tokens)


def test_block_ngram_variable_reaches_greedy_through_translate(monkeypatch):
    """The JAX package applies VAG_BLOCK_NGRAM to greedy decode in
    translate_corpus (not in greedy_decode itself); so does the port."""
    jcfg, cfg = jax_preset("toy"), vt.preset("toy")
    jp = _params(jcfg.model)
    params = vt.params_from_numpy(jax.device_get(jp), cfg.model, device="cpu")
    jexs, exs = jax_toy_examples(9, seed=5), make_toy_examples(9, seed=5)
    plain, _ = vt.translate_corpus(params, cfg, exs, toy_vocab(), beam_size=1,
                                   batch_size=4, device="cpu")
    monkeypatch.setenv("VAG_BLOCK_NGRAM", "2")
    want, _ = jax_translate(jp, jcfg, jexs, jax_toy_vocab(), beam_size=1,
                            batch_size=4)
    got, _ = vt.translate_corpus(params, cfg, exs, toy_vocab(), beam_size=1,
                                 batch_size=4, device="cpu")
    assert got == want
    assert got != plain                                 # the ban took effect


def _scripted(monkeypatch, max_len, lp, B, K):
    """beam_search of both packages against a scripted posterior (the JAX
    package's tests/test_decode.py::_scripted_beam): decode_step_topk is
    replaced in each by a step with its candidate contract whose
    per-(sentence, step) log-probs come from ``lp`` (B, max_len + 1, V),
    the hidden state carrying the step count. Returns (JAX, port)."""
    import dataclasses

    from vag_nmt_tpu.decode import beam as jbeam_mod
    from vag_nmt_tpu.models.model import DecodeState as JState

    from vag_nmt_tpu_torch.decode import beam as tbeam_mod
    from vag_nmt_tpu_torch.ops.topk import stable_topk

    V = lp.shape[-1]
    jm = dataclasses.replace(jax_preset("toy").model, tgt_vocab_size=V)
    m = dataclasses.replace(vt.preset("toy").model, tgt_vocab_size=V)
    jtab, ttab = jnp.asarray(lp), torch.from_numpy(lp)

    def jstep(params, cfg, tok, s, state, scores, finished, *, impl="auto",
              tables=None, defer_exact=False, exact=False, ban=None):
        t = jnp.clip(s[:, 0, 0].astype(jnp.int32), 0, max_len)
        cand = scores[:, :, None] + jtab[jnp.arange(s.shape[0]), t][:, None]
        ride = jnp.full((V,), -1e9, jnp.float32).at[0].set(0.0)
        cand = jnp.where(finished[:, :, None], scores[:, :, None] + ride, cand)
        out = (s + 1.0,) + tuple(jax.lax.top_k(cand.reshape(s.shape[0], -1), K))
        return out + (jnp.zeros((), bool),) if defer_exact else out

    def tstep(params, cfg, tok, s, state, scores, finished, *, impl="auto",
              tables=None, defer_exact=False, exact=False, ban=None,
              opts=None):
        t = s[:, 0, 0].long().clamp(0, max_len)
        cand = scores[:, :, None] + ttab[torch.arange(s.shape[0]), t][:, None]
        ride = torch.full((V,), -1e9)
        ride[0] = 0.0
        cand = torch.where(finished[:, :, None], scores[:, :, None] + ride, cand)
        return (s + 1.0,) + stable_topk(cand.reshape(s.shape[0], -1), K)

    monkeypatch.setattr(jbeam_mod, "decode_step_topk", jstep)
    monkeypatch.setattr(tbeam_mod, "decode_step_topk", tstep)
    jst = JState(ctx=jnp.zeros((B, 4, 8)), ctx_proj=jnp.zeros((B, 4, 8)),
                 src_mask=jnp.ones((B, 4)), s0=jnp.zeros((B, 4)))
    tst = vt.DecodeState(ctx=torch.zeros((B, 4, 8)), ctx_proj=torch.zeros((B, 4, 8)),
                         src_mask=torch.ones((B, 4)), s0=torch.zeros((B, 4)))
    kw = dict(beam_size=K, max_len=max_len)
    return (jbeam_mod.beam_search({}, jm, jst, **kw),
            vt.beam_search({}, m, tst, device="cpu", **kw))


def _wanderer(max_len, V=6):
    """tests/test_decode.py::_wanderer_script: in sentence 0 one hypothesis
    finishes at once and the others wander at -1.2 a step, so the exact
    prune fires; sentence 1 finishes within two steps."""
    lp = np.full((2, max_len + 1, V), -20.0, np.float32)
    lp[0, 0, [EOS_ID, 4, 5]] = [-0.5, -0.6, -3.0]
    lp[0, 1:, EOS_ID] = -9.0
    lp[0, 1:, 4] = -1.2
    lp[0, 1:, 5] = -5.0
    lp[1, 0, [EOS_ID, 4, 5]] = [-0.3, -0.4, -0.55]
    lp[1, 1:, EOS_ID] = -0.2
    lp[1, 1:, 4] = -4.0
    lp[1, 1:, 5] = -5.0
    return lp


def test_beam_prune_variable_drives_both_packages(monkeypatch):
    """VAG_BEAM_PRUNE=off turns the exact prune off in both packages: the
    full hypothesis set (the prune truncates provably losing tail slots)
    and the loop trips equal the JAX package's (with pruning off the JAX
    trip count, max(lengths), is the realized one); an explicit argument
    wins over the variable."""
    lp = _wanderer(32)
    jon, ton = _scripted(monkeypatch, 32, lp, B=2, K=3)
    _same(ton, jon)
    assert ton.steps < 32                              # the prune fired
    monkeypatch.setenv("VAG_BEAM_PRUNE", "off")
    joff, toff = _scripted(monkeypatch, 32, lp, B=2, K=3)
    _same(toff, joff)
    assert toff.steps == int(np.asarray(joff.lengths).max()) == 32
    assert not torch.equal(toff.tokens, ton.tokens)
    np.testing.assert_array_equal(toff.best_tokens.numpy(),
                                  ton.best_tokens.numpy())


def test_decode_knobs_read_the_variables(monkeypatch):
    k = decode_knobs()
    assert (k.beam_prune, k.block_ngram, k.beam_unroll, k.two_phase,
            k.frt_slots, k.frt_defer, k.frt_nocond) == (
                None, None, None, None, None, True, False)
    for name, value in (("VAG_BEAM_PRUNE", "0"), ("VAG_BLOCK_NGRAM", "3"),
                        ("VAG_BEAM_UNROLL", "4"), ("VAG_TWO_PHASE", "on"),
                        ("VAG_FRT_SLOTS", "2"), ("VAG_FRT_DEFER", "0"),
                        ("VAG_FRT_NOCOND", "1")):
        monkeypatch.setenv(name, value)
    k = decode_knobs()
    assert (k.beam_prune, k.block_ngram, k.beam_unroll, k.two_phase,
            k.frt_slots, k.frt_defer, k.frt_nocond) == (
                False, 3, 4, True, 2, False, True)


def test_dtype_and_super_chunk_variables_read(monkeypatch):
    """VAG_ATTN_E_DTYPE ("bf16"/"bfloat16" or "fp32"), VAG_FRT_GEMM_DTYPE
    ("bf16"/"bfloat16") and VAG_SUPER_CHUNK (an int; "" is 0, as the JAX
    package's ``int(... or 0)``) read as the JAX package reads them."""
    for k in ("VAG_ATTN_E_DTYPE", "VAG_FRT_GEMM_DTYPE", "VAG_SUPER_CHUNK"):
        monkeypatch.delenv(k, raising=False)
    k = decode_knobs()
    assert (k.attn_e_dtype, k.frt_gemm_bf16, k.super_chunk) == (None, False,
                                                                None)
    for attn, frt, sc, want in (("bf16", "bf16", "8", ("bf16", True, 8)),
                                ("bfloat16", "bfloat16", "", ("bf16", True, 0)),
                                ("fp32", "fp32", "0", ("fp32", False, 0)),
                                ("x", "", "1", (None, False, 1))):
        monkeypatch.setenv("VAG_ATTN_E_DTYPE", attn)
        monkeypatch.setenv("VAG_FRT_GEMM_DTYPE", frt)
        monkeypatch.setenv("VAG_SUPER_CHUNK", sc)
        k = decode_knobs()
        assert (k.attn_e_dtype, k.frt_gemm_bf16, k.super_chunk) == want


@pytest.mark.parametrize("value,passes", [(None, 1), ("0", 4), ("1", 4),
                                          ("", 4), ("8", 2)])
def test_super_chunk_variable_sets_encoder_passes(value, passes, monkeypatch):
    """VAG_SUPER_CHUNK alone sets the encoder passes of translate_corpus
    (13 sentences in chunks of 4: 4 chunks; unset, SUPER_CHUNK_ROWS = 1024
    rows take them in one pass; "", "0" and "1" one pass a chunk; "8" two
    passes of two chunks), with the hypotheses of the default and of the
    JAX package under the same variable."""
    from vag_nmt_tpu_torch.decode import translate as ttranslate

    monkeypatch.delenv("VAG_SUPER_CHUNK", raising=False)
    jcfg = jax_preset("toy")
    cfg = vt.preset("toy")
    jp = _params(jcfg.model)
    params = vt.params_from_numpy(jax.device_get(jp), cfg.model, device="cpu")
    exs = make_toy_examples(13, seed=5)
    default, _ = vt.translate_corpus(params, cfg, exs, toy_vocab(),
                                     batch_size=4, device="cpu")
    if value is not None:
        monkeypatch.setenv("VAG_SUPER_CHUNK", value)
    calls = []
    real = ttranslate.prepare_decode

    def counting(*a, **k):
        state = real(*a, **k)
        calls.append(state.s0.shape[0])
        return state

    monkeypatch.setattr(ttranslate, "prepare_decode", counting)
    got, st = vt.translate_corpus(params, cfg, exs, toy_vocab(), batch_size=4,
                                  device="cpu")
    assert len(calls) == passes and sum(calls) == st["n_chunks"] * 4
    assert got == default
    want, _ = jax_translate(jp, jcfg, jax_toy_examples(13, seed=5),
                            jax_toy_vocab(), batch_size=4)
    assert got == want
