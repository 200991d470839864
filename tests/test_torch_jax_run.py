"""A run directory the JAX package wrote, read by the port on the CPU.

The JAX package writes the runs here, with its synchronous
``train.checkpoint.save_checkpoint`` on a ``create_train_state`` (never its
train loop or command line, whose asynchronous checkpointer aborts test
workers), in the bundle layout and in the older layout (the state alone,
its metadata in the ``meta_<tag>.json`` sidecar). The port's
``load_checkpoint`` gives params, Adam moments, step and lr bit for bit;
``Translator.from_run`` and the command line's ``translate`` decode the JAX
package's fixed-seed beam golden (``goldens/beam_toy.json``) from it
exactly. The port's msgpack reader (``train/flax_msgpack.py``) is held
against flax's own on drawn trees.

``goldens/jax_run_toy/`` is such a run, checked in for ``chip_smoke.py``
(which imports no JAX) to decode on the card; ``VAG_REGEN_GOLDENS=1``
rewrites it, as ``tests/test_goldens.py`` rewrites its goldens."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from vag_nmt_tpu.core.config import preset as jax_preset
from vag_nmt_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from vag_nmt_tpu.train.state import create_train_state as jax_create_train_state

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch import cli
from vag_nmt_tpu_torch.data.batching import Example
from vag_nmt_tpu_torch.data.datasets import toy_vocab
from vag_nmt_tpu_torch.train import flax_msgpack
from vag_nmt_tpu_torch.train.checkpoint import has_checkpoint, load_checkpoint

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GOLDEN = os.path.join(GOLDEN_DIR, "beam_toy.json")
RUN_GOLDEN = os.path.join(GOLDEN_DIR, "jax_run_toy")
REGEN = os.environ.get("VAG_REGEN_GOLDENS") == "1"
STEP, LR = 7, 0.00123
META = {"epoch": 2, "best_bleu": 1.5}


def _golden_examples(m):
    """The 24 examples of the beam golden (tests/test_goldens.py)."""
    rng = np.random.RandomState(13)
    return [Example(src=list(rng.randint(4, m.src_vocab_size,
                                         rng.randint(3, 14))),
                    img=rng.randn(m.img_feat_dim).astype(np.float32), index=i)
            for i in range(24)]


def _jax_state():
    """The golden's params (jax.random.key(5)) in a TrainState with a step,
    an lr and Adam moments that are not the init's zeros."""
    cfg = jax_preset("toy")
    state = jax_create_train_state(jax.random.key(5), cfg)
    adam = state.opt_state[1]
    adam = adam._replace(
        count=jnp.asarray(STEP, jnp.int32),
        mu=jax.tree.map(lambda p: 0.5 * p + 0.01, state.params),
        nu=jax.tree.map(lambda p: p * p + 1e-3, state.params))
    return cfg, state._replace(step=jnp.asarray(STEP, jnp.int32),
                               opt_state=(state.opt_state[0], adam),
                               lr=jnp.asarray(LR, jnp.float32))


def write_jax_run(run_dir, layout: str):
    """A JAX run directory: config.json and checkpoints/state_best.msgpack
    (+ meta_best.json) in the bundle or the legacy layout."""
    cfg, state = _jax_state()
    ckpt = os.path.join(run_dir, cfg.train.checkpoint_dir)
    if layout == "bundle":
        jax_save_checkpoint(ckpt, "best", state, META)
    else:
        os.makedirs(ckpt, exist_ok=True)
        with open(os.path.join(ckpt, "state_best.msgpack"), "wb") as f:
            f.write(serialization.to_bytes(jax.device_get(state._asdict())))
        with open(os.path.join(ckpt, "meta_best.json"), "w") as f:
            json.dump({"step": STEP, **META}, f)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    return cfg, state


@pytest.fixture(scope="module", params=["bundle", "legacy"])
def jax_run(request, tmp_path_factory):
    run = str(tmp_path_factory.mktemp(f"jax_run_{request.param}"))
    cfg, state = write_jax_run(run, request.param)
    data = os.path.join(run, "data")
    os.makedirs(data)
    for lang in ("en", "de"):
        toy_vocab().save(os.path.join(data, f"vocab.{lang}.json"))
    return run, data, cfg, state


def _leaves(tree):
    """(path, numpy array) of a params tree, the port's or JAX's (lists as
    lists, dicts by sorted key)."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", a) for k in sorted(tree) for p, a in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}", a) for i, v in enumerate(tree) for p, a in _leaves(v)]
    if isinstance(tree, torch.Tensor):
        return [("", tree.numpy())]
    return [("", np.asarray(tree))]


def test_load_checkpoint_is_bit_for_bit(jax_run):
    run, _, cfg, state = jax_run
    ckpt = os.path.join(run, cfg.train.checkpoint_dir)
    m = vt.preset("toy").model
    assert has_checkpoint(ckpt, "best") and not has_checkpoint(ckpt, "last")
    got, meta = load_checkpoint(ckpt, "best", device="cpu", cfg=m)
    assert got.step == STEP and meta == {"step": STEP, **META}
    assert got.lr.dtype == torch.float32
    assert got.lr.numpy().tobytes() == np.float32(LR).tobytes()
    for ours, theirs in ((got.params, state.params),
                         (got.mu, state.opt_state[1].mu),
                         (got.nu, state.opt_state[1].nu)):
        a, b = _leaves(ours), _leaves(jax.device_get(theirs))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (p, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y), p
    with pytest.raises(ValueError, match="model config"):
        load_checkpoint(ckpt, "best", device="cpu")


def test_translator_from_run_decodes_the_golden(jax_run):
    run, data, _, _ = jax_run
    tr = vt.Translator.from_run(run, data_dir=data, device="cpu")
    hyps, _ = vt.translate_corpus(tr.params, tr.cfg,
                                  _golden_examples(tr.cfg.model), toy_vocab(),
                                  beam_size=3, de_bpe=False, device="cpu")
    with open(GOLDEN) as f:
        assert hyps == json.load(f)


def test_cli_translate_decodes_the_golden(jax_run, tmp_path, capsys):
    run, data, _, _ = jax_run
    m = vt.preset("toy").model
    exs = _golden_examples(m)
    itos = toy_vocab().itos
    split = tmp_path / "d"
    split.mkdir()
    for name in os.listdir(data):
        os.symlink(os.path.join(data, name), split / name)
    (split / "golden.en").write_text(
        "".join(" ".join(itos[t] for t in ex.src) + "\n" for ex in exs))
    np.save(split / "golden_features.npy", np.stack([ex.img for ex in exs]))
    out = tmp_path / "hyp.txt"
    cli.main(["translate", "--data-dir", str(split), "--checkpoint", run,
              "--split", "golden", "--output", str(out), "--beam", "3",
              "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["sentences"] == 24 and stats["beam_size"] == 3
    with open(GOLDEN) as f:
        assert out.read_text().splitlines() == json.load(f)


def test_both_kinds_of_checkpoint_pick_the_newer(jax_run, tmp_path):
    """A .pt beside a .msgpack: the larger step is read; on a tie the
    .pt."""
    run, _, cfg, _ = jax_run
    ckpt = os.path.join(run, cfg.train.checkpoint_dir)
    m = vt.preset("toy").model
    jax_state, _ = load_checkpoint(ckpt, "best", device="cpu", cfg=m)
    mixed = tmp_path / "ck"
    mixed.mkdir()
    for name in os.listdir(ckpt):
        os.symlink(os.path.join(ckpt, name), mixed / name)
    from vag_nmt_tpu_torch.train.checkpoint import save_checkpoint

    for step, want_pt in ((STEP - 1, False), (STEP, True), (STEP + 1, True)):
        pt_state = jax_state._replace(step=step, lr=jax_state.lr * 2)
        save_checkpoint(str(mixed), "best", pt_state, {"epoch": 9})
        got, _ = load_checkpoint(str(mixed), "best", device="cpu", cfg=m)
        assert (got.step == step) == want_pt
        assert float(got.lr) == pytest.approx(2 * LR if want_pt else LR)


# -- the checked-in run (chip_smoke.py decodes it on the card) -------------

def test_checked_in_run_is_the_jax_packages():
    """goldens/jax_run_toy holds what write_jax_run writes (bundle layout),
    and the port reads it into the golden's params."""
    path = os.path.join(RUN_GOLDEN, "checkpoints", "state_best.msgpack")
    if REGEN or not os.path.exists(path):
        write_jax_run(RUN_GOLDEN, "bundle")
        pytest.skip("regenerated goldens/jax_run_toy")
    cfg, state = _jax_state()
    with open(path, "rb") as f:
        stored = flax_msgpack.msgpack_restore(f.read())
    tree = flax_msgpack.msgpack_restore(bytes(stored["state_bytes"]))
    want = serialization.to_state_dict(jax.device_get(state._asdict()))
    a = jax.tree_util.tree_leaves_with_path(tree)
    b = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y)), p
    with open(os.path.join(RUN_GOLDEN, "config.json")) as f:
        assert vt.Config.from_json(f.read()).model == vt.preset("toy").model


# -- the msgpack reader against flax ---------------------------------------

_DTYPES = [np.float32, np.float16, np.int32, np.int64, np.bool_]


def _array(draw_dtype, shape, seed):
    rng = np.random.RandomState(seed)
    x = np.asarray(rng.randn(*shape))
    if draw_dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16)
    dt = np.dtype(draw_dtype)
    if dt == np.bool_:
        return x < 0
    if dt.kind == "i":
        return np.asarray(rng.randint(-2 ** 31, 2 ** 31 - 1, shape)).astype(dt)
    return x.astype(dt)


_arrays = st.builds(
    _array, st.sampled_from(_DTYPES + ["bfloat16"]),
    st.lists(st.integers(0, 4), min_size=0, max_size=3).map(tuple),
    st.integers(0, 2 ** 31 - 1))
_scalars = st.one_of(
    st.integers(-2 ** 63, 2 ** 64 - 1), st.floats(allow_nan=False),
    st.booleans(), st.none(), st.text(max_size=20), st.binary(max_size=20),
    st.builds(np.float32, st.floats(width=32, allow_nan=False)),
    st.builds(np.int64, st.integers(-2 ** 63, 2 ** 63 - 1)))
_trees = st.recursive(
    st.one_of(_arrays, _scalars),
    lambda kids: st.one_of(
        st.lists(kids, max_size=4),
        st.dictionaries(st.text(min_size=1, max_size=8), kids, max_size=4)),
    max_leaves=12)


def _same(a, b):
    """a (the port's reader) equals b (flax's): arrays by dtype and bytes,
    bfloat16 widened to float32 on our side."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b)
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(b, (np.ndarray, np.generic)):
        b = np.asarray(b)
        if b.dtype == jnp.bfloat16:
            b = b.astype(np.float32)
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b


@settings(max_examples=60, deadline=None)
@given(_trees)
def test_msgpack_reader_matches_flax(tree):
    data = serialization.to_bytes({"root": tree})
    _same(flax_msgpack.msgpack_restore(data), serialization.msgpack_restore(data))


def test_msgpack_reader_types_flax_writes():
    """0-d arrays, numpy scalars, a complex, a chunked leaf, str and bytes."""
    tree = {"s": np.float32(2.5), "z": np.zeros((), np.int64), "c": 1 + 2j,
            "t": "tekst", "b": b"\x00\xff", "l": [1, -1, 2 ** 40, -2 ** 40],
            "n": None}
    data = serialization.to_bytes(tree)
    _same(flax_msgpack.msgpack_restore(data), serialization.msgpack_restore(data))
    big = {"w": np.arange(10, dtype=np.float32)}
    old = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = 12        # three floats a chunk
    try:
        data = serialization.to_bytes(big)
    finally:
        serialization.MAX_CHUNK_SIZE = old
    got = flax_msgpack.msgpack_restore(data)
    assert np.array_equal(got["w"], big["w"])
    with pytest.raises(ValueError):
        flax_msgpack.unpackb(data[:-3])
