"""The K-step train dispatcher (``train/step.py::make_multi_step``), its
CUDA-graph dispatch (``train/graphs.py``) and ``train_loop``'s K-stacks,
on the CPU at the toy preset's widths.

- ``make_multi_step`` against the JAX package's ``make_multi_step`` (mesh
  None) on the same K = 3 stack at dropout 0, for classic, compact and
  image-table batches: params, moments and every aux row after the K
  steps, at ``tests/test_torch_train.py``'s tolerances (1e-5 absolute;
  the grad norm 1e-6 relative), the params at ``tests/test_torch_parallel.py``'s
  for params after Adam steps against the JAX package (PARAMS_TOL).
- The K-step call against K single steps of ``make_train_step``, bit for
  bit, at dropout 0.3 (step k draws what single step k draws).
- ``train_loop`` with steps_per_dispatch=3 on a corpus that forms stacks:
  each stack one dispatch, a stack straddling an eval boundary split at
  the exact step, a resume with the cursor inside a stack bit for bit as
  an uninterrupted run, ``debug_nans`` over a dispatch.
- A ``TorchDispatchMode`` guard that a step's body (forward, backward,
  update) makes no host read and no host copy.
- The graph path's wiring on stand-ins for the CUDA stream and graph:
  the generators re-seeded per replay, the state written back into the
  static buffers (and a state eager steps made copied in), the LR decay
  seen by a later replay, kernels 2-5's counter deltas added once a
  replay, a warm-up that counts nothing; ``StepGraphs(capture=False)``
  against ``make_multi_step`` bit for bit; "graph" on the CPU raises.

CUDA graphs themselves run only on the card: ``chip_smoke.py`` phase 26
holds graph against eager there."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import preset as jax_preset
from vag_nmt_tpu.train.state import create_train_state as j_create_state
from vag_nmt_tpu.train.step import make_multi_step as j_make_multi_step

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.core.graphs import counter_deltas
from vag_nmt_tpu_torch.data.batching import BucketBatcher
from vag_nmt_tpu_torch.data.datasets import make_toy_examples, toy_vocab
from vag_nmt_tpu_torch.ops import dec_scan, gru_kernel
from vag_nmt_tpu_torch.train import graphs as tg
from vag_nmt_tpu_torch.train import loop as tloop
from vag_nmt_tpu_torch.train.checkpoint import (load_checkpoint,
                                                save_checkpoint)
from vag_nmt_tpu_torch.train.state import (state_from_params, state_tensors,
                                           tree_leaves)
from vag_nmt_tpu_torch.train.step import (make_step_body, row, step_seed,
                                          to_device)

from tests.test_models import make_batch
from tests.test_torch_graph_decode import HOST_OPS, _mesh, _Ops
from tests.test_torch_params import _flat

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ATOL = 1e-5
# Params after Adam steps against the JAX package's, as
# tests/test_torch_parallel.py holds them: an element whose grad is near
# Adam's eps moves by lr * g / (|g| + eps), which turns the grads' fp32
# roundoff into a part of lr (3e-3 at the toy preset; measured 1.46e-5 on
# one element of 1024 after three steps).
PARAMS_TOL = dict(rtol=3e-4, atol=1e-5)
K = 3
XLA = dict(gru_impl="xla", dec_scan_impl="xla")

# (case: model updates, batcher keywords, with_img_table)
CASES = {
    "classic": (dict(), dict(include_image=True, img_dim=64), False),
    "compact": (dict(multimodal=False), dict(compact=True), False),
    "img_table": (dict(), dict(compact=True, image_ids=True), True),
}


def _examples(n=160, seed=5):
    return make_toy_examples(n, seed=seed, img_dim=64)


def _stack(exs, kw, k=K, seed=2):
    """The first k-deep stack of the toy corpus's epoch 0."""
    b = BucketBatcher(exs, 16, (8, 16), seed=seed, **kw)
    return next(s for s in b.epoch_stacked(0, k) if s["src"].ndim == 3)


def _np(x):
    return np.asarray(jax.device_get(x))


@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_step_matches_jax(case):
    """K = 3 steps in one call of each package's make_multi_step from the
    same params on the same stack: every aux row, the params and both
    moments."""
    upd, kw, table = CASES[case]
    jcfg = jax_preset("toy").replace(model={**upd, **XLA})
    cfg = vt.preset("toy").replace(model={**upd, **XLA})
    jstate = j_create_state(jax.random.key(3), jcfg)
    state = state_from_params(cfg, vt.params_from_numpy(
        jax.device_get(jstate.params), cfg.model, device="cpu"))
    exs = _examples()
    stack = _stack(exs, kw)
    jfn, _ = j_make_multi_step(jcfg, with_img_table=table)
    fn = vt.make_multi_step(cfg, with_img_table=table)
    jstack = {k: jnp.asarray(v) for k, v in stack.items() if k != "index"}
    if table:
        img = vt.build_img_table(exs, 64, device="cpu")
        jstate, jaux = jfn(jstate, jstack, jax.random.key(9),
                           jnp.asarray(img.numpy()))
        state, aux = fn(state, stack, img)
    else:
        jstate, jaux = jfn(jstate, jstack, jax.random.key(9))
        state, aux = fn(state, stack)
    assert state.step == int(jstate.step) == K and int(state.count) == K
    assert sorted(aux) == sorted(jaux)
    for k in jaux:
        assert aux[k].shape == (K,), k
        tol = dict(rtol=1e-6) if k == "grad_norm" else dict(atol=ATOL)
        np.testing.assert_allclose(aux[k].numpy(), _np(jaux[k]), err_msg=k,
                                   **tol)
    adam = jstate.opt_state[1]
    for tree, want in (("params", jstate.params), ("mu", adam.mu),
                       ("nu", adam.nu)):
        got = dict(_flat(getattr(state, tree)))
        tol = PARAMS_TOL if tree == "params" else dict(atol=ATOL)
        for path, v in _flat(jax.device_get(want)):
            np.testing.assert_allclose(got[path].numpy(), np.asarray(v),
                                       err_msg=f"{tree} {path}", **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_step_equals_single_steps(case):
    """The K-step call and K calls of make_train_step from the same state
    on the stack's rows, at dropout 0.3: every aux value, the params,
    moments and count bit for bit."""
    upd, kw, table = CASES[case]
    cfg = vt.preset("toy").replace(model={**upd, "dropout": 0.3})
    exs = _examples()
    stack = _stack(exs, kw)
    img = vt.build_img_table(exs, 64, device="cpu") if table else None
    s0 = vt.create_train_state(cfg, torch.Generator().manual_seed(1),
                               device="cpu")
    s0 = s0._replace(step=5, count=s0.count + 5)       # a later step's draws
    multi, aux = vt.make_multi_step(cfg, with_img_table=table)(s0, stack, img)
    step = vt.make_train_step(cfg, with_img_table=table)
    single, rows = s0, []
    for k in range(K):
        single, a = step(single, row(stack, k), img)
        rows.append(a)
    assert multi.step == single.step == 5 + K
    for key in aux:
        assert torch.equal(aux[key], torch.stack([r[key] for r in rows])), key
    for x, y in zip(state_tensors(multi), state_tensors(single)):
        assert torch.equal(x, y)
    # the draws are those of the steps: a stack from step 0 differs
    other, _ = vt.make_multi_step(cfg, with_img_table=table)(
        s0._replace(step=0), stack, img)
    assert not torch.equal(tree_leaves(other.params)[0],
                           tree_leaves(multi.params)[0])


def test_update_counts_on_the_device():
    """apply_update reads the step from the device count (the host's step
    is its mirror): a state whose host step says otherwise updates by its
    count."""
    cfg = vt.preset("toy")
    s0 = vt.create_train_state(cfg, torch.Generator().manual_seed(1),
                               device="cpu")
    batch = make_batch(jax_preset("toy"), B=6, T=6, Tt=7, seed=4)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    step = vt.make_train_step(cfg)
    a, _ = step(s0, batch)
    b, _ = step(s0._replace(step=7), batch)       # the same count, 0
    assert (a.step, b.step, int(a.count), int(b.count)) == (1, 8, 1, 1)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    c, _ = step(s0._replace(count=s0.count + 7), batch)
    assert not all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(a.params), tree_leaves(c.params)))


def _guard_batch(case):
    """A device batch of the guarded body: classic without sample_mask
    (the VSE loss's own row count), or compact with image-table rows."""
    if case == "classic":
        b = make_batch(jax_preset("toy"), B=6, T=6, Tt=7, seed=4)
        return {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}, None
    exs = _examples()
    return (to_device(row(_stack(exs, CASES["img_table"][1]), 0), "cpu"),
            vt.build_img_table(exs, 64, device="cpu"))


@pytest.mark.parametrize("case", ["classic", "img_table"])
def test_step_body_makes_no_host_read_or_copy(case):
    """One train step's body (forward, backward, clip + Adam) at dropout
    0.3 runs none of HOST_OPS: a CUDA graph could capture it."""
    cfg = vt.preset("toy").replace(model=dict(dropout=0.3))
    b, img = _guard_batch(case)
    body = make_step_body(cfg, with_img_table=img is not None)
    state = vt.create_train_state(cfg, torch.Generator().manual_seed(1),
                                  device="cpu")
    state, _ = body(state, b, torch.Generator().manual_seed(3), img)
    gen = torch.Generator().manual_seed(4)
    with _Ops() as ops:
        new, aux = body(state, b, gen, img)
    assert not ops.names & set(HOST_OPS), ops.names & set(HOST_OPS)
    # the guard saw the backward and the update
    assert {"aten.tanh_backward", "aten.pow", "aten.sqrt"} <= ops.names
    assert int(new.count) == 2 and aux["loss"].dim() == 0


# ---------------------------------------------------------------------------
# train_loop's K-stacks
# ---------------------------------------------------------------------------

def _loop_setup(**train):
    cfg = vt.preset("toy").replace(
        model=dict(dropout=0.2),
        train=dict(dict(eval_every_steps=0, steps_per_dispatch=K,
                        log_every_steps=1), **train))
    exs = make_toy_examples(240, seed=6, img_dim=64)
    dev = make_toy_examples(12, seed=1, img_dim=64)
    vocab = toy_vocab()
    refs = [" ".join(vocab.itos[t] for t in ex.tgt) for ex in dev]
    return cfg, exs, dev, vocab, refs


def _epoch_items(cfg, exs):
    b = BucketBatcher(exs, cfg.data.batch_size, cfg.data.length_buckets,
                      seed=cfg.data.shuffle_seed, image_ids=True, img_dim=64,
                      compact=True)
    return [s["src"].shape[0] if s["src"].ndim == 3 else 1
            for s in b.epoch_stacked(0, K)]


class _Calls:
    """Wraps make_train_step / make_multi_step in the loop's module and
    records each call's step count."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name, n in (("make_train_step", lambda b: 1),
                        ("make_multi_step", lambda b: b["src"].shape[0])):
            real = getattr(tloop, name)
            monkeypatch.setattr(tloop, name, self._wrap(real, n))

    def _wrap(self, real, n):
        def make(*a, **kw):
            fn = real(*a, **kw)

            def call(state, batch, *rest):
                self.calls.append(n(batch))
                return fn(state, batch, *rest)
            return call
        return make


def _records(path):
    return [json.loads(x) for x in open(path / "metrics.jsonl")]


def test_train_loop_dispatches_stacks(tmp_path, monkeypatch):
    """Each stack of the epoch is one K-step call, each leftover batch one
    single step, in the batcher's order; the params equal single steps
    over the same rows bit for bit; the dispatch record says eager."""
    cfg, exs, dev, vocab, refs = _loop_setup()
    items = _epoch_items(cfg, exs)
    assert items.count(K) >= 4 and 1 in items     # stacks and leftovers
    calls = _Calls(monkeypatch)
    total = sum(items)
    out = vt.train_loop(cfg, str(tmp_path / "a"), exs, dev, vocab, refs,
                        max_steps=total, device="cpu")
    assert out["steps"] == total and calls.calls == items
    recs = _records(tmp_path / "a")
    assert [r["step"] for r in recs if r["tag"] == "train"] == \
        list(range(1, total + 1))
    d = next(r for r in recs if r["tag"] == "dispatch")
    assert (d["dispatch"], d["captures"], d["replays"]) == ("eager", 0, 0)
    # the same rows as single steps
    state = vt.create_train_state(cfg, torch.Generator().manual_seed(
        cfg.train.seed), device="cpu")
    table = vt.build_img_table(exs, 64, device="cpu")
    step = vt.make_train_step(cfg, with_img_table=True)
    b = BucketBatcher(exs, cfg.data.batch_size, cfg.data.length_buckets,
                      seed=cfg.data.shuffle_seed, image_ids=True, img_dim=64,
                      compact=True)
    losses = []
    for r in tloop._step_rows(b.epoch_stacked(0, K), 0):
        state, aux = step(state, r, table)
        losses.append(float(aux["loss"]))
    assert [r["loss"] for r in recs if r["tag"] == "train"] == losses
    got, _ = load_checkpoint(str(tmp_path / "a" / cfg.train.checkpoint_dir),
                             "last", device="cpu")
    for x, y in zip(state_tensors(got), state_tensors(state)):
        assert torch.equal(x, y)


def test_stack_straddling_an_eval_splits_at_the_step(tmp_path, monkeypatch):
    """An eval boundary inside a stack: its rows run as single steps and
    the eval (and its LR decay, in place) falls on the exact step."""
    cfg, exs, dev, vocab, refs = _loop_setup(
        eval_every_steps=K + 1, lr_decay_patience=1, early_stop_patience=99)
    items = _epoch_items(cfg, exs)
    assert items[:4] == [K] * 4
    calls = _Calls(monkeypatch)
    vt.train_loop(cfg, str(tmp_path), exs, dev, vocab, refs,
                  max_steps=4 * K, device="cpu")
    # steps 1-3 a stack; 4 (eval), 5, 6 single; 7, 8 (eval), 9 single;
    # 10-12 a stack again, ending on the third eval
    assert calls.calls == [K, 1, 1, 1, 1, 1, 1, K]
    recs = _records(tmp_path)
    assert [r["step"] for r in recs if r["tag"] == "eval"] == [4, 8, 12]
    # the second eval's plateau decays the rate in place: the steps after
    # it, the stack's too, apply the new rate
    lr = [r["lr"] for r in recs if r["tag"] == "train"]
    decay = next(r["lr"] for r in recs if r["tag"] == "lr_decay")
    assert lr[:8] == [pytest.approx(cfg.train.learning_rate)] * 8
    assert lr[8:] == [decay] * 4


def test_resume_inside_a_stack_is_bit_exact(tmp_path, monkeypatch):
    """Stop at a step inside a stack (its rows split), resume: the cursor
    splits only that stack, the stacks after it stay stacks, and the final
    state equals an uninterrupted run's bit for bit."""
    cfg, exs, dev, vocab, refs = _loop_setup(log_every_steps=5)
    items = _epoch_items(cfg, exs)
    assert items[:3] == [K, K, K]
    total, stop_at = 4 * K, K + 2
    vt.train_loop(cfg, str(tmp_path / "ref"), exs, dev, vocab, refs,
                  max_steps=total, device="cpu")
    vt.train_loop(cfg, str(tmp_path / "ab"), exs, dev, vocab, refs,
                  max_steps=stop_at, device="cpu")
    meta = json.loads((tmp_path / "ab" / cfg.train.checkpoint_dir
                       / "meta_last.json").read_text())
    assert (meta["epoch"], meta["epoch_cursor"]) == (0, stop_at)
    calls = _Calls(monkeypatch)
    vt.train_loop(cfg.replace(train=dict(resume=True)), str(tmp_path / "ab"),
                  exs, dev, vocab, refs, max_steps=total, device="cpu")
    assert calls.calls[:3] == [1, K, K]
    a, _ = load_checkpoint(str(tmp_path / "ref" / cfg.train.checkpoint_dir),
                           "last", device="cpu")
    b, _ = load_checkpoint(str(tmp_path / "ab" / cfg.train.checkpoint_dir),
                           "last", device="cpu")
    assert a.step == b.step == total
    for x, y in zip(state_tensors(a), state_tensors(b)):
        assert torch.equal(x, y)


def test_skip_step_rows_splits_only_the_straddling_stack():
    stream = [{"src": np.zeros((3, 2, 4)), "i": np.arange(3)},
              {"src": np.zeros((2, 4)), "i": np.array(3)},
              {"src": np.zeros((3, 2, 4)), "i": np.arange(4, 7)},
              {"src": np.zeros((3, 2, 4)), "i": np.arange(7, 10)}]
    for skip, want in ((0, [[0, 1, 2], 3, [4, 5, 6], [7, 8, 9]]),
                       (3, [3, [4, 5, 6], [7, 8, 9]]),
                       (5, [5, 6, [7, 8, 9]]),
                       (7, [[7, 8, 9]]), (9, [9]), (10, [])):
        got = [b["i"].tolist() for b in tloop._skip_step_rows(stream, skip)]
        assert got == want, skip


def test_debug_nans_reads_the_dispatch(tmp_path):
    cfg, exs, dev, vocab, refs = _loop_setup()
    cfg = cfg.replace(train=dict(learning_rate=float("nan")))
    with pytest.raises(FloatingPointError, match="at step 2"):
        vt.train_loop(cfg, str(tmp_path), exs, dev, vocab, refs,
                      max_steps=2 * K, device="cpu", debug_nans=True)


def test_graph_dispatch_on_the_cpu_raises(tmp_path):
    cfg, exs, dev, vocab, refs = _loop_setup()
    with pytest.raises(ValueError, match="CUDA device"):
        vt.train_loop(cfg, str(tmp_path), exs, dev, vocab, refs,
                      max_steps=K, device="cpu", dispatch="graph")
    # a mesh of several ranks runs eager; "graph" there raises
    assert tloop.resolve_dispatch(None, torch.device("cuda"),
                                  _mesh(2, 1)) == "eager"
    with pytest.raises(ValueError, match="several ranks"):
        tloop.resolve_dispatch("graph", torch.device("cuda"), _mesh(2, 1))
    with pytest.raises(ValueError, match="unknown dispatch"):
        vt.train_loop(cfg, str(tmp_path), exs, dev, vocab, refs,
                      max_steps=K, device="cpu", dispatch="jit")


def test_load_checkpoint_into_a_state_copies(tmp_path):
    """load_checkpoint(into=) writes into the given state's tensors (a
    graph captured on them stays valid) and takes the saved step."""
    cfg = vt.preset("toy")
    a = vt.create_train_state(cfg, torch.Generator().manual_seed(1),
                              device="cpu")
    a = a._replace(step=4, count=a.count + 4)
    save_checkpoint(str(tmp_path), "last", a)
    b = vt.create_train_state(cfg, torch.Generator().manual_seed(2),
                              device="cpu")
    ptrs = [t.data_ptr() for t in state_tensors(b)]
    got, meta = load_checkpoint(str(tmp_path), "last", device="cpu", into=b)
    assert got.step == meta["step"] == 4
    assert [t.data_ptr() for t in state_tensors(got)] == ptrs
    for x, y in zip(state_tensors(got), state_tensors(a)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="copy_state"):
        load_checkpoint(str(tmp_path), "last", device="cpu",
                        into=vt.create_train_state(
                            cfg.replace(model=dict(hidden_dim=16)),
                            torch.Generator().manual_seed(2), device="cpu"))


# ---------------------------------------------------------------------------
# The graph path
# ---------------------------------------------------------------------------

def test_stack_buffer_views_equal_to_device():
    exs = _examples()
    stacks = [s for s in BucketBatcher(exs, 16, (8, 16), seed=2, compact=True,
                                       image_ids=True).epoch_stacked(0, K)
              if s["src"].ndim == 3]
    key = tg.stack_key(stacks[0])
    same = [s for s in stacks if tg.stack_key(s) == key]
    buf = tg._StackBuffer(same[0], torch.device("cpu"))
    for s in same:
        buf.fill(s)
        want = to_device(s, "cpu")
        assert sorted(buf.views) == sorted(want)
        for k, v in want.items():
            assert v.dtype == buf.views[k].dtype and torch.equal(
                v, buf.views[k]), k
    other = next(s for s in stacks if tg.stack_key(s) != key)
    with pytest.raises(ValueError, match="stacked batch leaf"):
        buf.fill(other)


def _counting(real):
    def fn(*a, **kw):
        fn.launches += 1
        return real(*a, **kw)
    fn.launches = 0
    return fn


@pytest.fixture
def counted(monkeypatch):
    """Kernels 2-5's wrappers, counting their calls on the CPU too."""
    for mod, name in tg._WRAPPERS:
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name)))
    return tg.read_counts


class _FakeStream:
    cuda_stream = 4242

    def wait_stream(self, other):
        pass


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _FakeGraph:
    """A CUDAGraph stand-in. A capture leaves the state it ran on as it
    was (a real capture runs nothing); a replay runs the captured K steps
    (``_StepGraph.advance``) counting no launch (a real replay makes no
    host call) and records its generators' seeds."""
    replays = []

    def __init__(self):
        self.gens = []

    def register_generator_state(self, g):
        self.gens.append(g)

    def capture_begin(self, pool=None):
        self.pool = pool
        self.saved = [t.clone() for t in state_tensors(_FakeGraph.owner.state)]

    def capture_end(self):
        for t, s in zip(state_tensors(_FakeGraph.owner.state), self.saved):
            t.copy_(s)

    def replay(self):
        _FakeGraph.replays.append([g.initial_seed() for g in self.gens])
        before = tg.read_counts()
        self.step_graph.advance()
        tg.write_counts(before)


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's stream, graph and pool stand-ins (see _FakeGraph)."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: _NullContext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (7, 1))
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: [
        {"segment_pool_id": (7, 1), "total_size": 1024},
        {"segment_pool_id": (0, 0), "total_size": 99}])
    real = tg._StepGraph.capture

    def capture(self):
        real(self)
        self.graph.step_graph = self
    monkeypatch.setattr(tg._StepGraph, "capture", capture)
    _FakeGraph.replays = []
    return _FakeGraph


def _graph_setup():
    cfg = vt.preset("toy").replace(model=dict(dropout=0.3))
    exs = _examples()
    stacks = [s for s in BucketBatcher(exs, 16, (8, 16), seed=2, compact=True,
                                       image_ids=True).epoch_stacked(0, K)
              if s["src"].ndim == 3]
    keys = []
    for s in stacks:
        if tg.stack_key(s) not in keys:
            keys.append(tg.stack_key(s))
    assert len(keys) >= 2
    # two stacks of the first key, one of the second
    first = [s for s in stacks if tg.stack_key(s) == keys[0]][:2]
    second = next(s for s in stacks if tg.stack_key(s) == keys[1])
    state = vt.create_train_state(cfg, torch.Generator().manual_seed(1),
                                  device="cpu")
    return cfg, exs, [first[0], second, first[1]], state


def test_capture_wiring_on_fakes(fake_cuda, counted):
    """StepGraphs on stand-ins for the CUDA stream and graph: a capture
    per shape key, into the shared pool, with K generators registered and
    a warm-up that counts nothing; each replay re-seeds the generators to
    (seed + 1, step + k), writes the state back into the static buffers
    and adds the capture's counter deltas once; an eager single step in
    between is copied in before the next replay; an LR decay in place is
    seen by the next replay. Against make_multi_step and make_train_step
    bit for bit."""
    cfg, exs, stacks, state = _graph_setup()
    table = vt.build_img_table(exs, 64, device="cpu")
    ref = vt.create_train_state(cfg, torch.Generator().manual_seed(1),
                                device="cpu")
    static = [t.data_ptr() for t in state_tensors(state)]
    g = tg.StepGraphs(cfg, state, img_table=table, with_img_table=True)
    fake_cuda.owner = g
    real_multi = vt.make_multi_step(cfg, with_img_table=True)
    single = vt.make_train_step(cfg, with_img_table=True)

    def multi(*args):       # the reference, counting nothing
        saved = counted()
        out = real_multi(*args)
        tg.write_counts(saved)
        return out

    before = counted()

    st, aux = g.run(state, stacks[0])
    want, waux = multi(ref, stacks[0], table)
    per_dispatch = counter_deltas(before, counted())
    assert per_dispatch[("dec_scan_fwd", "launches")] == K
    assert len(per_dispatch) == 4 and all(v % K == 0
                                          for v in per_dispatch.values())
    assert (g.captures, g.replays, st.step) == (1, 1, K)

    st, _ = single(st, row(stacks[1], 0), table)       # an eager step
    want = want._replace(**{f: getattr(st, f) for f in ("params", "mu", "nu",
                                                         "count")}, step=st.step)
    st.lr.mul_(0.5)                                    # an LR decay
    want.lr.mul_(0.5)
    st, aux = g.run(st, stacks[1])                     # a second key
    want, waux = multi(want, stacks[1], table)
    st, aux = g.run(st, stacks[2])                     # a replay, no capture
    want, waux = multi(want, stacks[2], table)

    assert (g.captures, g.replays, st.step) == (2, 3, 3 * K + 1)
    assert [t.data_ptr() for t in state_tensors(st)] == static
    for x, y in zip(state_tensors(st), state_tensors(want)):
        assert torch.equal(x, y)
    for k in waux:
        assert torch.equal(aux[k], waux[k]), k
    assert float(aux["lr"][0]) == float(want.lr) == pytest.approx(
        cfg.train.learning_rate * 0.5)
    seed = cfg.train.seed + 1
    assert fake_cuda.replays == [[step_seed(seed, base + k) for k in range(K)]
                                 for base in (0, K + 1, 2 * K + 1)]
    graph = next(iter(g.graphs.values())).graph
    assert graph.pool == (7, 1) and len(graph.gens) == K
    # counted: 3 replays and one eager step, the warm-ups nothing
    moved = counter_deltas(before, counted())
    assert moved == {k: v // K * (3 * K + 1)
                     for k, v in per_dispatch.items()}
    assert g.stats() == {"dispatch": "graph", "captures": 2, "replays": 3,
                         "capture_s": g.capture_s, "pool_bytes": 1024}


def test_graph_model_matches_multi_step():
    """StepGraphs(capture=False), the graph path's captured code run in
    place of each replay, against make_multi_step bit for bit over two
    shape keys."""
    cfg, exs, stacks, state = _graph_setup()
    table = vt.build_img_table(exs, 64, device="cpu")
    ref = vt.create_train_state(cfg, torch.Generator().manual_seed(1),
                                device="cpu")
    g = tg.StepGraphs(cfg, state, img_table=table, with_img_table=True,
                      capture=False)
    multi = vt.make_multi_step(cfg, with_img_table=True)
    st = state
    for s in stacks:
        st, aux = g.run(st, s)
        ref, raux = multi(ref, s, table)
        for k in raux:
            assert torch.equal(aux[k], raux[k]), k
    for x, y in zip(state_tensors(st), state_tensors(ref)):
        assert torch.equal(x, y)
    assert (g.captures, g.replays, len(g.graphs)) == (0, 3, 2)
