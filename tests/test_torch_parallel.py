"""PyTorch port, data parallelism (``vag_nmt_tpu_torch/parallel``) on the
CPU: two ranks under gloo, each a process of this file started as
``python -m tests.test_torch_parallel --worker <task> <rank> <world>
<store> <args.json>`` (a FileStore under the test's tmp_path; one intra-op
thread; no JAX in the children, so this module imports JAX only inside
the tests), held against the port's single process and the JAX package.

Tolerances are the reference's own: one DP step against JAX's single
device within rtol 1e-5 / atol 1e-6 (loss) and rtol 3e-4 / atol 1e-5
(params), ``tests/test_distributed.py``; five loop steps within 2e-4 /
2e-5 (losses) and 2e-3 / 2e-4 (params), ``tests/test_train.py``'s DP
test. The ranks sum the gradients in another order than one process.
Decode is exact: a row's decode is its own, whichever rank and chunk it
rides in."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.data.datasets import make_toy_examples, toy_vocab
from vag_nmt_tpu_torch.parallel import sharding
from vag_nmt_tpu_torch.parallel.sharding import (Mesh, backend_for,
                                                 host_shard, make_mesh)
from vag_nmt_tpu_torch.train.state import state_from_params, tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 120
WORLD = 2
LOOP_STEPS = 5

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Spawning ranks
# ---------------------------------------------------------------------------

def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_")) and k not in (
               "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return env


def _wait_all(procs, what):
    """Each process's output; on the timeout every process (and its
    children: each runs in a session of its own) is killed and the test
    fails."""
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        pytest.fail(f"{what}: no end within {SPAWN_TIMEOUT_S} s")
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{what} process {i} failed:\n{log[-4000:]}"
    return logs


def _spawn(tmp_path, task, *, world=WORLD, module="tests.test_torch_parallel",
           **args):
    """Runs ``task`` on ``world`` ranks, each ``python -m <module>
    --worker ...``; returns each rank's outputs (the dict its worker
    wrote with torch.save)."""
    args["out"] = str(tmp_path / f"{task}_out")
    path = tmp_path / f"{task}_args.json"
    path.write_text(json.dumps(args))
    store = tmp_path / f"{task}_store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, "--worker", task,
         str(r), str(world), str(store), str(path)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(world)]
    _wait_all(procs, task)
    return [torch.load(f"{args['out']}.{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# Shared inputs
# ---------------------------------------------------------------------------

def _cfg(model=None, **sections):
    cfg = vt.preset("toy")
    upd = {"model": dict(model or {}), **sections}
    return cfg.replace(**{k: v for k, v in upd.items() if v})


def _jax_params(jcfg, seed=0):
    import jax

    from vag_nmt_tpu.models import init_params as jax_init_params

    return jax.device_get(jax_init_params(jax.random.key(seed), jcfg.model))


def _save_params(tmp_path, jp, m, name="params.pt"):
    """The JAX init through the weight bridge, for the ranks to load."""
    path = str(tmp_path / name)
    torch.save(vt.params_from_numpy(jp, m, device="cpu"), path)
    return path


def _leaves(params):
    return [x.detach().numpy() for x in tree_leaves(params)]


# ---------------------------------------------------------------------------
# Workers (run in the spawned ranks)
# ---------------------------------------------------------------------------

def _w_step(mesh, a):
    """One make_train_step(mesh=) step on a global batch; the reduced
    grads and the aux of the global loss, hard negatives as asked."""
    from vag_nmt_tpu_torch.models.layers import RowDraws
    from vag_nmt_tpu_torch.models.model import loss_fn
    from vag_nmt_tpu_torch.train.state import tree_unflatten
    from vag_nmt_tpu_torch.train.step import (_all_reduce_flat, _shard,
                                              step_generator, to_device)

    cfg = vt.Config.from_json(a["cfg"])
    params = torch.load(a["params"])
    batch = dict(np.load(a["batch"]))
    out = {}
    b = to_device(batch, torch.device("cpu"))
    shard, local = _shard(mesh, b)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    gen = RowDraws(step_generator(cfg.train.seed + 1, 0, torch.device("cpu")),
                   shard.start, shard.total)
    loss, aux = loss_fn(tree_unflatten(params, leaves), cfg.model, local, gen,
                        shard=shard)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    out["grads"] = [g.numpy() for g in _all_reduce_flat(mesh, grads)]
    out["loss_aux"] = {k: float(v) for k, v in aux.items()}
    state, aux = vt.make_train_step(cfg, mesh=mesh)(
        state_from_params(cfg, params), batch)
    out["aux"] = {k: float(v) for k, v in aux.items()}
    out["params"] = _leaves(state.params)
    return out


def _w_loop(mesh, a):
    """train_loop(mesh=) for LOOP_STEPS steps on the toy task (resuming
    from a step-0 checkpoint the parent wrote, when given)."""
    from vag_nmt_tpu_torch.train.checkpoint import load_checkpoint

    cfg = vt.Config.from_json(a["cfg"])
    train, dev, vocab, refs = _loop_data(cfg)
    res = vt.train_loop(cfg, a["run"], train, dev, vocab, refs, mesh=mesh,
                        max_steps=LOOP_STEPS, device="cpu")
    state, meta = load_checkpoint(os.path.join(a["run"], "checkpoints"),
                                  "last", device="cpu")
    return {"result": res, "params": _leaves(state.params), "meta": meta}


def _w_decode(mesh, a):
    cfg = vt.Config.from_json(a["cfg"])
    params = torch.load(a["params"])
    exs = make_toy_examples(a["n"], seed=5, img_dim=cfg.model.img_feat_dim)
    with torch.inference_mode():
        hyps, st = vt.translate_corpus(params, cfg, exs, toy_vocab(),
                                       batch_size=a["batch_size"],
                                       nbest=a["nbest"], mesh=mesh,
                                       device="cpu")
        empty = vt.translate_corpus(params, cfg, [], toy_vocab(), mesh=mesh,
                                    device="cpu")
    return {"hyps": hyps, "stats": st, "empty": empty}


WORKERS = {"step": _w_step, "loop": _w_loop, "decode": _w_decode}


def _worker_main(argv):
    task, rank, world, store, args_path = argv
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank,
                      LOCAL_WORLD_SIZE=world)
    import torch.distributed as dist

    dev = sharding.init_distributed("cpu", init_method=f"file://{store}")
    assert dev.type == "cpu"
    mesh = make_mesh()
    assert (mesh.n_data, mesh.backend) == (int(world), "gloo")
    with open(args_path) as f:
        args = json.load(f)
    out = WORKERS[task](mesh, args)
    torch.save(out, f"{args['out']}.{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The mesh itself (one process)
# ---------------------------------------------------------------------------

def test_backend_rule():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert backend_for(cuda, 2, 2) == "nccl"       # a card a rank
    assert backend_for(cuda, 4, 8) == "nccl"
    assert backend_for(cuda, 2, 1) == "gloo"       # ranks share a card
    assert backend_for(cpu, 2, 0) == "gloo"
    assert backend_for(cpu, 1, 8) == "gloo"


def test_make_mesh_takes_the_world_and_raises(monkeypatch):
    mesh = make_mesh()
    assert (mesh.n_data, mesh.n_model, mesh.rank) == (1, 1, 0) and mesh.is_main
    assert make_mesh(n_data=1) == mesh
    # a model axis is a mesh like any other: it must take the world
    with pytest.raises(ValueError, match="whole world"):
        make_mesh(n_data=1, n_model=2)
    with pytest.raises(ValueError, match="whole world"):
        make_mesh(n_model=2)
    with pytest.raises(ValueError, match="whole world"):
        make_mesh(n_data=2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        sharding.init_distributed("cpu")


def test_host_shard_and_rows():
    items = list(range(10))
    assert host_shard(items) == items
    assert host_shard(items, 1, 3) == [1, 4, 7]
    m = Mesh(n_data=2, n_model=1, rank=1, data_index=1, model_index=0,
             backend="gloo")
    assert m.rows(8) == slice(4, 8)
    with pytest.raises(ValueError, match="does not split"):
        m.rows(7)
    np.testing.assert_array_equal(sharding.rows_of_chunks(3, 4, m),
                                  [2, 3, 6, 7, 10, 11])


def test_train_step_rejects_an_unsplittable_batch():
    m = Mesh(n_data=2, n_model=1, rank=0, data_index=0, model_index=0,
             backend="gloo")
    with pytest.raises(ValueError, match="does not split"):
        vt.make_train_step(_cfg(data=dict(batch_size=15)), mesh=m)


def test_unfused_decode_under_a_mesh_raises():
    cfg = _cfg()
    params = vt.init_params(cfg.model, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(ValueError, match="fused path"):
        vt.translate_corpus(params, cfg, make_toy_examples(3), toy_vocab(),
                            fused=False, mesh=make_mesh(), device="cpu")


def test_row_draws_are_the_global_draws():
    """Each rank's dropout masks are its rows of the one-process masks."""
    from vag_nmt_tpu_torch.models.layers import RowDraws, dropout

    x = torch.ones(8, 5, 3)
    want = dropout(torch.Generator().manual_seed(3), x, 0.3, True)
    for start in (0, 4):
        got = dropout(RowDraws(torch.Generator().manual_seed(3), start, 8),
                      x[start:start + 4], 0.3, True)
        assert torch.equal(got, want[start:start + 4])


# ---------------------------------------------------------------------------
# Training on two ranks
# ---------------------------------------------------------------------------

def test_dp_step_matches_jax_single_device(tmp_path):
    """A 2-rank step on the global batch of ``tests/dist_common.py``
    against the JAX package's single-device make_train_step on it."""
    import jax

    from vag_nmt_tpu.core.config import preset as jax_preset
    from vag_nmt_tpu.train.state import create_train_state
    from vag_nmt_tpu.train.step import make_train_step as jax_step

    from tests.dist_common import make_global_batch

    upd = dict(multimodal=False)
    jcfg = jax_preset("toy").replace(model=upd)
    cfg = _cfg(upd)
    batch = make_global_batch(jcfg, list(range(8)))
    np.savez(tmp_path / "batch.npz", **batch)
    jstate = create_train_state(jax.random.key(cfg.train.seed), jcfg)
    params = _save_params(tmp_path, jax.device_get(jstate.params), cfg.model)
    outs = _spawn(tmp_path, "step", cfg=cfg.to_json(), params=params,
                  batch=str(tmp_path / "batch.npz"))
    step, _ = jax_step(jcfg)
    jstate, jaux = step(jstate, {k: jax.numpy.asarray(v)
                                 for k, v in batch.items()},
                        jax.random.key(cfg.train.seed + 1))
    want = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(
        jstate.params))]
    for out in outs:
        np.testing.assert_allclose(out["aux"]["loss"], float(jaux["loss"]),
                                   rtol=1e-5, atol=1e-6)
        for i, (g, w) in enumerate(zip(out["params"], want)):
            np.testing.assert_allclose(g, w, rtol=3e-4, atol=1e-5,
                                       err_msg=f"param leaf {i}")
    # the replicas are bit-identical
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        assert np.array_equal(a, b)


def test_dp_step_in_bf16_matches_single_process(tmp_path):
    """A 2-rank step at model.compute_dtype="bfloat16" (bf16 streams and
    activations, the VSE embeddings gathered through fp32) against the
    port's single process on the same global batch: the aux within the
    fp32 test's 1e-5, the summed grads within 1e-3 of their norm (the
    bf16 training gate of ``chip_smoke.py``'s phase 8c: an activation
    rounded to bf16 one ulp (2^-8) the other way moves a grad far more
    than fp32 roundoff), the replicas bit-identical. Params after the
    step are not compared: Adam's first step moves a param by about
    lr * sign(g) wherever its grad is near 0."""
    from vag_nmt_tpu_torch.train.state import tree_unflatten

    from tests.dist_common import make_global_batch

    cfg = _cfg(dict(compute_dtype="bfloat16"))
    batch = make_global_batch(cfg, list(range(8)))
    batch["img"] = np.random.RandomState(6).randn(8, 64).astype(np.float32)
    np.savez(tmp_path / "batch.npz", **batch)
    params = vt.init_params(cfg.model, torch.Generator().manual_seed(2),
                            device="cpu")
    path = str(tmp_path / "params.pt")
    torch.save(params, path)
    outs = _spawn(tmp_path, "step", cfg=cfg.to_json(), params=path,
                  batch=str(tmp_path / "batch.npz"))
    _, aux = vt.make_train_step(cfg)(state_from_params(cfg, params), batch)
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = vt.loss_fn(tree_unflatten(params, leaves), cfg.model,
                         {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = torch.cat([torch.zeros_like(p).reshape(-1) if g is None
                      else g.reshape(-1) for p, g in zip(leaves, grads)])
    for out in outs:
        for k in ("loss", "ce", "vse", "acc", "ntokens"):
            np.testing.assert_allclose(out["aux"][k], float(aux[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        got = torch.cat([torch.as_tensor(g).reshape(-1) for g in out["grads"]])
        rel = float((got - want).norm() / want.norm())
        assert rel <= 1e-3, rel
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("hard", [False, True], ids=["sum", "hardest"])
def test_dp_vse_loss_takes_global_negatives(tmp_path, hard):
    """The VSE max-margin loss of a multimodal batch split over 2 ranks
    equals the single batch's within 1e-6, and so does every other aux
    value and the summed gradient (within the port's 1e-5). With each
    rank's own rows as the only negatives (no all-gather) the loss is
    another function and this test fails."""
    import jax

    from vag_nmt_tpu.core.config import preset as jax_preset
    from vag_nmt_tpu.models import loss_fn as jax_loss_fn

    from tests.test_models import make_batch

    upd = dict(vse_hard_negatives=hard)
    jcfg = jax_preset("toy").replace(model=upd)
    cfg = _cfg(upd)
    batch = {k: np.asarray(v) for k, v in
             make_batch(jcfg, B=8, T=6, Tt=7, seed=4).items()}
    sm = np.array([1, 1, 1, 1, 1, 1, 0, 1], np.float32)   # a filler row
    batch["sample_mask"] = sm
    batch["tgt_mask"] = batch["tgt_mask"] * sm[:, None]
    np.savez(tmp_path / "batch.npz", **batch)
    jp = _jax_params(jcfg)
    params = _save_params(tmp_path, jp, cfg.model)
    outs = _spawn(tmp_path, "step", cfg=cfg.to_json(), params=params,
                  batch=str(tmp_path / "batch.npz"))
    tp = torch.load(params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    from vag_nmt_tpu_torch.train.state import tree_unflatten

    loss, aux = vt.loss_fn(tree_unflatten(tp, leaves), cfg.model,
                           {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    _, jaux = jax_loss_fn(jp, jcfg.model, batch, None, train=True)
    for out in outs:
        got = out["loss_aux"]
        np.testing.assert_allclose(got["vse"], float(aux["vse"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got["vse"], float(jaux["vse"]), rtol=0,
                                   atol=1e-6)
        # the step's aux: the global values
        for k in ("loss", "ce", "acc", "ntokens", "vse"):
            np.testing.assert_allclose(out["aux"][k], float(aux[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
        for g, w in zip(out["grads"], grads):
            w = np.zeros_like(g) if w is None else w.numpy()
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def _loop_data(cfg):
    train = make_toy_examples(64, seed=0, img_dim=cfg.model.img_feat_dim)
    dev = make_toy_examples(12, seed=1, img_dim=cfg.model.img_feat_dim)
    vocab = toy_vocab()
    refs = [" ".join(vocab.itos[t] for t in ex.tgt) for ex in dev]
    return train, dev, vocab, refs


def _loop_losses(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    return [r["loss"] for r in recs if r["tag"] == "train"], recs


def test_dp_train_loop_matches_single_process_with_dropout(tmp_path):
    """Five train_loop(mesh=) steps at dropout 0.3 (every draw at the
    global batch's shape) against the port's single process, with a dev
    eval through the mesh at the last step; rank 0 alone writes."""
    cfg = _cfg(dict(dropout=0.3), train=dict(
        eval_every_steps=LOOP_STEPS, log_every_steps=1, steps_per_dispatch=2))
    run = str(tmp_path / "dp")
    outs = _spawn(tmp_path, "loop", cfg=cfg.to_json(), run=run)
    one = str(tmp_path / "one")
    train, dev, vocab, refs = _loop_data(cfg)
    res = vt.train_loop(cfg, one, train, dev, vocab, refs,
                        max_steps=LOOP_STEPS, device="cpu")
    from vag_nmt_tpu_torch.train.checkpoint import load_checkpoint

    state, _ = load_checkpoint(os.path.join(one, "checkpoints"), "last",
                               device="cpu")
    got, recs = _loop_losses(run)
    want, _ = _loop_losses(one)
    assert len(got) == LOOP_STEPS
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert [r for r in recs if r["tag"] == "data_parallel"] and \
        recs[0]["backend"] == "gloo" and recs[0]["n_data"] == 2
    for out in outs:
        assert out["result"]["dev_bleu"] == res["dev_bleu"]
        assert out["meta"]["data_parallel"] == {"n_data": 2, "n_model": 1,
                                                "backend": "gloo"}
        for g, w in zip(out["params"], _leaves(state.params)):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4)
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        assert np.array_equal(a, b)


def test_dp_train_loop_matches_jax_mesh(tmp_path):
    """Five train_loop(mesh=) steps (resumed from a step-0 checkpoint of
    the JAX init) against the JAX package's make_train_step under
    make_mesh(n_data=2) on the same batch stream, at dropout 0."""
    import jax

    from vag_nmt_tpu.core.config import preset as jax_preset
    from vag_nmt_tpu.data.batching import BucketBatcher as JBatcher
    from vag_nmt_tpu.decode.translate import build_img_table
    from vag_nmt_tpu.parallel.sharding import make_mesh as jax_mesh
    from vag_nmt_tpu.train.state import create_train_state
    from vag_nmt_tpu.train.step import make_train_step as jax_step

    from vag_nmt_tpu_torch.train.checkpoint import save_checkpoint
    from vag_nmt_tpu_torch.train.loop import _step_rows

    tr = dict(eval_every_steps=0, log_every_steps=1, steps_per_dispatch=2,
              resume=True)
    jcfg = jax_preset("toy").replace(train=tr)
    cfg = _cfg(train=tr)
    jstate = create_train_state(jax.random.key(cfg.train.seed), jcfg)
    run = str(tmp_path / "dp")
    tp = vt.params_from_numpy(jax.device_get(jstate.params), cfg.model,
                              device="cpu")
    save_checkpoint(os.path.join(run, "checkpoints"), "last",
                    state_from_params(cfg, tp),
                    {"epoch": 0, "epoch_cursor": 0, "best_bleu": -1.0,
                     "evals_since_best": 0})
    outs = _spawn(tmp_path, "loop", cfg=cfg.to_json(), run=run)

    train, _, _, _ = _loop_data(cfg)
    m = jcfg.model
    batcher = JBatcher(train, jcfg.data.batch_size, jcfg.data.length_buckets,
                       seed=jcfg.data.shuffle_seed, image_ids=True,
                       img_dim=m.img_feat_dim, compact=True)
    rows = list(_step_rows(batcher.epoch_stacked(0, 2), 0))[:LOOP_STEPS]
    mesh = jax_mesh(n_data=2, n_model=1)
    feed = [{k: v for k, v in b.items() if k != "index"} for b in rows]
    step, state_sh = jax_step(jcfg, mesh, jstate, feed[0],
                              with_img_table=True)
    jstate = jax.device_put(jstate, state_sh)
    table = build_img_table(train, m.img_feat_dim)
    losses = []
    for b in feed:
        jstate, aux = step(jstate, b, jax.random.key(cfg.train.seed + 1),
                           table)
        losses.append(float(aux["loss"]))
    got, _ = _loop_losses(run)
    np.testing.assert_allclose(got, losses, rtol=2e-4, atol=2e-5)
    want = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(
        jstate.params))]
    for out in outs:
        assert out["result"]["steps"] == LOOP_STEPS
        for g, w in zip(out["params"], want):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# Decode on two ranks
# ---------------------------------------------------------------------------

# path: (cfg updates, beam (None: the preset's), nbest, compared with JAX)
DECODE_PATHS = {
    "chunked": (dict(), None, 0, True),
    "streaming": (dict(decode=dict(streaming="on")), None, 0, True),
    "two_phase": (dict(decode=dict(two_phase="on")), None, 0, True),
    "greedy": (dict(decode=dict(beam_size=1)), None, 0, True),
    "nbest": (dict(), None, 2, True),
    "bf16": (dict(decode=dict(compute_dtype="bfloat16")), None, 0, False),
}
N_DECODE, DECODE_B = 23, 5      # B no multiple of 2: rounded up to 6


@pytest.mark.parametrize("path", sorted(DECODE_PATHS))
def test_dp_decode_equals_single_process(tmp_path, path, monkeypatch):
    """translate_corpus(mesh=) on 2 ranks: every rank returns the single
    process's hypotheses exactly, in example order, and (fp32 paths) the
    JAX package's translate_corpus(mesh=make_mesh(n_data=2)) ones, with
    its stats' sentences, n_chunks, rows_per_chunk and path flags; the
    trip stats are the max over ranks, and an empty corpus gives []."""
    import jax

    from vag_nmt_tpu.core.config import preset as jax_preset
    from vag_nmt_tpu.data.datasets import toy_vocab as jax_toy_vocab
    from vag_nmt_tpu.decode.translate import translate_corpus as jax_translate
    from vag_nmt_tpu.parallel.sharding import make_mesh as jax_mesh

    for k in ("VAG_STREAM_DECODE", "VAG_TWO_PHASE", "VAG_READOUT_TOPK"):
        monkeypatch.delenv(k, raising=False)
    upd, _, nbest, with_jax = DECODE_PATHS[path]
    jcfg = jax_preset("toy").replace(**upd)
    cfg = _cfg(**upd)
    jp = _jax_params(jcfg)
    params = _save_params(tmp_path, jp, cfg.model)
    outs = _spawn(tmp_path, "decode", cfg=cfg.to_json(), params=params,
                  n=N_DECODE, batch_size=DECODE_B, nbest=nbest)
    exs = make_toy_examples(N_DECODE, seed=5, img_dim=cfg.model.img_feat_dim)
    with torch.inference_mode():
        want, st1 = vt.translate_corpus(torch.load(params), cfg, exs,
                                        toy_vocab(), batch_size=DECODE_B,
                                        nbest=nbest, device="cpu")
    for out in outs:
        got = [[tuple(c) for c in h] for h in out["hyps"]] if nbest \
            else out["hyps"]
        assert got == want
        assert out["empty"][0] == []
    st = outs[0]["stats"]
    assert st["rows_per_chunk"] == DECODE_B + 1 and st["sentences"] == N_DECODE
    assert outs[1]["stats"]["chunk_steps"] == st["chunk_steps"]
    assert st["beam_loop_steps"] == sum(st["chunk_steps"]) + sum(
        st.get("phase2_steps", []))
    if path in ("chunked", "greedy", "nbest", "bf16"):
        # a chunk's trips are its slowest row's, whichever rank it rides
        _, st6 = vt.translate_corpus(torch.load(params), cfg, exs,
                                     toy_vocab(), batch_size=DECODE_B + 1,
                                     nbest=nbest, device="cpu")
        assert st["chunk_steps"] == st6["chunk_steps"]
    if not with_jax:
        return
    jwant, jst = jax_translate(jp, jcfg, exs, jax_toy_vocab(),
                               batch_size=DECODE_B, nbest=nbest,
                               mesh=jax_mesh(n_data=2, n_model=1))
    if nbest:
        jwant = [[(t, float(s)) for t, s in h] for h in jwant]
        for g, w in zip(want, jwant):
            assert [t for t, _ in g] == [t for t, _ in w]
            np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                       rtol=0, atol=1e-5)
    else:
        assert want == jwant
    for k in ("sentences", "n_chunks", "rows_per_chunk", "streaming",
              "two_phase"):
        assert st.get(k) == jst.get(k), k
    assert len(st["chunk_steps"]) == len(jst["chunk_steps"])
    assert len(st.get("phase2_steps", [])) == len(jst.get("phase2_steps", []))
    assert jax.device_count() >= 2


# ---------------------------------------------------------------------------
# The command line under torch.distributed.run
# ---------------------------------------------------------------------------

CLI_STEPS = 4


def _torchrun(argv, what):
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "-m", "vag_nmt_tpu_torch", *argv,
         "--device", "cpu"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    return _wait_all([p], what)[0]


def test_cli_under_torchrun_matches_one_process(tmp_path, capsys):
    """train and translate under ``python -m torch.distributed.run
    --nproc-per-node 2`` on the CPU (gloo): the final checkpoint equals
    one process's within the loop tolerances, translate writes the one
    process's file from the same checkpoint, and each result line is
    printed once (rank 0)."""
    from vag_nmt_tpu_torch import cli
    from vag_nmt_tpu_torch.train.checkpoint import load_checkpoint

    from tests.test_torch_cli import write_data_dir

    data = str(tmp_path / "data")
    os.makedirs(data)
    write_data_dir(data)
    train = ["train", "--preset", "toy", "--data-dir", data,
             "--max-steps", str(CLI_STEPS), "--set",
             f"train.eval_every_steps={CLI_STEPS}"]
    one, dp = str(tmp_path / "one"), str(tmp_path / "dp")
    cli.main(train + ["--out-dir", one, "--device", "cpu"])
    log = _torchrun(train + ["--out-dir", dp], "torchrun train")
    assert log.count('"steps": 4.0') == 1, log[-3000:]
    assert "backend gloo" in log
    a, _ = load_checkpoint(os.path.join(one, "checkpoints"), "last",
                           device="cpu")
    b, meta = load_checkpoint(os.path.join(dp, "checkpoints"), "last",
                              device="cpu")
    assert a.step == b.step == CLI_STEPS
    assert meta["data_parallel"] == {"n_data": 2, "n_model": 1,
                                     "backend": "gloo"}
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=2e-3, atol=2e-4)
    tr = ["translate", "--data-dir", data, "--checkpoint", one, "--split",
          "test"]
    cli.main(tr + ["--output", str(tmp_path / "one.txt"), "--device", "cpu"])
    capsys.readouterr()
    log = _torchrun(tr + ["--output", str(tmp_path / "dp.txt")],
                    "torchrun translate")
    assert log.count("sentences_per_sec") == 1, log[-3000:]
    assert (tmp_path / "dp.txt").read_bytes() == \
        (tmp_path / "one.txt").read_bytes()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker_main(sys.argv[2:])
