"""PyTorch port, vocab-dim tensor parallelism (a mesh with a model axis:
``parallel/sharding.py``'s ``_TP_RULES``, ``parallel/tensor.py``) on the
CPU: gloo ranks spawned with ``tests/test_torch_parallel.py``'s helpers,
each a process of this file (``python -m tests.test_torch_tensor_parallel
--worker <task> <rank> <world> <store> <args.json>``, the mesh shape in
the args), held against the port's single process and the JAX package.

Tolerances: the vocab-parallel CE and its logit grads 1e-6 against
``log_softmax`` on the whole row, accuracy exact; the merged readout top-K
ids exact (inputs without near ties), scores 1e-6 of their largest term;
one TP step against
JAX's single device rtol 1e-5 / atol 1e-6 (loss) and 3e-4 / 1e-5
(params), ``tests/test_distributed.py``'s; four loop steps against the
JAX package's (data=2, model=2) mesh within ``tests/test_train.py``'s TP
tolerances, 2e-4 / 2e-5 (losses) and 2e-3 / 2e-4 (params). The
replicated leaves stay bit-identical on every rank. Decode is exact.
Uneven vocabularies (V = 67, 9) are held against one process."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.data.batching import Example
from vag_nmt_tpu_torch.data.datasets import make_toy_examples, toy_vocab
from vag_nmt_tpu_torch.parallel import sharding
from vag_nmt_tpu_torch.parallel.sharding import (Mesh, gather_tree, make_mesh,
                                                 shard_tree, sharded_leaves)
from vag_nmt_tpu_torch.train.state import state_from_params, tree_leaves

from tests.test_torch_parallel import (_cfg, _jax_params, _leaves,
                                       _loop_data, _loop_losses, _save_params,
                                       _spawn, _torchrun)

MODULE = "tests.test_torch_tensor_parallel"
LOOP_STEPS = 4
RUN_GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "jax_run_toy")

torch.set_num_threads(1)


def _tp_spawn(tmp_path, task, n_data, n_model, **args):
    return _spawn(tmp_path, task, world=n_data * n_model, module=MODULE,
                  n_data=n_data, n_model=n_model, **args)


def _replicated(params):
    """The leaves every rank holds whole, in tree_leaves order."""
    return [x.detach().numpy() for x, s in
            zip(tree_leaves(params), sharded_leaves(params)) if not s]


def _golden_examples(m):
    """The 24 examples of the JAX package's beam golden
    (``tests/test_torch_jax_run.py``)."""
    rng = np.random.RandomState(13)
    return [Example(src=list(rng.randint(4, m.src_vocab_size,
                                         rng.randint(3, 14))),
                    img=rng.randn(m.img_feat_dim).astype(np.float32), index=i)
            for i in range(24)]


def _readout_case(V, K, seed, ban=False, B=4):
    """Inputs of fused_readout_topk without near ties: logits t @ w + b
    apart by far more than the sums' rounding."""
    rng = np.random.RandomState(seed)
    E = 16
    t = rng.randn(B * K, E).astype(np.float32)
    w = rng.randn(E, V).astype(np.float32)
    b = rng.randn(V).astype(np.float32)
    scores = np.sort(rng.randn(B, K).astype(np.float32), 1)[:, ::-1].copy()
    finished = rng.rand(B, K) < 0.25
    finished[:, 0] = False
    out = {"t": t, "w": w, "b": b, "scores": scores, "finished": finished}
    if ban:
        out["ban"] = rng.randint(0, V + 1, (B * K, 3)).astype(np.int64)
    return out


def _readout_args(c):
    return dict(t=torch.from_numpy(c["t"]), w=torch.from_numpy(c["w"]),
                b=torch.from_numpy(c["b"]),
                scores=torch.from_numpy(c["scores"]),
                finished=torch.from_numpy(c["finished"]),
                ban=None if "ban" not in c else torch.from_numpy(c["ban"]))


# (V, K, ban, slots, defer, world) of the fused readout's cases
READOUT_CASES = {
    "k3": (64, 3, False, 0, False, 2),
    "k5_ban": (64, 5, True, 0, False, 2),
    "k20": (64, 20, False, 0, False, 2),
    "uneven_k5": (67, 5, True, 0, False, 2),
    "narrow_slices": (9, 3, False, 0, False, 4),
    "slots1_recovered": (64, 5, False, 1, False, 2),
    "slots1_deferred": (64, 5, False, 1, True, 2),
}


# ---------------------------------------------------------------------------
# Workers (run in the spawned ranks)
# ---------------------------------------------------------------------------

def _w_mesh(mesh, a):
    """The rank's place, its groups' members (through a sum of one-hot
    rank vectors over each group), a gather over the model group and the
    sums from the model group (of live values, and of one owner's value
    an element: a vector holding 2.5 / (rank + 1) and -0.0 at this rank's
    index, zeros elsewhere)."""
    from vag_nmt_tpu_torch.parallel.tensor import reduce_from_model

    world = mesh.n_data * mesh.n_model
    onehot = torch.zeros(world)
    onehot[mesh.rank] = 1.0
    owned = torch.zeros(2 * world)
    owned[2 * mesh.rank] = 2.5 / (mesh.rank + 1)
    owned[2 * mesh.rank + 1] = -0.0
    return {"place": (mesh.rank, mesh.data_index, mesh.model_index),
            "reduced": reduce_from_model(onehot * (mesh.rank + 1),
                                         mesh).tolist(),
            "owned": reduce_from_model(owned, mesh, owned=True).numpy(),
            "data_members": mesh.all_reduce(onehot).nonzero()[:, 0].tolist(),
            "model_members": mesh.model_all_reduce(onehot
                                                   ).nonzero()[:, 0].tolist(),
            "gathered": mesh.model_all_gather(
                torch.tensor([[mesh.rank, -mesh.rank]])).tolist(),
            "slices": {V: mesh.vocab_slice(V) for V in a["vocabs"]}}


def _w_ce(mesh, a):
    """The vocab-parallel CE, accuracy and logit grads of this rank's
    slice of the rows in a["logits"]."""
    from vag_nmt_tpu_torch.parallel.tensor import (
        vocab_parallel_argmax, vocab_parallel_log_softmax_target, vocab_shard)

    data = np.load(a["data"])
    logits = torch.from_numpy(data["logits"])
    tgt = torch.from_numpy(data["target"])
    vocab = vocab_shard(mesh, logits.shape[-1])
    piece = logits[..., vocab.v0:vocab.v1].clone().requires_grad_(True)
    logp = vocab_parallel_log_softmax_target(piece, tgt, vocab)
    (logp * torch.from_numpy(data["weight"])).sum().backward()
    return {"logp": logp.detach().numpy(), "grad": piece.grad.numpy(),
            "argmax": vocab_parallel_argmax(piece.detach(), vocab).numpy(),
            "bounds": (vocab.v0, vocab.v1)}


def _w_readout(mesh, a):
    """fused_readout_topk on this rank's slice for each case of
    a["cases"] (their inputs in a["data"])."""
    from vag_nmt_tpu_torch.ops.readout_topk import fused_readout_topk
    from vag_nmt_tpu_torch.parallel.tensor import vocab_shard

    out = {}
    for name in a["cases"]:
        V, K, _, slots, defer, _ = READOUT_CASES[name]
        c = _readout_args(dict(np.load(f"{a['data']}_{name}.npz")))
        vocab = vocab_shard(mesh, V)
        r = fused_readout_topk(c["t"], c["w"][:, vocab.v0:vocab.v1],
                               c["b"][vocab.v0:vocab.v1], c["scores"],
                               c["finished"], c["ban"], slots=slots,
                               defer_exact=defer, vocab=vocab)
        out[name] = [x.numpy() for x in r]
    return out


def _w_step(mesh, a):
    """One make_train_step(mesh=) step from the params in a["params"]
    (sliced here): the aux and the params after it, gathered, and the
    replicated leaves as this rank holds them."""
    cfg = vt.Config.from_json(a["cfg"])
    params = shard_tree(torch.load(a["params"]), mesh)
    batch = dict(np.load(a["batch"]))
    state, aux = vt.make_train_step(cfg, mesh=mesh)(
        state_from_params(cfg, params), batch)
    return {"aux": {k: float(v) for k, v in aux.items()},
            "params": _leaves(gather_tree(state.params, mesh)),
            "replicated": _replicated(state.params)}


def _w_loop(mesh, a):
    """train_loop(mesh=) for LOOP_STEPS steps (resuming from the step-0
    checkpoint the parent wrote), the state of its last save as this rank
    holds it (its slices and replicated leaves) and the checkpoint read
    back under the mesh."""
    from vag_nmt_tpu_torch.train import loop
    from vag_nmt_tpu_torch.train.checkpoint import load_checkpoint

    saved = {}
    write = loop.save_checkpoint

    def capture(ckpt_dir, tag, state, meta=None, *, mesh=None):
        saved[tag] = state
        return write(ckpt_dir, tag, state, meta, mesh=mesh)

    loop.save_checkpoint = capture
    cfg = vt.Config.from_json(a["cfg"])
    train, dev, vocab, refs = _loop_data(cfg)
    res = vt.train_loop(cfg, a["run"], train, dev, vocab, refs, mesh=mesh,
                        max_steps=LOOP_STEPS, device="cpu")
    last = saved["last"]
    again, meta = load_checkpoint(os.path.join(a["run"], "checkpoints"),
                                  "last", device="cpu", mesh=mesh)
    return {"result": res, "meta": meta,
            "gathered": _leaves(gather_tree(last.params, mesh)),
            "replicated": _replicated(last.params),
            "slices": _leaves(last.params),
            "reloaded": _leaves(again.params)}


def _w_decode(mesh, a):
    """translate_corpus(mesh=) of the JAX-trained toy run's best params
    (their slices) in each mode of a["modes"]: {mode: (hyps, stats)}."""
    from vag_nmt_tpu_torch.train.checkpoint import load_checkpoint

    cfg = vt.Config.from_json(a["cfg"])
    if a.get("params"):
        params = shard_tree(torch.load(a["params"]), mesh)
    else:
        state, _ = load_checkpoint(os.path.join(RUN_GOLDEN, "checkpoints"),
                                   "best", device="cpu", cfg=cfg.model,
                                   mesh=mesh)
        params = state.params
    exs = _golden_examples(cfg.model)
    out = {}
    with torch.inference_mode():
        for mode in a["modes"]:
            c, kw, env = _decode_mode(cfg, mode)
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                out[mode] = vt.translate_corpus(params, c, exs, toy_vocab(),
                                                mesh=mesh, device="cpu", **kw)
            finally:
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
    return out


def _w_ckpt(mesh, a):
    """A one-process checkpoint read under the mesh (this rank's slices),
    then written back under it (every rank gathers, rank 0 writes)."""
    from vag_nmt_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)

    state, meta = load_checkpoint(a["src"], "last", device="cpu", mesh=mesh)
    save_checkpoint(a["dst"], "last", state, meta, mesh=mesh)
    mesh.barrier()
    return {"params": _leaves(state.params), "mu": _leaves(state.mu)}


WORKERS = {"mesh": _w_mesh, "ce": _w_ce, "readout": _w_readout,
           "step": _w_step, "loop": _w_loop, "decode": _w_decode,
           "ckpt": _w_ckpt}


def _worker_main(argv):
    task, rank, world, store, args_path = argv
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank,
                      LOCAL_WORLD_SIZE=world)
    import torch.distributed as dist

    sharding.init_distributed("cpu", init_method=f"file://{store}")
    with open(args_path) as f:
        args = json.load(f)
    mesh = make_mesh(n_data=args["n_data"], n_model=args["n_model"])
    assert mesh.backend == "gloo"
    out = WORKERS[task](mesh, args)
    torch.save(out, f"{args['out']}.{rank}.pt")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V,n", [(64, 2), (67, 2), (9, 4), (64, 4), (67, 4)])
def test_vocab_slices_are_balanced_and_contiguous(V, n):
    """Slice j of n is tensor_split's: the first V % n one row longer,
    end to end over [0, V)."""
    want = [(int(c[0]), int(c[-1]) + 1)
            for c in torch.tensor_split(torch.arange(V), n)]
    got = [Mesh(n_data=1, n_model=n, rank=j, data_index=0, model_index=j,
                backend="gloo").vocab_slice(V) for j in range(n)]
    assert got == want


def test_tp_rules_are_the_jax_packages():
    """param_spec as the JAX package's _spec_for under use_tp, on every
    path of the toy tree; the sliced leaves: the three kinds."""
    from vag_nmt_tpu.parallel.sharding import _spec_for

    params = vt.init_params(_cfg().model, torch.Generator().manual_seed(0),
                            device="cpu")
    paths = []
    sharding._map_paths(lambda p, x: paths.append(p), params)
    for p in paths:
        assert sharding.param_spec(p) == tuple(_spec_for(p, True)), p
    assert sorted(p for p in paths if sharding.vocab_dim(p) is not None) == [
        "decoder/embed/table", "decoder/readout/b_out",
        "decoder/readout/w_out", "encoder/embed/table"]


def test_shard_and_gather_tree_are_inverse_in_one_process():
    """Without a model axis both are the identity; the slices of a tree
    cover each sliced leaf once, in order."""
    params = vt.init_params(_cfg().model, torch.Generator().manual_seed(0),
                            device="cpu")
    assert shard_tree(params, None) is params
    assert gather_tree(params, make_mesh()) is params
    full = params["decoder"]["readout"]["w_out"]
    parts = [shard_tree(params, Mesh(1, 2, j, 0, j, "gloo"))
             for j in range(2)]
    assert torch.equal(torch.cat([p["decoder"]["readout"]["w_out"]
                                  for p in parts], 1), full)
    assert parts[1]["decoder"]["readout"]["w_out"].is_contiguous()
    assert torch.equal(parts[0]["init"]["w_ctx"], params["init"]["w_ctx"])


def test_mesh_2x2_groups_and_layout(tmp_path):
    """Four ranks as (data=2, model=2): data-major places, each data group
    the ranks of one model index, each model group those of one data
    index, a model gather in model-index order, and every rank's vocab
    slices."""
    outs = _tp_spawn(tmp_path, "mesh", 2, 2, vocabs=[64, 67, 9])
    for r, out in enumerate(outs):
        d, j = r // 2, r % 2
        assert tuple(out["place"]) == (r, d, j)
        assert out["data_members"] == [j, 2 + j]
        assert out["model_members"] == [2 * d, 2 * d + 1]
        assert out["gathered"] == [[2 * d, -2 * d], [2 * d + 1, -2 * d - 1]]
        assert out["reduced"] == [float(k + 1) if k // 2 == d else 0.0
                                  for k in range(4)]
        want = np.zeros(8, np.float32)
        for k in (2 * d, 2 * d + 1):
            want[2 * k] = np.float32(2.5) / np.float32(k + 1)
            want[2 * k + 1] = -0.0
        assert out["owned"].tobytes() == want.tobytes()
        assert out["slices"] == {64: (32 * j, 32 * j + 32),
                                 67: ((0, 34), (34, 67))[j],
                                 9: ((0, 5), (5, 9))[j]}


# ---------------------------------------------------------------------------
# The vocab-parallel operations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [64, 67])
def test_vocab_parallel_ce_and_argmax(tmp_path, V):
    """On 2 ranks, log p(target), its logit grads and the argmax against
    log_softmax and argmax on the whole rows: 1e-6, the argmax exact (a
    tie across the slices' seam goes to the smaller id)."""
    rng = np.random.RandomState(V)
    logits = (3 * rng.randn(6, 5, V)).astype(np.float32)
    logits[0, 0, [30, 40]] = logits[0, 0].max() + 1.0     # a tie over the seam
    target = rng.randint(0, V, (6, 5))
    weight = rng.rand(6, 5).astype(np.float32)
    np.savez(tmp_path / "ce.npz", logits=logits, target=target, weight=weight)
    outs = _tp_spawn(tmp_path, "ce", 1, 2, data=str(tmp_path / "ce.npz"))
    x = torch.from_numpy(logits).requires_grad_(True)
    want = torch.gather(torch.log_softmax(x, -1), -1,
                        torch.from_numpy(target)[..., None])[..., 0]
    (want * torch.from_numpy(weight)).sum().backward()
    for out in outs:
        np.testing.assert_allclose(out["logp"], want.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
        a, b = out["bounds"]
        np.testing.assert_allclose(out["grad"], x.grad.numpy()[..., a:b],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(out["argmax"], logits.argmax(-1))
    assert outs[0]["argmax"][0, 0] == 30
    assert np.array_equal(outs[0]["logp"], outs[1]["logp"])


@pytest.mark.parametrize("slots", [0, 1])
def test_readout_rows_on_a_slice_write_global_ids_and_lse_terms(slots):
    """readout_topk_rows on columns [v0, v1) of W with id_base = v0: the
    ids of the whole W's rows restricted to the slice, and with
    lse_parts the terms (M, S) of the slice's lse = M + log(S)."""
    from vag_nmt_tpu_torch.ops.readout_topk import readout_topk_rows

    c = _readout_case(67, 5, seed=3)
    t, w, b = (torch.from_numpy(c[k]) for k in ("t", "w", "b"))
    v0, v1 = 34, 67
    got = readout_topk_rows(t, w[:, v0:v1], b[v0:v1], 5, slots=slots,
                            id_base=v0)
    parts = readout_topk_rows(t, w[:, v0:v1], b[v0:v1], 5, slots=slots,
                              id_base=v0, lse_parts=True)
    base0 = readout_topk_rows(t, w[:, v0:v1], b[v0:v1], 5, slots=slots)
    assert torch.equal(got[1], base0[1] + v0)
    logits = t @ w[:, v0:v1] + b[v0:v1]
    if not slots:
        want = torch.sort(logits, dim=-1, descending=True, stable=True)
        assert torch.equal(got[1].long(), want.indices[:, :5] + v0)
    assert torch.equal(parts[1], got[1]) and torch.equal(parts[0], got[0])
    m, ssum = parts[2].T
    assert torch.equal(m, logits.amax(-1))
    torch.testing.assert_close(m + torch.log(ssum), got[2], rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(got[2], torch.logsumexp(logits, -1),
                               rtol=1e-6, atol=1e-6)


def _readout_want(c, K, slots):
    """One process's fused_readout_topk on the whole W (plain route): at
    depth K, and at the slot depth with the deferred flag."""
    from vag_nmt_tpu_torch.ops.readout_topk import fused_readout_topk

    args = _readout_args(c)
    depth = fused_readout_topk(**args, impl="plain", slots=K)
    shallow = fused_readout_topk(**args, impl="plain", slots=slots or K,
                                 defer_exact=True)
    return depth, shallow[2]


@pytest.mark.parametrize("world", [2, 4])
def test_fused_readout_on_vocab_slices(tmp_path, world):
    """fused_readout_topk(vocab=) on each rank's slice of W against one
    process on the whole W: the ids exact and the scores within 1e-6 of
    the largest term they sum (the merged lse rounds apart from the
    one-pass lse) at K = 3, 5, 20, with a ban, at V = 67, on slices
    narrower than K (V = 9 over 4 ranks, K = 3), and at slots 1 with the
    per-step recovery (the depth-K result) or deferred (the flag a
    superset of one process's: the slices' lanes are the whole row's at
    V = 64); every rank the same bits."""
    cases = [n for n, c in READOUT_CASES.items() if c[5] == world]
    for n in cases:
        V, K, ban, *_ = READOUT_CASES[n]
        np.savez(tmp_path / f"ro_{n}.npz",
                 **_readout_case(V, K, seed=len(n) + V, ban=ban))
    outs = _tp_spawn(tmp_path, "readout", 1, world, cases=cases,
                     data=str(tmp_path / "ro"))
    for n in cases:
        V, K, _, slots, defer, _ = READOUT_CASES[n]
        c = dict(np.load(tmp_path / f"ro_{n}.npz"))
        (top, flat), flag = _readout_want(c, K, slots)
        logits = c["t"] @ c["w"] + c["b"]
        scale = np.abs(c["scores"]).max() + np.abs(logits).max() + np.log(V)
        for out in outs:
            got = out[n]
            np.testing.assert_array_equal(got[1], flat.numpy(), err_msg=n)
            np.testing.assert_allclose(got[0], top.numpy(), rtol=0,
                                       atol=1e-6 * scale, err_msg=n)
            if defer:
                assert bool(got[2]) or not bool(flag), n
            for a, b in zip(got, outs[0][n]):
                assert np.array_equal(a, b), n


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def test_tp_step_matches_jax_single_device(tmp_path):
    """A (1 x 2) step on the global batch of ``tests/dist_common.py``
    from the bridged JAX init against the JAX package's single-device
    make_train_step: the DP test's tolerances; the replicated leaves the
    same bits on both ranks."""
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
    outs = _tp_spawn(tmp_path, "step", 1, 2, cfg=cfg.to_json(), params=params,
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
    for a, b in zip(outs[0]["replicated"], outs[1]["replicated"]):
        assert np.array_equal(a, b)


def test_tp_train_loop_matches_jax_mesh(tmp_path):
    """Four train_loop(mesh=) steps on a (data=2, model=2) mesh, resumed
    from a one-process step-0 checkpoint of the JAX init (read sliced),
    against the JAX package's make_train_step under make_mesh(n_data=2,
    n_model=2) on the same batch stream: tests/test_train.py's TP
    tolerances; the replicated leaves the same bits on all four ranks;
    the run's checkpoint, read in one process, the gathered state of its
    last save, and read back under the mesh, each rank's slices."""
    import jax

    from vag_nmt_tpu.core.config import preset as jax_preset
    from vag_nmt_tpu.data.batching import BucketBatcher as JBatcher
    from vag_nmt_tpu.decode.translate import build_img_table
    from vag_nmt_tpu.parallel.sharding import make_mesh as jax_mesh
    from vag_nmt_tpu.train.state import create_train_state
    from vag_nmt_tpu.train.step import make_train_step as jax_step

    from vag_nmt_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from vag_nmt_tpu_torch.train.loop import _step_rows

    tr = dict(eval_every_steps=0, log_every_steps=1, steps_per_dispatch=2,
              resume=True)
    jcfg = jax_preset("toy").replace(train=tr)
    cfg = _cfg(train=tr)
    jstate = create_train_state(jax.random.key(cfg.train.seed), jcfg)
    run = str(tmp_path / "tp")
    tp = vt.params_from_numpy(jax.device_get(jstate.params), cfg.model,
                              device="cpu")
    save_checkpoint(os.path.join(run, "checkpoints"), "last",
                    state_from_params(cfg, tp),
                    {"epoch": 0, "epoch_cursor": 0, "best_bleu": -1.0,
                     "evals_since_best": 0})
    outs = _tp_spawn(tmp_path, "loop", 2, 2, cfg=cfg.to_json(), run=run)

    train, _, _, _ = _loop_data(cfg)
    m = jcfg.model
    batcher = JBatcher(train, jcfg.data.batch_size, jcfg.data.length_buckets,
                       seed=jcfg.data.shuffle_seed, image_ids=True,
                       img_dim=m.img_feat_dim, compact=True)
    rows = list(_step_rows(batcher.epoch_stacked(0, 2), 0))[:LOOP_STEPS]
    feed = [{k: v for k, v in b.items() if k != "index"} for b in rows]
    step, state_sh = jax_step(jcfg, jax_mesh(n_data=2, n_model=2), jstate,
                              feed[0], with_img_table=True)
    jstate = jax.device_put(jstate, state_sh)
    table = build_img_table(train, m.img_feat_dim)
    losses = []
    for b in feed:
        jstate, aux = step(jstate, b, jax.random.key(cfg.train.seed + 1),
                           table)
        losses.append(float(aux["loss"]))
    got, recs = _loop_losses(run)
    np.testing.assert_allclose(got, losses, rtol=2e-4, atol=2e-5)
    want = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(
        jstate.params))]
    one, meta = load_checkpoint(os.path.join(run, "checkpoints"), "last",
                                device="cpu")
    assert meta["data_parallel"] == {"n_data": 2, "n_model": 2,
                                     "backend": "gloo"}
    for r, out in enumerate(outs):
        assert out["result"]["steps"] == LOOP_STEPS
        for g, w in zip(out["gathered"], want):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4)
        for g, w in zip(out["gathered"], _leaves(one.params)):
            assert np.array_equal(g, w)
        for g, w in zip(out["reloaded"], out["slices"]):
            assert np.array_equal(g, w)
        for a, b in zip(out["replicated"], outs[0]["replicated"]):
            assert np.array_equal(a, b), r
    # each rank held its own slices: the model ranks' differ
    assert outs[0]["slices"][0].shape[0] * 2 == one.params["decoder"][
        "embed"]["table"].shape[0]


def test_checkpoint_round_trip_under_tp(tmp_path):
    """A one-process checkpoint read under a (1 x 2) mesh gives each rank
    its slices (params and moments); written back under the mesh it holds
    the full tensors, equal to the original, in today's format."""
    from vag_nmt_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)

    cfg = _cfg()
    params = vt.init_params(cfg.model, torch.Generator().manual_seed(4),
                            device="cpu")
    state = state_from_params(cfg, params)
    state = state._replace(step=3, mu=params, nu=params)
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    save_checkpoint(src, "last", state, {"epoch": 1})
    outs = _tp_spawn(tmp_path, "ckpt", 1, 2, src=src, dst=dst)
    for j, out in enumerate(outs):
        want = _leaves(shard_tree(params, Mesh(1, 2, j, 0, j, "gloo")))
        for g, w in zip(out["params"], want):
            assert np.array_equal(g, w)
        for g, w in zip(out["mu"], want):
            assert np.array_equal(g, w)
    back, meta = load_checkpoint(dst, "last", device="cpu")
    assert back.step == 3 and meta["epoch"] == 1
    for g, w in zip(tree_leaves(back.params), tree_leaves(params)):
        assert torch.equal(g, w)
    for g, w in zip(tree_leaves(back.nu), tree_leaves(params)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

# mode: (cfg updates, translate_corpus kwargs, environment)
DECODE_MODES = {
    "chunked": ({}, {}, {}),
    "greedy": ({}, {"beam_size": 1}, {}),
    "nbest3": ({}, {"nbest": 3}, {}),
    "unfused": ({}, {}, {"VAG_READOUT_TOPK": "unfused"}),
    "slots1_deferred": ({}, {}, {"VAG_FRT_SLOTS": "1"}),
    "bf16": ({"decode": {"compute_dtype": "bfloat16"}}, {}, {}),
    "bf16_tables": ({"decode": {"compute_dtype": "bfloat16"}}, {},
                    {"VAG_TOKEN_TABLES": "on"}),
    "tables": ({}, {}, {"VAG_TOKEN_TABLES": "on"}),
    "dec_step": ({}, {}, {"VAG_TOKEN_TABLES": "on", "VAG_DEC_STEP": "on"}),
    "block_ngram": ({}, {}, {"VAG_BLOCK_NGRAM": "2"}),
    "greedy_block": ({}, {"beam_size": 1}, {"VAG_BLOCK_NGRAM": "2"}),
    "streaming": ({"decode": {"streaming": "on"}}, {}, {}),
    "two_phase": ({"decode": {"two_phase": "on"}}, {}, {}),
}


def _decode_mode(cfg, mode):
    upd, kw, env = DECODE_MODES[mode]
    return (cfg.replace(**upd) if upd else cfg), dict(kw, batch_size=6), env


def _single_decodes(params, cfg, modes, monkeypatch):
    out = {}
    exs = _golden_examples(cfg.model)
    with torch.inference_mode():
        for mode in modes:
            c, kw, env = _decode_mode(cfg, mode)
            with monkeypatch.context() as mp:
                for k, v in env.items():
                    mp.setenv(k, v)
                out[mode] = vt.translate_corpus(params, c, exs, toy_vocab(),
                                                device="cpu", **kw)
    return out


def test_tp_decode_of_the_jax_run_equals_one_process(tmp_path, monkeypatch):
    """translate_corpus on a (1 x 2) mesh from the JAX-trained toy run
    (tests/goldens/jax_run_toy), its params read sliced: chunked, greedy,
    nbest 3, the unfused structure (the logits gathered into whole rows),
    slots 1 deferred, the decode tables (``gy`` of the slice's rows), the
    fused step (kernel 7's plain version) and n-gram blocking (the ban on
    the slices) give one process's hypotheses exactly on both ranks;
    streaming and two-phase, asked for, run chunked and say so in the
    stats."""
    from vag_nmt_tpu_torch.train.checkpoint import load_checkpoint

    for k in ("VAG_STREAM_DECODE", "VAG_TWO_PHASE", "VAG_READOUT_TOPK",
              "VAG_FRT_SLOTS", "VAG_TOKEN_TABLES", "VAG_DEC_STEP",
              "VAG_BLOCK_NGRAM"):
        monkeypatch.delenv(k, raising=False)
    with open(os.path.join(RUN_GOLDEN, "config.json")) as f:
        cfg = vt.Config.from_json(f.read())
    state, _ = load_checkpoint(os.path.join(RUN_GOLDEN, "checkpoints"),
                               "best", device="cpu", cfg=cfg.model)
    outs = _tp_spawn(tmp_path, "decode", 1, 2, cfg=cfg.to_json(),
                     modes=sorted(DECODE_MODES))
    want = _single_decodes(state.params, cfg, DECODE_MODES, monkeypatch)
    for mode in DECODE_MODES:
        hyps, st = want["chunked" if mode in ("streaming", "two_phase")
                        else mode]
        for out in outs:
            got, gst = out[mode]
            if mode == "nbest3":
                # the texts exactly; the scores through the merged lse
                assert [[t for t, _ in h] for h in got] == \
                    [[t for t, _ in h] for h in hyps]
                np.testing.assert_allclose([s for h in got for _, s in h],
                                           [s for h in hyps for _, s in h],
                                           rtol=0, atol=1e-5)
            else:
                assert got == hyps, mode
            if mode in ("streaming", "two_phase"):
                assert gst["streaming"] is False and gst["two_phase"] is False
                assert gst["chunk_steps"] == st["chunk_steps"]
    assert any(h for h in want["chunked"][0])


def _jax_run_params(jcfg):
    """The toy run's best params as the JAX package reads them (flax's
    msgpack, into its init's tree)."""
    import jax
    from flax import serialization

    from vag_nmt_tpu.models import init_params as jax_init_params

    path = os.path.join(RUN_GOLDEN, "checkpoints", "state_best.msgpack")
    with open(path, "rb") as f:
        stored = serialization.msgpack_restore(f.read())
    tree = serialization.msgpack_restore(bytes(stored["state_bytes"]))
    like = jax.device_get(jax_init_params(jax.random.key(0), jcfg.model))
    return serialization.from_state_dict(like, tree["params"])


JAX_DECODE_MODES = ("chunked", "greedy", "nbest3")


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)])
def test_tp_decode_of_the_jax_run_equals_the_jax_mesh(tmp_path, monkeypatch,
                                                      n_data, n_model):
    """translate_corpus on an (n_data x n_model) mesh from the JAX-trained
    toy run against the JAX package's translate_corpus on its
    make_mesh(n_data, n_model) with the params' vocab sharding kept
    (param_shardings): chunked, greedy and nbest 3 give its hypotheses
    exactly on every rank (nbest: the texts exactly, the scores within
    1e-5), with its rows_per_chunk and beam steps."""
    import jax

    from vag_nmt_tpu.core.config import Config as JConfig
    from vag_nmt_tpu.data.batching import Example as JExample
    from vag_nmt_tpu.data.datasets import toy_vocab as jax_toy_vocab
    from vag_nmt_tpu.decode.translate import translate_corpus as jax_translate
    from vag_nmt_tpu.parallel.sharding import make_mesh as jax_mesh
    from vag_nmt_tpu.parallel.sharding import param_shardings

    for k in ("VAG_STREAM_DECODE", "VAG_TWO_PHASE", "VAG_READOUT_TOPK",
              "VAG_FRT_SLOTS", "VAG_TOKEN_TABLES", "VAG_DEC_STEP",
              "VAG_BLOCK_NGRAM"):
        monkeypatch.delenv(k, raising=False)
    with open(os.path.join(RUN_GOLDEN, "config.json")) as f:
        text = f.read()
    cfg, jcfg = vt.Config.from_json(text), JConfig.from_json(text)
    outs = _tp_spawn(tmp_path, "decode", n_data, n_model, cfg=cfg.to_json(),
                     modes=list(JAX_DECODE_MODES))
    mesh = jax_mesh(n_data=n_data, n_model=n_model)
    jp = _jax_run_params(jcfg)
    jp = jax.device_put(jp, param_shardings(mesh, jp))
    exs = [JExample(src=e.src, img=e.img, index=e.index)
           for e in _golden_examples(cfg.model)]
    for mode in JAX_DECODE_MODES:
        _, kw, _ = _decode_mode(cfg, mode)
        want, jst = jax_translate(jp, jcfg, exs, jax_toy_vocab(), mesh=mesh,
                                  **kw)
        for out in outs:
            got, st = out[mode]
            if mode == "nbest3":
                assert [[t for t, _ in h] for h in got] == \
                    [[t for t, _ in h] for h in want]
                np.testing.assert_allclose(
                    [s for h in got for _, s in h],
                    [float(s) for h in want for _, s in h], rtol=0, atol=1e-5)
            else:
                assert got == want, mode
            for k in ("sentences", "rows_per_chunk", "chunk_steps",
                      "beam_loop_steps"):
                assert st.get(k) == jst.get(k), (mode, k)
    assert any(h for h in outs[0]["chunked"][0])


def test_tp_decode_at_an_uneven_vocab_equals_one_process(tmp_path,
                                                         monkeypatch):
    """The chunked, unfused and greedy decodes at target V = 61 (slices
    of 31 and 30; the toy vocabulary's first 61 words) and source V = 67
    on a (1 x 2) mesh against one process."""
    for k in ("VAG_READOUT_TOPK", "VAG_FRT_SLOTS"):
        monkeypatch.delenv(k, raising=False)
    cfg = _cfg(dict(src_vocab_size=67, tgt_vocab_size=61))
    params = vt.init_params(cfg.model, torch.Generator().manual_seed(7),
                            device="cpu")
    path = str(tmp_path / "params.pt")
    torch.save(params, path)
    modes = ["chunked", "unfused", "greedy"]
    outs = _tp_spawn(tmp_path, "decode", 1, 2, cfg=cfg.to_json(),
                     params=path, modes=modes)
    want = _single_decodes(params, cfg, modes, monkeypatch)
    for out in outs:
        for mode in modes:
            assert out[mode][0] == want[mode][0], mode


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

CLI_STEPS = 4


def test_cli_under_torchrun_with_a_model_axis(tmp_path, capsys):
    """train and translate under ``python -m torch.distributed.run
    --nproc-per-node 2`` with ``--set mesh.model_axis=2`` on the CPU: the
    checkpoint (full tensors) equals one process's within the loop
    tolerances and records the mesh; translate writes one process's file
    from the same checkpoint; one process with model_axis=2 raises."""
    from vag_nmt_tpu_torch import cli
    from vag_nmt_tpu_torch.train.checkpoint import load_checkpoint

    from tests.test_torch_cli import write_data_dir

    data = str(tmp_path / "data")
    os.makedirs(data)
    write_data_dir(data)
    train = ["train", "--preset", "toy", "--data-dir", data,
             "--max-steps", str(CLI_STEPS), "--set",
             f"train.eval_every_steps={CLI_STEPS}"]
    one, tp = str(tmp_path / "one"), str(tmp_path / "tp")
    with pytest.raises(ValueError, match="whole world"):
        cli.main(train + ["--out-dir", str(tmp_path / "x"), "--device", "cpu",
                          "--set", "mesh.model_axis=2"])
    cli.main(train + ["--out-dir", one, "--device", "cpu"])
    log = _torchrun(train + ["--out-dir", tp, "--set", "mesh.model_axis=2"],
                    "torchrun train")
    assert log.count('"steps": 4.0') == 1, log[-3000:]
    a, _ = load_checkpoint(os.path.join(one, "checkpoints"), "last",
                           device="cpu")
    b, meta = load_checkpoint(os.path.join(tp, "checkpoints"), "last",
                              device="cpu")
    assert a.step == b.step == CLI_STEPS
    assert meta["data_parallel"] == {"n_data": 1, "n_model": 2,
                                     "backend": "gloo"}
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert x.shape == y.shape
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=2e-3, atol=2e-4)
    tr = ["translate", "--data-dir", data, "--checkpoint", tp, "--split",
          "test"]
    # the run's config.json holds its mesh: one process asks for none
    cli.main(tr + ["--output", str(tmp_path / "one.txt"), "--device", "cpu",
                   "--set", "mesh.model_axis=1"])
    capsys.readouterr()
    log = _torchrun(tr + ["--output", str(tmp_path / "tp.txt")],
                    "torchrun translate")
    assert log.count("sentences_per_sec") == 1, log[-3000:]
    assert (tmp_path / "tp.txt").read_bytes() == \
        (tmp_path / "one.txt").read_bytes()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker_main(sys.argv[2:])
