"""PyTorch port, seeded init at any intra-op thread count, on the CPU.

torch's CPU QR, which draws the orthogonal init, rounds apart with the
thread count at ``m30k_ende_vag``'s widths. ``init_params`` draws under
one thread whatever the caller's count, so one seed gives the same bits
in every process: here at 1, 2, 4 and 8 threads, and in two gloo ranks started at
different counts (``python -m tests.test_torch_init_threads --worker
...``, spawned through ``tests/test_torch_parallel._spawn``) building
their replicated state through ``create_train_state(mesh=make_mesh(2,
1))``. Equality is bit for bit."""

import hashlib
import json
import os
import sys

import pytest
import torch

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.models import model as model_mod
from vag_nmt_tpu_torch.parallel import sharding
from vag_nmt_tpu_torch.parallel.sharding import make_mesh
from vag_nmt_tpu_torch.train.state import create_train_state, tree_leaves

MODULE = "tests.test_torch_init_threads"
SEED = 5
RANK_THREADS = (1, 4)


def _cfg():
    return vt.preset("m30k_ende_vag")


def _digests(params):
    """sha256 of each leaf's bytes, in tree order."""
    return [hashlib.sha256(x.detach().contiguous().numpy().tobytes()).hexdigest()
            for x in tree_leaves(params)]


@pytest.fixture(scope="module")
def one_thread_draw():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return vt.init_params(_cfg().model, torch.Generator().manual_seed(SEED),
                              device="cpu")
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("threads", [1, 2, 4, 8])
def test_init_params_is_bit_identical_at_any_thread_count(threads,
                                                          one_thread_draw):
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        p = vt.init_params(_cfg().model, torch.Generator().manual_seed(SEED),
                           device="cpu")
        assert torch.get_num_threads() == threads      # the caller's count back
    finally:
        torch.set_num_threads(n)
    a, b = tree_leaves(one_thread_draw), tree_leaves(p)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_init_params_restores_the_thread_count_when_a_draw_raises(monkeypatch):
    def boom(*_):
        raise RuntimeError("draw failed")

    monkeypatch.setattr(model_mod.enc, "init_encoder", boom)
    n = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        with pytest.raises(RuntimeError, match="draw failed"):
            vt.init_params(_cfg().model, torch.Generator().manual_seed(0),
                           device="cpu")
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Two gloo ranks at different thread counts
# ---------------------------------------------------------------------------

def _w_state(mesh, a):
    torch.set_num_threads(a["threads"][mesh.rank])
    state = create_train_state(_cfg(), torch.Generator().manual_seed(a["seed"]),
                               device="cpu", mesh=mesh)
    return {"threads": torch.get_num_threads(),
            "params": _digests(state.params),
            "mu": _digests(state.mu)}


WORKERS = {"state": _w_state}


def _worker_main(argv):
    task, rank, world, store, args_path = argv
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank,
                      LOCAL_WORLD_SIZE=world)
    import torch.distributed as dist

    sharding.init_distributed("cpu", init_method=f"file://{store}")
    mesh = make_mesh(2, 1)
    assert (mesh.n_data, mesh.n_model, mesh.backend) == (2, 1, "gloo")
    with open(args_path) as f:
        args = json.load(f)
    out = WORKERS[task](mesh, args)
    torch.save(out, f"{args['out']}.{rank}.pt")
    dist.destroy_process_group()


def test_gloo_ranks_at_different_thread_counts_draw_the_same_state(tmp_path):
    from tests.test_torch_parallel import _spawn

    outs = _spawn(tmp_path, "state", world=2, module=MODULE, seed=SEED,
                  threads=list(RANK_THREADS))
    assert [o["threads"] for o in outs] == list(RANK_THREADS)
    n = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        state = create_train_state(_cfg(), torch.Generator().manual_seed(SEED),
                                   device="cpu")
    finally:
        torch.set_num_threads(n)
    one = _digests(state.params)
    assert outs[0]["params"] == outs[1]["params"] == one
    assert outs[0]["mu"] == outs[1]["mu"] == _digests(state.mu)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker_main(sys.argv[2:])
