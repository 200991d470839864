"""Data parallelism over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/sharding.py``).

The JAX package builds a ('data', 'model') device mesh and lets GSPMD
insert the collectives. Here every rank is a process (started by
``python -m torch.distributed.run``, which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``)
and the port's ``Mesh`` names the process group and this rank's place in
it. Each rank holds the whole model, takes its contiguous block of every
global batch's rows (what ``P('data')`` gives a device) and the train step
sums the gradients over the ranks in one all-reduce.

The backend follows the topology (``backend_for``): NCCL when every rank
of a host has a card of its own, gloo when ranks share a card or run on
the CPU. gloo's collectives run on host copies of the tensors. A failing
init raises; nothing falls back.

Only the data axis is ported: ``model_axis > 1`` (the vocab-dim tensor
parallelism of ``_TP_RULES``) raises NotImplementedError. Unlike
``jax.make_mesh``, ``make_mesh`` takes the whole world: a process left
outside the mesh would only idle."""

from __future__ import annotations

import sys
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from vag_nmt_tpu_torch.core.device import (DeviceLike, resolve_device,
                                           world_env)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# The bit patterns an exact gather sums (one rank's value, zeros elsewhere)
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def backend_for(device: torch.device, local_world: int, n_cards: int) -> str:
    """The backend rule: "nccl" when the ranks run on cards and each rank
    of the host has one of its own (``n_cards >= local_world``), "gloo"
    when they share a card or run on the CPU."""
    if device.type == "cuda" and n_cards >= local_world:
        return "nccl"
    return "gloo"


def init_distributed(device: DeviceLike = None, *,
                     init_method: Optional[str] = None) -> torch.device:
    """Join the process group torchrun's environment describes (a no-op
    when already joined) and return this rank's device: None means the
    card, ``cuda:LOCAL_RANK`` where the host has a card for every local
    rank and ``cuda:0`` shared otherwise (``core/device.resolve_device``).
    init_method: a torch.distributed URL (default ``env://``, from
    ``MASTER_ADDR`` / ``MASTER_PORT``; a test passes ``file://...``). The
    backend (``backend_for``) is logged to stderr; ``make_mesh`` records
    it. Raises outside a launch of more than one process."""
    env = world_env()
    if env is None:
        raise RuntimeError("init_distributed needs WORLD_SIZE > 1 and RANK "
                           "(python -m torch.distributed.run sets them)")
    dev = resolve_device(device)
    if dist.is_initialized():
        return dev
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = backend_for(dev, env["local_world"], n_cards)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=env["rank"], world_size=env["world"], **kw)
    print(f"[data parallel] rank {env['rank']} of {env['world']}: backend "
          f"{backend}, device {dev}", file=sys.stderr)
    return dev


class Mesh(NamedTuple):
    """The ('data', 'model') mesh over the process group. Ranks are laid
    out data-major (rank = data_index * n_model + model_index), as
    ``jax.make_mesh``'s device grid; the data group is the world while
    n_model is 1, the only size ported."""
    n_data: int
    n_model: int
    rank: int
    data_index: int
    model_index: int
    backend: str          # "nccl" | "gloo" | "none" (one process)

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes files and logs."""
        return self.rank == 0

    def comm_device(self) -> torch.device:
        """Where a collective's buffer lies: this rank's card for NCCL, the
        host for gloo (which copies CUDA tensors to the host itself)."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The reduction over the data axis of ``t`` ("sum" or "max"), a
        new tensor on t's device (t is left as it is)."""
        if self.n_data == 1:
            return t
        buf = t.detach().to(self.comm_device(), copy=True).contiguous()
        dist.all_reduce(buf, op=_OPS[op])
        return buf.to(t.device)

    def gather_rows(self, local: torch.Tensor, rows, total: int) -> torch.Tensor:
        """The (total, ...) tensor whose ``rows`` (an index array or slice
        of this rank's rows; the ranks' rows are disjoint and cover total)
        are this rank's ``local``: on every rank, bit for bit. One
        all-reduce of the rows' bit patterns (floats as integers, bf16
        through fp32), each summed with zeros only."""
        if self.n_data == 1:
            return local
        dtype = local.dtype
        wide = local.to(torch.float32) if dtype in (torch.bfloat16,
                                                    torch.float16) else local
        bits = _BITS.get(wide.dtype)
        full = torch.zeros((total,) + tuple(local.shape[1:]), dtype=wide.dtype,
                           device=local.device)
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(rows).to(local.device)
        full[rows] = wide.detach()
        if bits is not None:
            full = self.all_reduce(full.view(bits)).view(wide.dtype)
        else:
            full = self.all_reduce(full.to(torch.int64)).to(wide.dtype)
        return full.to(dtype)

    def barrier(self) -> None:
        """Every rank waits here for the others (an all-reduce of one
        element on the backend's own device)."""
        self.all_reduce(torch.zeros(1))

    def rows(self, total: int) -> slice:
        """This rank's contiguous block of a batch of ``total`` rows, what
        ``P('data')`` gives a device. Raises ValueError unless the data
        axis divides total, as the JAX kernels' shard check does."""
        if total % self.n_data:
            raise ValueError(f"batch of {total} rows does not split over "
                             f"{self.n_data} data-parallel ranks")
        n = total // self.n_data
        return slice(self.data_index * n, (self.data_index + 1) * n)


def make_mesh(n_data: int = -1, n_model: int = 1) -> Mesh:
    """The mesh over the whole process group (one process when none was
    joined). n_data == -1 takes the world over n_model. Raises ValueError
    where n_data x n_model is not the world size, and NotImplementedError
    for n_model > 1."""
    if n_model > 1:
        raise NotImplementedError(
            f"model_axis={n_model}: vocab-dim tensor parallelism (the "
            "embedding, readout and output-projection tables sharded on the "
            "vocab over 'model') is the next slice of the PyTorch port")
    n_model = max(1, n_model)
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    if n_data == -1:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh ({n_data} data x {n_model} model) must take "
                         f"the whole world of {world} processes")
    backend = dist.get_backend() if joined else "none"
    return Mesh(n_data=n_data, n_model=n_model, rank=rank,
                data_index=rank // n_model, model_index=rank % n_model,
                backend=str(backend))


def host_shard(items: Sequence, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> List:
    """This process's slice of a corpus, items[i::n] (the JAX package's
    host_shard); the whole list in one process."""
    joined = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if joined else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if joined else 1) if process_count is None \
        else process_count
    if pc <= 1:
        return list(items)
    return list(items)[pi::pc]


def rows_of_chunks(n_chunks: int, B: int, mesh: Mesh) -> np.ndarray:
    """This rank's rows of ``n_chunks`` chunks of B rows each, laid end to
    end: its contiguous B / n_data rows of every chunk, in order."""
    r = mesh.rows(B)
    return (np.arange(n_chunks)[:, None] * B
            + np.arange(r.start, r.stop)[None, :]).reshape(-1)


class BatchShard(NamedTuple):
    """This rank's rows [start, stop) of a global batch of ``total`` rows,
    with what the joint loss needs of the whole batch: its target-token
    count (the CE's normalizer) and its sample mask (the VSE loss's
    anchors and negatives)."""
    mesh: Mesh
    start: int
    stop: int
    total: int
    ntokens: torch.Tensor                 # () fp32, the global batch's
    sample_mask: Optional[torch.Tensor]   # (total,) or None

    def splice(self, local: torch.Tensor) -> torch.Tensor:
        """The global (total, ...) tensor: the other ranks' rows gathered
        (constants to autograd) around this rank's live ``local`` rows. A
        function of it differentiates to the global function's gradient
        with respect to this rank's rows."""
        rows = slice(self.start, self.stop)
        g = self.mesh.gather_rows(local.detach(), rows, self.total)
        return torch.cat([g[:self.start], local, g[self.stop:]])
