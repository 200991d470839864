"""Data and vocab-dim tensor parallelism over ``torch.distributed``
(counterpart of the JAX package's ``parallel/sharding.py``).

The JAX package builds a ('data', 'model') device mesh and lets GSPMD
insert the collectives. Here every rank is a process (started by
``python -m torch.distributed.run``, which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``)
and the port's ``Mesh`` names this rank's place in the (n_data, n_model)
grid, laid out data-major, and the process groups of its two axes.

Data axis: each data index takes its contiguous block of every global
batch's rows (what ``P('data')`` gives a device) and the train step sums
the gradients over the data group in one all-reduce.

Model axis (``_TP_RULES``, the JAX package's): the embedding tables are
held as contiguous row slices of the vocab, the output projection
``w_out`` as the matching column slice and ``b_out`` as the matching
entries, balanced as ``torch.tensor_split`` splits (``vocab_slice``);
every other leaf is replicated. ``parallel/tensor.py`` holds the
vocab-parallel operations that replace GSPMD's partitioned softmax,
gathers and top-K; ``shard_tree`` and ``gather_tree`` move a whole tree
between its full and its sliced form.

The backend follows the topology (``backend_for``): NCCL when every rank
of a host has a card of its own, gloo when ranks share a card or run on
the CPU. gloo's collectives run on host copies of the tensors. A failing
init raises; nothing falls back. Unlike ``jax.make_mesh``, ``make_mesh``
takes the whole world: a process left outside the mesh would only
idle."""

from __future__ import annotations

import re
import sys
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vag_nmt_tpu_torch.core.device import (DeviceLike, resolve_device,
                                           world_env)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# The bit patterns an exact gather sums (one rank's value, zeros elsewhere;
# ``_exact_sum``)
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


def _exact_sum(full: torch.Tensor, reduce) -> torch.Tensor:
    """``reduce`` (a sum over ranks) of ``full``, each of whose elements
    is one rank's value and zeros on the others, bit for bit: floats
    summed as their bit patterns (bf16 / fp16 through fp32), integers and
    bools as int32 or int64."""
    dtype = full.dtype
    if dtype in (torch.bfloat16, torch.float16):
        full = full.to(torch.float32)
    bits = _BITS.get(full.dtype)
    if bits is not None:
        return reduce(full.view(bits)).view(full.dtype).to(dtype)
    if dtype not in (torch.int32, torch.int64):
        full = full.to(torch.int64)
    return reduce(full).to(dtype)


class Mesh(NamedTuple):
    """The ('data', 'model') mesh over the process group. Ranks are laid
    out data-major (rank = data_index * n_model + model_index), as
    ``jax.make_mesh``'s device grid. data_group holds the ranks of this
    rank's model_index, model_group those of its data_index (None: the
    whole world, or an axis of size 1, which needs no group)."""
    n_data: int
    n_model: int
    rank: int
    data_index: int
    model_index: int
    backend: str          # "nccl" | "gloo" | "none" (one process)
    data_group: Any = None
    model_group: Any = None

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

    def _reduce(self, t: torch.Tensor, op: str, group) -> torch.Tensor:
        buf = t.detach().to(self.comm_device(), copy=True).contiguous()
        dist.all_reduce(buf, op=_OPS[op], group=group)
        return buf.to(t.device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The reduction over the data axis (the ranks of this rank's
        model_index) of ``t`` ("sum" or "max"), a new tensor on t's
        device (t is left as it is)."""
        if self.n_data == 1:
            return t
        return self._reduce(t, op, self.data_group)

    def model_owner_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the model group of ``t``, each of whose elements
        is one rank's value and zeros on the others (rows of a vocab
        slice): one all-reduce of the bit patterns (``_exact_sum``), exact
        and the same bits on every rank of the group."""
        if self.n_model == 1:
            return t
        return _exact_sum(t.detach(), lambda x: self._reduce(
            x, "sum", self.model_group))

    def model_all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The model group's ``t`` (equal shapes) concatenated on dim 0 in
        model_index order, bit for bit on every rank of the group."""
        if self.n_model == 1:
            return t
        parts = torch.zeros((self.n_model,) + tuple(t.shape), dtype=t.dtype,
                            device=t.device)
        parts[self.model_index] = t.detach()
        return self.model_owner_sum(parts).reshape((-1,) + tuple(t.shape[1:]))

    def model_all_reduce(self, t: torch.Tensor, op: str = "sum"
                         ) -> torch.Tensor:
        """The reduction over the model group of ``t`` ("sum" or "max"):
        the ranks' tensors gathered exactly and reduced here in
        model_index order, so every rank holds the same bits."""
        if self.n_model == 1:
            return t
        parts = self.model_all_gather(t[None])
        if op == "max":
            return parts.amax(0)
        out = parts[0]
        for x in parts[1:]:
            out = out + x
        return out

    def gather_rows(self, local: torch.Tensor, rows, total: int) -> torch.Tensor:
        """The (total, ...) tensor whose ``rows`` (an index array or slice
        of this rank's rows; the data ranks' rows are disjoint and cover
        total) are this rank's ``local``: on every rank, bit for bit. One
        all-reduce over the data group of the rows' bit patterns (floats
        as integers, bf16 through fp32), each summed with zeros only."""
        if self.n_data == 1:
            return local
        full = torch.zeros((total,) + tuple(local.shape[1:]), dtype=local.dtype,
                           device=local.device)
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(rows).to(local.device)
        full[rows] = local.detach()
        return _exact_sum(full, self.all_reduce)

    def barrier(self) -> None:
        """Every rank of the world waits here for the others (an
        all-reduce of one element on the backend's own device)."""
        if self.n_data * self.n_model > 1:
            self._reduce(torch.zeros(1), "sum", None)

    def rows(self, total: int) -> slice:
        """This rank's contiguous block of a batch of ``total`` rows, what
        ``P('data')`` gives a device. Raises ValueError unless the data
        axis divides total, as the JAX kernels' shard check does."""
        if total % self.n_data:
            raise ValueError(f"batch of {total} rows does not split over "
                             f"{self.n_data} data-parallel ranks")
        n = total // self.n_data
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def vocab_slice(self, V: int) -> Tuple[int, int]:
        """This rank's rows [v0, v1) of a vocab of V: n_model balanced
        contiguous slices, the first V % n_model one row longer (as
        ``torch.tensor_split`` splits)."""
        return vocab_bounds(V, self.n_model, self.model_index)


def tp_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` where it has a model axis (tensor parallelism: the vocab
    is sliced), else None."""
    return mesh if mesh is not None and mesh.n_model > 1 else None


def vocab_bounds(V: int, n: int, j: int) -> Tuple[int, int]:
    """Slice j of n of a vocab of V rows (``Mesh.vocab_slice``)."""
    q, r = divmod(V, n)
    v0 = j * q + min(j, r)
    return v0, v0 + q + (j < r)


def _groups(n_data: int, n_model: int):
    """(data groups by model_index, model groups by data_index), made on
    every rank in one order (``dist.new_group`` is collective); None
    where an axis is the world or of size 1."""
    data = [None] * n_model
    model = [None] * n_data
    if n_model > 1 and n_data > 1:
        for j in range(n_model):
            data[j] = dist.new_group([d * n_model + j for d in range(n_data)])
        for d in range(n_data):
            model[d] = dist.new_group([d * n_model + j for j in range(n_model)])
    return data, model


def make_mesh(n_data: int = -1, n_model: int = 1) -> Mesh:
    """The mesh over the whole process group (one process when none was
    joined). n_data == -1 takes the world over n_model. Raises ValueError
    where n_data x n_model is not the world size. Every rank must call it
    (it makes the axes' process groups)."""
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
    data_groups, model_groups = _groups(n_data, n_model)
    d, j = rank // n_model, rank % n_model
    return Mesh(n_data=n_data, n_model=n_model, rank=rank, data_index=d,
                model_index=j, backend=str(backend),
                data_group=data_groups[j], model_group=model_groups[d])


# Param-path regex -> the vocab-sharded dim, the JAX package's _TP_RULES:
# paths are '/'-joined dict keys (list indices as numbers), e.g.
# 'encoder/embed/table', 'decoder/readout/w_out'. Vocab-dim sharding over
# 'model' covers the big tables; everything else is replicated (tiny).
MODEL_AXIS = "model"
_TP_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r".*/embed/table$", (MODEL_AXIS, None)),   # (V, E) sharded on V
    (r".*/readout/w_out$", (None, MODEL_AXIS)),  # (R, V) sharded on V
    (r".*/readout/b_out$", (MODEL_AXIS,)),       # (V,)
)


def param_spec(path: str) -> Tuple[Optional[str], ...]:
    """The partition spec of the leaf at ``path`` under a mesh with a
    model axis: the first rule of _TP_RULES that matches, else () (the
    leaf is replicated)."""
    for pat, spec in _TP_RULES:
        if re.match(pat, path):
            return spec
    return ()


def vocab_dim(path: str) -> Optional[int]:
    """The dim of the leaf at ``path`` that is sharded on the vocab, or
    None for a replicated leaf."""
    spec = param_spec(path)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def _map_paths(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, _join(path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_paths(fn, v, _join(path, i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def sharded_leaves(tree, path: str = "") -> List[bool]:
    """For each leaf in ``train/state.tree_leaves`` order (dict keys
    sorted, lists in order): whether it is sharded on the vocab."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in sharded_leaves(tree[k], _join(path, k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in sharded_leaves(v, _join(path, i))]
    return [vocab_dim(path) is not None]


def shard_tree(tree, mesh: Optional[Mesh]):
    """A full params (or params-shaped: Adam moments) tree -> this rank's
    tree: each leaf of _TP_RULES narrowed to this rank's vocab slice,
    stored contiguous; every other leaf as it is. The tree itself where
    the mesh has no model axis."""
    if tp_mesh(mesh) is None:
        return tree

    def one(path, x):
        dim = vocab_dim(path)
        if dim is None:
            return x
        v0, v1 = mesh.vocab_slice(x.shape[dim])
        return x.narrow(dim, v0, v1 - v0).contiguous()

    return _map_paths(one, tree)


def gather_tree(tree, mesh: Optional[Mesh]):
    """The reverse of ``shard_tree``: every sliced leaf gathered over the
    model group into the full tensor (a collective: every rank of the
    group calls it), bit for bit on every rank."""
    if tp_mesh(mesh) is None:
        return tree

    def one(path, x):
        dim = vocab_dim(path)
        if dim is None:
            return x
        return gather_vocab(x, dim, mesh)

    return _map_paths(one, tree)


def gather_vocab(x: torch.Tensor, dim: int, mesh: Mesh,
                 V: Optional[int] = None) -> torch.Tensor:
    """The full tensor of the model group's vocab slices of ``x`` along
    ``dim`` (balanced slices of V; None: V from the slices' sizes, whose
    largest is this tensor's or one more), exact. Every rank of the model
    group calls it."""
    n = mesh.n_model
    if V is None:
        sizes = mesh.model_all_gather(torch.tensor([x.shape[dim]]))
        V = int(sizes.sum())
    width = -(-V // n)
    pad = width - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    parts = mesh.model_all_gather(x.movedim(dim, 0).contiguous())
    parts = parts.reshape((n, width) + tuple(parts.shape[1:]))
    bounds = [vocab_bounds(V, n, i) for i in range(n)]
    full = torch.cat([parts[i, :b - a] for i, (a, b) in enumerate(bounds)])
    return full.movedim(0, dim).contiguous()


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
