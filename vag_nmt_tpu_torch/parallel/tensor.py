"""Vocab-parallel operations (the collectives GSPMD inserts for the JAX
package's ``_TP_RULES`` on a mesh with a 'model' axis).

Each model rank holds rows [v0, v1) of a vocab of V (``VocabShard``):
its slice of the embedding tables and of the output projection. Every
other tensor is replicated over the model group, and the operations
here keep it so: their results are the same bits on every model rank
(``Mesh.model_all_reduce`` reduces in model_index order after an exact
gather). Each is a ``torch.autograd.Function`` or built from them, with
the vocab slice (and so the mesh) passed explicitly:

    copy_to_model(x)       identity; backward: the grad summed over 'model'
    reduce_from_model(x)   the sum over 'model'; backward: identity
                           (owned=True: one rank's value an element)
    vocab_embed            masked local gather, then reduce_from_model
                           (owned=True)
    vocab_parallel_log_softmax_target
                           log p(target) from the logits' slices
    vocab_parallel_argmax  the row's argmax, ties to the smaller id
    gather_logits          the whole rows, exact (for the unfused step)

``copy_to_model`` wraps the readout activations just before the local
vocab GEMM and nothing else: a sum over 'model' of the replicated
leaves' grads after the backward would count them n_model times."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vag_nmt_tpu_torch.parallel.sharding import Mesh, gather_vocab, tp_mesh


class VocabShard(NamedTuple):
    """This rank's rows [v0, v1) of a vocab of ``total`` rows, split over
    ``mesh``'s model axis."""
    mesh: Mesh
    v0: int
    v1: int
    total: int

    @property
    def width(self) -> int:
        return self.v1 - self.v0

    def local(self, ids: torch.Tensor):
        """(ids - v0 clamped into the slice, whether each id lies in it)."""
        inside = (ids >= self.v0) & (ids < self.v1)
        return (ids - self.v0).clamp(0, self.width - 1), inside


def vocab_shard(mesh: Optional[Mesh], V: int) -> Optional[VocabShard]:
    """The vocab slice of this rank of a mesh with a model axis, None
    without one."""
    if tp_mesh(mesh) is None:
        return None
    v0, v1 = mesh.vocab_slice(V)
    return VocabShard(mesh, v0, v1, V)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_all_reduce(g.contiguous()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, owned):
        return mesh.model_owner_sum(x) if owned else mesh.model_all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x; its gradient summed over the model group (the input of a
    product with a vocab slice)."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh, *,
                      owned: bool = False) -> torch.Tensor:
    """The sum of x over the model group; its gradient passed as it is.
    owned: each element of x is one rank's value and zeros on the others
    (``Mesh.model_owner_sum``: one all-reduce of x's size, where a sum of
    live values gathers n_model times its bytes)."""
    return _ReduceFromModel.apply(x, mesh, owned)


def _check_ids(ids: torch.Tensor, V: int) -> None:
    """Ids outside [0, V) raise, as a gather from the whole table does: on
    the host at once, on the card as a device-side assert."""
    bad = ((ids < 0) | (ids >= V)).any()
    if ids.is_cuda:
        torch._assert_async(~bad, f"vocab_embed: an id outside [0, {V})")
    elif bool(bad):
        raise IndexError(f"vocab_embed: an id outside [0, {V})")


def vocab_embed(table: torch.Tensor, ids: torch.Tensor,
                vocab: VocabShard) -> torch.Tensor:
    """The rows ``ids`` of the whole (V, D) table from this rank's slice
    (v1 - v0, D): each rank gathers the rows it holds, zeros for the
    others, and the sum over the model group adds each row to zeros only
    (one owner an element: exact). The gradient reaches this rank's
    rows."""
    _check_ids(ids, vocab.total)
    local, inside = vocab.local(ids)
    rows = torch.where(inside[..., None], table[local],
                       torch.zeros((), dtype=table.dtype, device=table.device))
    return reduce_from_model(rows, vocab.mesh, owned=True)


class _LogSoftmaxTarget(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, vocab):
        mesh = vocab.mesh
        m = mesh.model_all_reduce(logits.amax(-1), "max")
        e = torch.exp(logits - m[..., None])
        sumexp = mesh.model_all_reduce(e.sum(-1))
        local, inside = vocab.local(target)
        tl = torch.gather(logits, -1, local[..., None])[..., 0]
        tl = mesh.model_owner_sum(torch.where(inside, tl,
                                              torch.zeros_like(tl)))
        ctx.save_for_backward(e, sumexp, local, inside)
        return tl - m - torch.log(sumexp)

    @staticmethod
    def backward(ctx, g):
        e, sumexp, local, inside = ctx.saved_tensors
        grad = -(e / sumexp[..., None]) * g[..., None]
        hit = torch.where(inside, g, torch.zeros_like(g))
        grad.scatter_add_(-1, local[..., None], hit[..., None])
        return grad, None, None


def vocab_parallel_log_softmax_target(logits: torch.Tensor,
                                      target: torch.Tensor,
                                      vocab: VocabShard) -> torch.Tensor:
    """log_softmax(whole row)[target] from this rank's logits' slice
    (..., v1 - v0) fp32 and the global target ids (...): the row max
    reduced with MAX, the sum of exponentials with SUM, the target's
    logit from the rank that holds it (one owner). Its gradient is this
    slice's, (onehot - softmax) x grad, with no collective."""
    return _LogSoftmaxTarget.apply(logits, target, vocab)


def vocab_parallel_argmax(logits: torch.Tensor,
                          vocab: VocabShard) -> torch.Tensor:
    """The global argmax of each row of the whole logits from this rank's
    slice (..., v1 - v0): each slice's (max, its first global id),
    gathered, and the largest value taken, ties to the smaller id (as
    ``jnp.argmax`` and ``torch.argmax``)."""
    val, idx = logits.max(-1)
    pairs = torch.stack([val.to(torch.float64),
                         (idx + vocab.v0).to(torch.float64)])
    allp = vocab.mesh.model_all_gather(pairs[None])   # (n, 2, ...)
    vals, ids = allp[:, 0], allp[:, 1]
    # slices in model_index order hold increasing ids: the first slice
    # reaching the maximum holds the smallest id of it
    best = (vals == vals.amax(0, keepdim=True)).to(torch.int8).argmax(0)
    return torch.gather(ids, 0, best[None])[0].to(torch.long)


def gather_logits(logits: torch.Tensor, vocab: VocabShard) -> torch.Tensor:
    """The whole rows (..., V) from each rank's slice (..., v1 - v0),
    exact, on every rank."""
    return gather_vocab(logits, logits.dim() - 1, vocab.mesh, vocab.total)
