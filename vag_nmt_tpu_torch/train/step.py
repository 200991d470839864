"""The train step (counterpart of the JAX package's ``train/step.py``):
expand a compact batch, gather the image rows from the device table, the
joint loss, its gradient through the kernels' autograd Functions, then
clip + Adam + apply (train/state.py).

Under a data-parallel mesh (``parallel/sharding.py``) every rank gets the
same global batch and takes its contiguous block of rows; the loss is
the global one (``models/model.loss_fn``'s shard), each dropout draw is
made at the global batch's shape (``layers.RowDraws``), one all-reduce a
step sums the gradients (and the CE's shares) through one flat buffer,
and clip + Adam then run identically on every rank, so the replicas stay
bit-identical and equal the single process's run on the global batch up
to the order of the sums.

Under a mesh with a model axis (tensor parallelism) the state holds this
rank's vocab slices (``parallel/sharding.py``'s ``_TP_RULES``); the ranks
of a model group take the same rows, the loss runs its vocab-parallel
operations (``parallel/tensor.py``), the flat all-reduce runs over the
data group only (a slice's grads with the same slice's of the other data
ranks), and the clip's norm adds the slices' squares over the model
group.

The step's dropout draws come from a generator seeded from
(cfg.train.seed + 1, state.step), as the JAX step folds ``state.step``
into ``base_rng``: a resumed run draws the same masks as an uninterrupted
one. The draws themselves differ from JAX's threefry bits. The step reads
nothing back to the host: aux stays on the device.

``make_multi_step`` runs K steps of one batch shape in one call (the JAX
package's K-step dispatcher), each step through the same body
(``make_step_body``) with the same draws as K single steps."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vag_nmt_tpu_torch.core.config import EOS_ID, SOS_ID, Config
from vag_nmt_tpu_torch.models.layers import RowDraws
from vag_nmt_tpu_torch.models.model import loss_fn
from vag_nmt_tpu_torch.parallel.sharding import BatchShard, Mesh
from vag_nmt_tpu_torch.train.state import (
    TrainState,
    apply_update,
    tree_leaves,
    tree_unflatten,
)

Batch = Dict[str, Any]
StepBody = Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]


def expand_compact_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The classic batch keys from a compact batch (BucketBatcher(
    compact=True): tokens + lengths), built on the batch's device. Equal to
    the JAX package's expand_compact_batch bit for bit: filler rows
    (sample_mask 0) get a masked-out SOS/EOS, and tgt_len == -1 marks a row
    with no target (all-zero tgt_mask)."""
    src = batch["src"].to(torch.int32)
    tgt = batch["tgt"].to(torch.int32)
    B, Tt = tgt.shape
    dev = tgt.device
    spos = torch.arange(src.shape[1], dtype=torch.int32, device=dev)[None, :]
    tpos = torch.arange(Tt, dtype=torch.int32, device=dev)[None, :]
    sl = batch["src_len"].to(torch.int32)[:, None]
    tl = batch["tgt_len"].to(torch.int32)[:, None]
    sample = batch["sample_mask"]
    out = {
        "src": src,
        "src_mask": (spos < sl).to(torch.float32),
        "tgt_in": torch.cat([torch.full((B, 1), SOS_ID, dtype=torch.int32,
                                        device=dev), tgt[:, :-1]], dim=1),
        "tgt_out": torch.where(tpos == tl, torch.full_like(tgt, EOS_ID), tgt),
        "tgt_mask": (((tpos <= tl) & (tl >= 0)).to(torch.float32)
                     * sample[:, None]),
        "sample_mask": sample,
    }
    for k in ("img_ids", "img"):
        if k in batch:
            out[k] = batch[k]
    return out


def to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy) -> tensors on ``device``. uint16 token arrays are
    widened to int32 on the host; the corpus-line ``index`` stays behind."""
    out = {}
    for k, v in batch.items():
        if k == "index":
            continue
        if isinstance(v, np.ndarray) and v.dtype == np.uint16:
            v = v.astype(np.int32)
        out[k] = torch.as_tensor(v).to(device, non_blocking=True)
    return out


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of train step ``step`` (0-based) of a run seeded
    ``seed``."""
    return (seed << 32) + step


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The dropout generator of one train step: a function of (seed, step)
    alone, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, step))
    return gen


def _shard(mesh: Mesh, b: Dict[str, torch.Tensor]
           ) -> Tuple[BatchShard, Dict[str, torch.Tensor]]:
    """This rank's rows of the global batch b (every key is per row), and
    what the loss needs of the whole batch."""
    total = b["src"].shape[0]
    rows = mesh.rows(total)
    shard = BatchShard(mesh, rows.start, rows.stop, total,
                       b["tgt_mask"].to(torch.float32).sum(),
                       b.get("sample_mask"))
    return shard, {k: v[rows] for k, v in b.items()}


def _all_reduce_flat(mesh: Mesh, tensors: List[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """The sums over the ranks of fp32 tensors, through one flat buffer
    and one all-reduce."""
    flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in tensors]))
    return [x.view_as(t) for x, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_step_body(cfg: Config, *, mesh: Optional[Mesh] = None,
                   with_img_table: bool = False) -> StepBody:
    """Returns body(state, batch, gen, img_table) -> (new state, aux): one
    train step on a batch already on the device (classic or compact keys;
    "img_ids" rows into ``img_table`` with with_img_table), its dropout
    drawn from ``gen`` (a generator on the device). The counterpart of the
    JAX package's ``_make_step_body``, shared by the one-step and K-step
    dispatchers and captured by ``train/graphs.py``: it makes no host read
    and no host copy (but for gloo's collectives under ``mesh``, the
    global batch's rows as ``make_train_step`` says)."""
    if mesh is not None and (mesh.n_data > 1 or mesh.n_model > 1):
        mesh.rows(cfg.data.batch_size)          # raises unless it divides
    else:
        mesh = None

    def body(state: TrainState, b: Dict[str, torch.Tensor],
             gen: torch.Generator, img_table: Optional[torch.Tensor] = None):
        if "src_len" in b:
            b = expand_compact_batch(b)
        else:
            b = dict(b)
        shard = None
        if mesh is not None:
            shard, b = _shard(mesh, b)
            gen = RowDraws(gen, shard.start, shard.total)
        if with_img_table:
            b["img"] = img_table[b.pop("img_ids").long()]
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        loss, aux = loss_fn(params, cfg.model, b, gen, train=True,
                            shard=shard)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if shard is not None:
            *grads, ce, acc = _all_reduce_flat(
                mesh, grads + [aux["ce"].detach(), aux["acc"].detach()])
            aux["ce"], aux["acc"] = ce, acc
            aux["loss"] = ce if "vse" not in aux else \
                ce + cfg.model.vse_weight * aux["vse"]
        new_state, norm = apply_update(cfg, state, grads, mesh)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["grad_norm"] = norm
        aux["lr"] = state.lr.clone()     # the rate this step applied
        return new_state, aux

    return body


def make_train_step(cfg: Config, *, mesh: Optional[Mesh] = None,
                    with_img_table: bool = False
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns step(state, batch, img_table=None) -> (new state, aux).

    batch: a host batch from BucketBatcher (classic or compact keys; numpy
    or tensors). with_img_table=True: the batch carries "img_ids" rows into
    ``img_table`` (N, F), already on the device, instead of "img" rows.
    aux: the loss_fn keys plus grad_norm (before the clip) and lr, 0-dim
    tensors on the device. The kernels run as cfg.model.gru_impl and
    cfg.model.dec_scan_impl say ("auto": kernels for CUDA tensors).

    mesh: a mesh (``parallel.make_mesh``): batch is the global batch, the
    same on every rank, of which each rank trains on its data index's
    rows; aux holds the global values. With a model axis the state holds
    vocab slices (``create_train_state(mesh=)``). Raises ValueError where
    the data axis does not divide cfg.data.batch_size (or a batch's
    rows)."""
    body = make_step_body(cfg, mesh=mesh, with_img_table=with_img_table)

    def step(state: TrainState, batch: Batch,
             img_table: Optional[torch.Tensor] = None):
        dev = state.lr.device
        gen = step_generator(cfg.train.seed + 1, state.step, dev)
        return body(state, to_device(batch, dev), gen, img_table)

    return step


def row(stack: Dict[str, torch.Tensor], k: int) -> Dict[str, torch.Tensor]:
    """Step k's batch of a stacked batch (every leaf a leading K axis)."""
    return {key: v[k] for key, v in stack.items()}


def run_steps(body: StepBody, state: TrainState,
              stack: Dict[str, torch.Tensor], gens: Sequence[torch.Generator],
              img_table: Optional[torch.Tensor] = None
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """len(gens) steps of ``body`` over the rows of a stacked batch on the
    device, step k drawing from gens[k]: (the last state, the aux stack,
    each leaf of shape (K,)). The counterpart of the ``lax.scan`` in the
    JAX package's ``make_multi_step``."""
    auxes = []
    for k, gen in enumerate(gens):
        state, aux = body(state, row(stack, k), gen, img_table)
        auxes.append(aux)
    return state, {key: torch.stack([a[key] for a in auxes])
                   for key in auxes[0]}


def make_multi_step(cfg: Config, *, mesh: Optional[Mesh] = None,
                    with_img_table: bool = False
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The K-step dispatcher: returns fn(state, stacked_batch,
    img_table=None) -> (new state, aux_stack), K train steps over a
    stacked batch (every leaf a leading K axis, as
    ``BucketBatcher.epoch_stacked`` yields it; numpy or tensors) in one
    call, each aux leaf of shape (K,). Step k draws from the generator
    ``make_train_step`` would give it, seeded (cfg.train.seed + 1,
    state.step + k), so the K-step call equals K single steps bit for bit.
    Eager: one host copy of the stack, then every operation of every step
    enqueued by the host; on the card ``train/graphs.py`` replays the
    same steps as one CUDA graph. mesh: as make_train_step's, each row of
    the stack a global batch."""
    body = make_step_body(cfg, mesh=mesh, with_img_table=with_img_table)

    def multi(state: TrainState, stack: Batch,
              img_table: Optional[torch.Tensor] = None):
        dev = state.lr.device
        s = to_device(stack, dev)
        gens = [step_generator(cfg.train.seed + 1, state.step + k, dev)
                for k in range(s["src"].shape[0])]
        return run_steps(body, state, s, gens, img_table)

    return multi


def make_eval_step(cfg: Config) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns eval(params, batch) -> aux of loss_fn without dropout or
    gradient."""

    def step(params, batch: Batch) -> Dict[str, torch.Tensor]:
        dev = tree_leaves(params)[0].device
        b = to_device(batch, dev)
        if "src_len" in b:
            b = expand_compact_batch(b)
        with torch.no_grad():
            _, aux = loss_fn(params, cfg.model, b, None, train=False)
        return aux

    return step
