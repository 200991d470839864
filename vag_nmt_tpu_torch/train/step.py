"""The train step (counterpart of the single-device path of the JAX
package's ``train/step.py``): expand a compact batch, gather the image
rows from the device table, the joint loss, its gradient through the
kernels' autograd Functions, then clip + Adam + apply (train/state.py).

The step's dropout draws come from a generator seeded from
(cfg.train.seed + 1, state.step), as the JAX step folds ``state.step``
into ``base_rng``: a resumed run draws the same masks as an uninterrupted
one. The draws themselves differ from JAX's threefry bits. The step reads
nothing back to the host: aux stays on the device."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vag_nmt_tpu_torch.core.config import EOS_ID, SOS_ID, Config
from vag_nmt_tpu_torch.models.model import loss_fn
from vag_nmt_tpu_torch.train.state import (
    TrainState,
    apply_update,
    tree_leaves,
    tree_unflatten,
)

Batch = Dict[str, Any]


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


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The dropout generator of one train step: a function of (seed, step)
    alone, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed << 32) + step)
    return gen


def make_train_step(cfg: Config, *, with_img_table: bool = False
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns step(state, batch, img_table=None) -> (new state, aux).

    batch: a host batch from BucketBatcher (classic or compact keys; numpy
    or tensors). with_img_table=True: the batch carries "img_ids" rows into
    ``img_table`` (N, F), already on the device, instead of "img" rows.
    aux: the loss_fn keys plus grad_norm (before the clip) and lr, 0-dim
    tensors on the device. The kernels run as cfg.model.gru_impl and
    cfg.model.dec_scan_impl say ("auto": kernels for CUDA tensors)."""

    def step(state: TrainState, batch: Batch,
             img_table: Optional[torch.Tensor] = None):
        dev = state.lr.device
        b = to_device(batch, dev)
        if "src_len" in b:
            b = expand_compact_batch(b)
        if with_img_table:
            b["img"] = img_table[b.pop("img_ids").long()]
        gen = step_generator(cfg.train.seed + 1, state.step, dev)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        loss, aux = loss_fn(params, cfg.model, b, gen, train=True)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        new_state, norm = apply_update(cfg, state, grads)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["grad_norm"] = norm
        aux["lr"] = state.lr
        return new_state, aux

    return step


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
