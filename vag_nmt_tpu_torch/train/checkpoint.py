"""Full train-state checkpoints with resume (counterpart of the JAX
package's ``train/checkpoint.py``, in a torch-native format), and the
reader of the JAX package's own checkpoints.

The whole TrainState (params, Adam moments, step, lr) and the loop's
metadata (epoch, in-epoch cursor, best dev BLEU, eval patience) go into
ONE file, ``state_<tag>.pt``, written to a temporary name and renamed into
place, so a crash never pairs a new state with stale metadata. A JSON
mirror of the metadata, ``meta_<tag>.json``, is written the same way for
people to read; ``train_loop``'s metadata records the run's
``compute_dtype`` (params are fp32 whatever it is). Tags: ``last``
(resume) and ``best`` (best dev BLEU). Writes are synchronous.

``load_checkpoint`` also reads a run the JAX package wrote,
``state_<tag>.msgpack`` (flax serialization, decoded by
``train/flax_msgpack.py`` without flax): the bundle ``{state_bytes,
meta_json}`` or the older layout whose file is the state itself, with its
metadata in the ``meta_<tag>.json`` sidecar. Its TrainState (``step``,
``params``, ``opt_state`` = the state of optax's chain (clip,
scale_by_adam) with ``count``, ``mu`` and ``nu``, ``lr``) becomes the
port's ``TrainState`` through the weight bridge ``params_from_numpy``, so
``train_loop`` resumes a JAX run and ``Translator.from_run`` serves one.
Either format's step gives the state's device copy ``count``.
``load_checkpoint(into=state)`` writes the saved values into a state's
own tensors (a CUDA graph captured on them stays valid).

Under tensor parallelism (a mesh with a model axis) the files hold the
full tensors all the same: ``save_checkpoint(mesh=)`` gathers the vocab
slices over the model group (every rank calls it) before rank 0 writes,
and ``load_checkpoint(mesh=)`` reads the full state and keeps this
rank's slices, from either format."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from vag_nmt_tpu_torch.core.config import ModelConfig
from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device
from vag_nmt_tpu_torch.models.model import params_from_numpy
from vag_nmt_tpu_torch.parallel.sharding import Mesh, gather_tree, shard_tree
from vag_nmt_tpu_torch.train import flax_msgpack
from vag_nmt_tpu_torch.train.state import (TrainState, copy_state,
                                           device_count, tree_leaves,
                                           tree_unflatten)

_STATE_FILE = "state_{tag}.pt"
_JAX_STATE_FILE = "state_{tag}.msgpack"
_META_FILE = "meta_{tag}.json"


def _replace_atomically(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, tag: str, state: TrainState,
                    meta: Optional[Dict[str, Any]] = None, *,
                    mesh: Optional[Mesh] = None) -> None:
    """Writes ``state`` and ``meta`` under ``tag``. mesh: the run's mesh;
    every rank calls it, the vocab slices are gathered over the model
    group and rank 0 alone writes."""
    if mesh is not None:
        state = state._replace(params=gather_tree(state.params, mesh),
                               mu=gather_tree(state.mu, mesh),
                               nu=gather_tree(state.nu, mesh))
        if not mesh.is_main:
            return
    os.makedirs(ckpt_dir, exist_ok=True)
    meta = {"step": int(state.step), **(meta or {})}

    def host(tree):
        return tree_unflatten(tree, [x.detach().cpu() for x in tree_leaves(tree)])

    payload = {"step": int(state.step), "params": host(state.params),
               "mu": host(state.mu), "nu": host(state.nu),
               "lr": state.lr.detach().cpu(), "meta": meta}
    _replace_atomically(os.path.join(ckpt_dir, _STATE_FILE.format(tag=tag)),
                        lambda p: torch.save(payload, p))

    def write_meta(p):
        with open(p, "w") as f:
            json.dump(meta, f)

    _replace_atomically(os.path.join(ckpt_dir, _META_FILE.format(tag=tag)),
                        write_meta)


def _load_pt(path: str, dev: torch.device) -> Tuple[TrainState, Dict[str, Any]]:
    payload = torch.load(path, map_location="cpu", weights_only=True)

    def put(tree):
        return tree_unflatten(tree, [x.to(dev) for x in tree_leaves(tree)])

    step = int(payload["step"])
    state = TrainState(step=step, params=put(payload["params"]),
                       mu=put(payload["mu"]), nu=put(payload["nu"]),
                       lr=payload["lr"].to(dev), count=device_count(step, dev))
    return state, payload["meta"]


def _read_jax(ckpt_dir: str, tag: str
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The JAX package's ``state_<tag>.msgpack`` as (its TrainState's dict
    of numpy trees: step, params, opt_state, lr; its meta): the bundle
    ``{state_bytes, meta_json}``, or the older layout (the file is the
    state; meta from the ``meta_<tag>.json`` sidecar, {} without one)."""
    with open(os.path.join(ckpt_dir, _JAX_STATE_FILE.format(tag=tag)),
              "rb") as f:
        raw = f.read()
    bundle = flax_msgpack.msgpack_restore(raw)
    if isinstance(bundle, dict) and "meta_json" in bundle:
        return (flax_msgpack.msgpack_restore(bytes(bundle["state_bytes"])),
                json.loads(bundle["meta_json"]))
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(ckpt_dir, _META_FILE.format(tag=tag))
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return bundle, meta


def _load_jax(ckpt_dir: str, tag: str, cfg: ModelConfig, dev: torch.device
              ) -> Tuple[TrainState, Dict[str, Any]]:
    tree, meta = _read_jax(ckpt_dir, tag)
    adam = tree["opt_state"]["1"]          # chain(clip, scale_by_adam)

    def bridge(t):
        return params_from_numpy(t, cfg, device=dev)

    step = int(np.asarray(tree["step"]))
    state = TrainState(step=step,
                       params=bridge(tree["params"]), mu=bridge(adam["mu"]),
                       nu=bridge(adam["nu"]),
                       lr=torch.tensor(np.asarray(tree["lr"]),
                                       dtype=torch.float32, device=dev),
                       count=device_count(step, dev))
    return state, meta


def load_checkpoint(ckpt_dir: str, tag: str, *, device: DeviceLike = None,
                    cfg: Optional[ModelConfig] = None,
                    mesh: Optional[Mesh] = None,
                    into: Optional[TrainState] = None
                    ) -> Tuple[TrainState, Dict[str, Any]]:
    """The saved state, on ``device`` (None = the card), and its meta:
    the port's ``state_<tag>.pt`` or the JAX package's
    ``state_<tag>.msgpack`` (which needs the run's model config ``cfg``
    for the weight bridge). Where both files exist, the one whose state
    holds the larger step (the step both packages also write into its
    meta) is read; on a tie, the ``.pt``. mesh: with a model axis, this
    rank's vocab slices of the state. into: a state of the same tree whose
    tensors receive the saved values (``copy_``, not a rebind: CUDA
    graphs captured on them stay valid); returned with the saved step."""
    state, meta = _load_full(ckpt_dir, tag, resolve_device(device), cfg)
    state = state._replace(params=shard_tree(state.params, mesh),
                           mu=shard_tree(state.mu, mesh),
                           nu=shard_tree(state.nu, mesh))
    return (state if into is None else copy_state(into, state)), meta


def _load_full(ckpt_dir: str, tag: str, dev: torch.device,
               cfg: Optional[ModelConfig]) -> Tuple[TrainState, Dict[str, Any]]:
    pt = os.path.join(ckpt_dir, _STATE_FILE.format(tag=tag))
    has_jax = os.path.exists(os.path.join(ckpt_dir,
                                          _JAX_STATE_FILE.format(tag=tag)))
    if has_jax and cfg is None:
        if not os.path.exists(pt):
            raise ValueError("reading a JAX checkpoint needs the run's "
                             "model config (cfg=)")
        has_jax = False
    if not has_jax:
        return _load_pt(pt, dev)
    jax_state = _load_jax(ckpt_dir, tag, cfg, dev)
    if not os.path.exists(pt):
        return jax_state
    pt_state = _load_pt(pt, dev)
    return jax_state if jax_state[0].step > pt_state[0].step else pt_state


def has_checkpoint(ckpt_dir: str, tag: str) -> bool:
    """Whether ``tag`` has a checkpoint of either kind in ``ckpt_dir``."""
    return any(os.path.exists(os.path.join(ckpt_dir, f.format(tag=tag)))
               for f in (_STATE_FILE, _JAX_STATE_FILE))
