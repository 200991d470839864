"""Full train-state checkpoints with resume (counterpart of the JAX
package's ``train/checkpoint.py``, in a torch-native format).

The whole TrainState (params, Adam moments, step, lr) and the loop's
metadata (epoch, in-epoch cursor, best dev BLEU, eval patience) go into
ONE file, ``state_<tag>.pt``, written to a temporary name and renamed into
place, so a crash never pairs a new state with stale metadata. A JSON
mirror of the metadata, ``meta_<tag>.json``, is written the same way for
people to read. Tags: ``last`` (resume) and ``best`` (best dev BLEU).
Writes are synchronous. Reading a JAX bundle (flax msgpack) is a later
slice of the port."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device
from vag_nmt_tpu_torch.train.state import TrainState, tree_leaves, tree_unflatten

_STATE_FILE = "state_{tag}.pt"
_META_FILE = "meta_{tag}.json"


def _replace_atomically(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, tag: str, state: TrainState,
                    meta: Optional[Dict[str, Any]] = None) -> None:
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


def load_checkpoint(ckpt_dir: str, tag: str, *, device: DeviceLike = None
                    ) -> Tuple[TrainState, Dict[str, Any]]:
    """The saved state, on ``device`` (None = the card), and its meta."""
    dev = resolve_device(device)
    payload = torch.load(os.path.join(ckpt_dir, _STATE_FILE.format(tag=tag)),
                         map_location="cpu", weights_only=True)

    def put(tree):
        return tree_unflatten(tree, [x.to(dev) for x in tree_leaves(tree)])

    state = TrainState(step=int(payload["step"]), params=put(payload["params"]),
                       mu=put(payload["mu"]), nu=put(payload["nu"]),
                       lr=payload["lr"].to(dev))
    return state, payload["meta"]


def has_checkpoint(ckpt_dir: str, tag: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, _STATE_FILE.format(tag=tag)))
