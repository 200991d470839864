"""Train state and optimizer (counterpart of the JAX package's
``train/state.py`` and the update in ``train/step.py``).

The state is params + Adam moments + step + a learning rate the host loop
decays on a dev-BLEU plateau. The update is exactly optax's chain
``clip_by_global_norm(max_norm)`` -> ``scale_by_adam(b1, b2, eps)`` ->
``-lr * u``, written as plain functions over the parameter leaves:

    norm = sqrt(sum of g^2 over every leaf)
    g    = g                       if norm < max_norm
           g / norm * max_norm     otherwise
    mu   = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
    u    = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps),  n = step + 1
    p    = p + (-lr u)

The update reads nothing from the host: n is the state's ``count``, a
0-dim tensor on the params' device that each update increments (its bias
corrections computed from it there, in float64 and rounded to fp32 once,
as a host float was), and the rate is the state's ``lr`` tensor, which
the loop decays in place. So a CUDA graph of train steps replays with the
count and rate of each replay (``train/graphs.py``). ``step`` is the
host's mirror of the count, for the loop's bookkeeping and the dropout
seeds.

(``torch.nn.utils.clip_grad_norm_`` is not this clip: it scales by
max_norm / (norm + 1e-6) whenever norm > max_norm.)

Under tensor parallelism the state holds this rank's vocab slices of
the ``_TP_RULES`` leaves (params and moments alike); the norm adds the
slices' squares over the model group once, and the clip and Adam run on
each rank's leaves: the JAX package's update of the sharded tree.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from vag_nmt_tpu_torch.core.config import Config
from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device
from vag_nmt_tpu_torch.models.model import init_params
from vag_nmt_tpu_torch.parallel.sharding import (Mesh, shard_tree,
                                                 sharded_leaves, tp_mesh)


class TrainState(NamedTuple):
    step: int                  # updates applied so far (the host's mirror)
    params: Dict[str, Any]
    mu: Dict[str, Any]         # Adam first moments, the params' tree
    nu: Dict[str, Any]         # Adam second moments
    lr: torch.Tensor           # () fp32 on the params' device
    count: torch.Tensor        # () int64 on the params' device: step there


def device_count(step: int, device: torch.device) -> torch.Tensor:
    """The device's copy of a step count, for ``TrainState.count``."""
    return torch.full((), int(step), dtype=torch.int64, device=device)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in a fixed order: dict keys sorted (as jax.tree_util), lists
    in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves: List[torch.Tensor]):
    """The inverse of tree_leaves on template's structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(template)


def create_train_state(cfg: Config, generator: torch.Generator, *,
                       device: DeviceLike = None,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """Fresh state: random params from ``generator`` (see init_params),
    zero moments, step 0, lr = cfg.train.learning_rate. mesh: with a
    model axis, this rank's vocab slices of those params."""
    dev = resolve_device(device)
    params = shard_tree(init_params(cfg.model, generator, device=dev), mesh)
    return state_from_params(cfg, params)


def state_from_params(cfg: Config, params: Dict[str, Any]) -> TrainState:
    """Step-0 state around given params (e.g. from params_from_numpy)."""
    leaves = tree_leaves(params)

    def zeros():
        return tree_unflatten(params, [torch.zeros_like(x) for x in leaves])

    dev = leaves[0].device
    return TrainState(step=0, params=params, mu=zeros(), nu=zeros(),
                      lr=torch.tensor(cfg.train.learning_rate,
                                      dtype=torch.float32, device=dev),
                      count=device_count(0, dev))


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """The state's tensors in a fixed order: the params', mu's and nu's
    leaves, lr, count."""
    return [*tree_leaves(state.params), *tree_leaves(state.mu),
            *tree_leaves(state.nu), state.lr, state.count]


@torch.no_grad()
def copy_state(dst: TrainState, src: TrainState) -> TrainState:
    """``dst`` with ``src``'s values copied into its tensors (``copy_``,
    not a rebind: a CUDA graph captured on them stays valid; a tensor
    ``src`` shares with ``dst`` is left as it is) and ``src``'s step.
    Raises ValueError where the trees' tensors differ in shape or dtype."""
    for d, s in zip(state_tensors(dst), state_tensors(src), strict=True):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"copy_state: {tuple(s.shape)} {s.dtype} into "
                             f"{tuple(d.shape)} {d.dtype}")
        if d is not s:
            d.copy_(s)
    return dst._replace(step=src.step)


def global_norm(leaves: List[torch.Tensor], sliced: Optional[List[bool]] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf. With ``sliced`` (a flag
    a leaf: a vocab slice under ``mesh``'s model axis): the replicated
    leaves' squares summed here, the slices' over the model group, so
    each slice counts once and no replicated leaf n_model times."""
    if sliced is None:
        return torch.sqrt(sum(torch.sum(g * g) for g in leaves))
    rep = sum(torch.sum(g * g) for g, s in zip(leaves, sliced) if not s)
    part = sum(torch.sum(g * g) for g, s in zip(leaves, sliced) if s)
    return torch.sqrt(rep + mesh.model_all_reduce(part))


@torch.no_grad()
def apply_update(cfg: Config, state: TrainState, grads: List[torch.Tensor],
                 mesh: Optional[Mesh] = None
                 ) -> Tuple[TrainState, torch.Tensor]:
    """One clip + Adam + apply update with grads in tree_leaves order.
    Returns (new state, the grads' global norm before the clip). Nothing is
    read back to the host and nothing copied to the device (but for gloo's
    collectives under a mesh with a model axis, whose norm is a sum over
    the model group)."""
    t = cfg.train
    b1, b2, eps = t.adam_b1, t.adam_b2, t.adam_eps
    params = tree_leaves(state.params)
    norm = global_norm(grads, sharded_leaves(state.params)
                       if tp_mesh(mesh) else None, mesh)
    count = state.count + 1
    n = count.to(torch.float64)
    bc1 = (1.0 - torch.pow(b1, n)).to(torch.float32)
    bc2 = (1.0 - torch.pow(b2, n)).to(torch.float32)
    new_p, new_mu, new_nu = [], [], []
    for p, g, m, v in zip(params, grads, tree_leaves(state.mu),
                          tree_leaves(state.nu)):
        g = torch.where(norm < t.grad_clip_norm, g, g / norm * t.grad_clip_norm)
        m = (1.0 - b1) * g + b1 * m
        v = (1.0 - b2) * (g * g) + b2 * v
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_p.append(p + (-state.lr) * u)
        new_mu.append(m)
        new_nu.append(v)
    return TrainState(step=state.step + 1,
                      params=tree_unflatten(state.params, new_p),
                      mu=tree_unflatten(state.params, new_mu),
                      nu=tree_unflatten(state.params, new_nu),
                      lr=state.lr, count=count), norm
