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

(``torch.nn.utils.clip_grad_norm_`` is not this clip: it scales by
max_norm / (norm + 1e-6) whenever norm > max_norm.)
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from vag_nmt_tpu_torch.core.config import Config
from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device
from vag_nmt_tpu_torch.models.model import init_params


class TrainState(NamedTuple):
    step: int                  # updates applied so far (host-side counter)
    params: Dict[str, Any]
    mu: Dict[str, Any]         # Adam first moments, the params' tree
    nu: Dict[str, Any]         # Adam second moments
    lr: torch.Tensor           # () fp32 on the params' device


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
                       device: DeviceLike = None) -> TrainState:
    """Fresh state: random params from ``generator`` (see init_params),
    zero moments, step 0, lr = cfg.train.learning_rate."""
    dev = resolve_device(device)
    params = init_params(cfg.model, generator, device=dev)
    return state_from_params(cfg, params)


def state_from_params(cfg: Config, params: Dict[str, Any]) -> TrainState:
    """Step-0 state around given params (e.g. from params_from_numpy)."""
    leaves = tree_leaves(params)

    def zeros():
        return tree_unflatten(params, [torch.zeros_like(x) for x in leaves])

    return TrainState(step=0, params=params, mu=zeros(), nu=zeros(),
                      lr=torch.tensor(cfg.train.learning_rate,
                                      dtype=torch.float32,
                                      device=leaves[0].device))


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in leaves))


@torch.no_grad()
def apply_update(cfg: Config, state: TrainState,
                 grads: List[torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
    """One clip + Adam + apply update with grads in tree_leaves order.
    Returns (new state, the grads' global norm before the clip). Nothing is
    read back to the host."""
    t = cfg.train
    b1, b2, eps = t.adam_b1, t.adam_b2, t.adam_eps
    params = tree_leaves(state.params)
    norm = global_norm(grads)
    n = state.step + 1
    bc1 = 1.0 - b1 ** n
    bc2 = 1.0 - b2 ** n
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
    return TrainState(step=n, params=tree_unflatten(state.params, new_p),
                      mu=tree_unflatten(state.params, new_mu),
                      nu=tree_unflatten(state.params, new_nu),
                      lr=state.lr), norm
