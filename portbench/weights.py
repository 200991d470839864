"""The model's parameter tree and its random weights, made from the seed on
the device in two large draws.

The tree is the published VAG-NMT model's (encoder, decoder, decoder init,
shared visual-text space) under the names and ``(in, out)`` layout that
the port and the JAX package both use, so the same tensors serve the
program and the plain reference. ``layout`` lists it; ``make`` fills it:
one uniform and one normal draw from a ``torch.Generator`` on the device,
each leaf a slice scaled in place:

- embeddings N(0, 1/E); recurrent matrices N(0, 1/H) (orthogonal at init
  in the reference recipe: a QR a leaf is set-up the cut leaves out);
- every other matrix Glorot-uniform, the vocab projection times
  ``w_out_scale`` (random weights give near-uniform next-token
  distributions, where every step is a near-tie; a trained model's are
  peaked);
- biases U(-bias_range, bias_range), so that each bias path carries a
  value, and the vocab bias of the ids a trained model never emits
  (``banned_ids``: <pad>, <sos>) at ``banned_bias``."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[Tuple, Tuple[int, ...], str]   # (path, shape, kind)


def _gru(prefix: Tuple, x: int, h: int) -> List[Leaf]:
    return [(prefix + ("bh",), (3 * h,), "bias"),
            (prefix + ("bi",), (3 * h,), "bias"),
            (prefix + ("uh",), (h, 3 * h), "recurrent"),
            (prefix + ("wi",), (x, 3 * h), "matrix")]


def _attn(prefix: Tuple, ctx: int, query: int, a: int) -> List[Leaf]:
    return [(prefix + ("ba",), (a,), "bias"),
            (prefix + ("ua",), (query, a), "matrix"),
            (prefix + ("va",), (a,), "vector"),
            (prefix + ("wa",), (ctx, a), "matrix")]


def layout(m: Dict) -> List[Leaf]:
    """Every leaf of the tree of model config ``m`` (a dict of the model's
    widths), in a fixed order."""
    E, H, D, A, S = (m["emb_dim"], m["hidden_dim"], m["dec_hidden_dim"],
                     m["attn_dim"], m["shared_dim"])
    C, R, V = 2 * H, E, m["tgt_vocab_size"]
    leaves: List[Leaf] = [(("encoder", "embed", "table"),
                           (m["src_vocab_size"], E), "embedding")]
    for i in range(m["enc_layers"]):
        x = E if i == 0 else C
        for d in ("bwd", "fwd"):
            leaves += _gru(("encoder", "layers", i, d), x, H)
    leaves += [(("decoder", "embed", "table"), (V, E), "embedding")]
    leaves += _gru(("decoder", "gru1"), E, D)
    leaves += _attn(("decoder", "attn"), C, D, A)
    leaves += _gru(("decoder", "gru2"), C, D)
    leaves += [(("decoder", "readout", "b"), (R,), "bias"),
               (("decoder", "readout", "b_out"), (V,), "out_bias"),
               (("decoder", "readout", "wc"), (C, R), "matrix"),
               (("decoder", "readout", "ws"), (D, R), "matrix"),
               (("decoder", "readout", "wy"), (E, R), "matrix"),
               (("decoder", "readout", "w_out"), (R, V), "out_matrix"),
               (("init", "b"), (D,), "bias"),
               (("init", "w_ctx"), (C, D), "matrix"),
               (("init", "w_vis"), (C, D), "matrix")]
    leaves += _attn(("vse", "ground"), C, S, A)
    leaves += [(("vse", "img_proj", "b"), (S,), "bias"),
               (("vse", "img_proj", "w"), (m["img_feat_dim"], S), "matrix"),
               (("vse", "txt_proj", "b"), (S,), "bias"),
               (("vse", "txt_proj", "w"), (C, S), "matrix")]
    return leaves


def _put(tree: Dict, path: Tuple, x: torch.Tensor) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
            continue
        if key not in node:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    node[path[-1]] = x


def make(m: Dict, recipe: Dict, seed: int, device) -> Dict:
    """The fp32 parameter tree of model config ``m`` under weight recipe
    ``recipe`` (the configuration file's ``weights``), drawn from ``seed``
    on ``device``: one uniform and one normal draw, each leaf a contiguous
    slice of one of them."""
    leaves = layout(m)
    normal = {"embedding", "recurrent"}
    n_u = sum(math.prod(s) for _, s, k in leaves if k not in normal)
    n_n = sum(math.prod(s) for _, s, k in leaves if k in normal)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand(n_u, generator=gen, device=device).mul_(2.0).sub_(1.0)
    g = torch.randn(n_n, generator=gen, device=device)
    tree: Dict = {}
    ou = og = 0
    for path, shape, kind in leaves:
        n = math.prod(shape)
        if kind in normal:
            x, og = g[og:og + n].view(shape), og + n
            x.mul_(shape[1] ** -0.5 if kind == "embedding"
                   else shape[0] ** -0.5)
        else:
            x, ou = u[ou:ou + n].view(shape), ou + n
            if kind in ("bias", "out_bias"):
                x.mul_(recipe["bias_range"])
            elif kind == "vector":
                x.mul_(math.sqrt(6.0 / (shape[0] + 1)))
            else:
                x.mul_(math.sqrt(6.0 / (shape[0] + shape[1])))
                if kind == "out_matrix":
                    x.mul_(recipe["w_out_scale"])
            if kind == "out_bias":
                x[list(recipe["banned_ids"])] = recipe["banned_bias"]
        _put(tree, path, x)
    return tree


def leaves_of(tree) -> List[torch.Tensor]:
    """The tree's tensors in its sorted-key order (dict keys sorted, lists
    in order): the order of the port's ``tree_leaves`` and of the
    reference's optimizer."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_of(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves_of(v)]
    return [tree]


def leaf_names(tree, prefix: str = "") -> List[str]:
    """The leaves' paths in ``leaves_of``'s order, '/'-joined."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)
