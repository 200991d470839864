"""The plain reference against the port's plain path at a toy size on the
CPU (the port's kernels' plain versions: the same mathematics), and its
lower precisions."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.drivers.common import port_config
from portbench.drivers.train import compare
from portbench.reference.model import Reference, leaves, train

from .conftest import tiny_conf


def _inputs(m, B=6, T=9, seed=0):
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(3, T + 1, (B,), generator=g)
    src = torch.randint(4, m["src_vocab_size"], (B, T), generator=g)
    mask = (torch.arange(T)[None] < lens[:, None]).float()
    src = src * mask.long()
    img = torch.rand((B, m["img_feat_dim"]), generator=g)
    return src, mask, img, lens


def test_beam_search_and_scores_match_the_ports():
    from vag_nmt_tpu_torch.decode.beam import beam_search
    from vag_nmt_tpu_torch.models.model import prepare_decode

    conf = tiny_conf()
    m = conf["model"]
    cfg = port_config(conf, 1)
    p = weights.make(m, conf["weights"], 7, "cpu")
    src, mask, img, lens = _inputs(m)
    caps = lens + 1
    state = prepare_decode(p, cfg.model, {"src": src, "src_mask": mask,
                                          "img": img}, device="cpu")
    res = beam_search(p, cfg.model, state, beam_size=5, max_len=64,
                      row_cap=caps, device="cpu", dispatch="eager")
    ref = Reference(p, m)
    toks, scores = ref.beam_search(src, mask, img, caps, 5, 1.0)
    for i in range(src.shape[0]):
        n = int(res.best_lengths[i])
        assert res.best_tokens[i, :n].tolist() == toks[i]
    assert torch.allclose(res.scores[:, 0], scores, atol=1e-5)
    tf = ref.score(src, mask, img, toks, 1.0)
    assert torch.allclose(tf, scores, atol=1e-5)


def test_train_steps_match_the_ports():
    from vag_nmt_tpu_torch.train.state import state_from_params, tree_leaves
    from vag_nmt_tpu_torch.train.step import make_train_step

    conf = tiny_conf()
    m = conf["model"]
    cfg = port_config(conf, 2)
    p = weights.make(m, conf["weights"], 3, "cpu")
    step = make_train_step(cfg)
    state = state_from_params(cfg, weights.map_tree(torch.clone, p))
    B, T, Tt = 8, 9, 7
    g = torch.Generator().manual_seed(4)
    batches, ref_batches, gens = [], [], []
    for k in range(3):
        src, mask, img, lens = _inputs(m, B, T, seed=10 + k)
        tl = torch.randint(2, Tt, (B,), generator=g)
        tgt = torch.randint(4, m["tgt_vocab_size"], (B, Tt), generator=g)
        pos = torch.arange(Tt)[None]
        tgt = torch.where(pos < tl[:, None], tgt, torch.zeros_like(tgt))
        tgt_in = torch.cat([torch.full((B, 1), 2), tgt[:, :-1]], 1)
        tgt_out = torch.where(pos == tl[:, None], torch.full_like(tgt, 3), tgt)
        b = {"src": src, "src_mask": mask, "tgt_in": tgt_in,
             "tgt_out": tgt_out, "tgt_mask": (pos <= tl[:, None]).float(),
             "sample_mask": torch.ones(B), "img": img}
        batches.append({k2: v.numpy() for k2, v in b.items()})
        ref_batches.append(b)
        gen = torch.Generator()
        gen.manual_seed(((cfg.train.seed + 1) << 32) + k)
        gens.append(gen)
    losses = []
    for k, b in enumerate(batches):
        state, aux = step(state, b)
        losses.append(float(aux["loss"]))
        if k == 0:
            g1 = [x / (1 - cfg.train.adam_b1) for x in tree_leaves(state.mu)]
    hp = {"dropout": m["dropout"], "vse_margin": m["vse_margin"],
          "vse_weight": m["vse_weight"], "lr": cfg.train.learning_rate,
          "b1": cfg.train.adam_b1, "b2": cfg.train.adam_b2,
          "eps": cfg.train.adam_eps, "clip": cfg.train.grad_clip_norm}
    out = train(p, m, ref_batches, gens, hp)
    assert np.allclose(losses, out["losses"], rtol=1e-5)
    for a, b in zip(g1, out["grads"]):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-7)
    # elementwise, Adam turns a gradient near zero into a step of +-lr
    # either way; the check's measure compares each leaf's change
    got = {"losses": losses, "grads": g1,
           "params": tree_leaves(state.params)}
    gaps, _ = compare(got, out, p)
    assert max(gaps.values()) < 1e-4, gaps


@pytest.mark.parametrize("precision", ["tf32", "fp8"])
def test_lower_precisions_round_the_products(precision):
    conf = tiny_conf()
    m = conf["model"]
    p = weights.make(m, conf["weights"], 5, "cpu")
    src, mask, img, _ = _inputs(m)
    exact = Reference(p, m).prepare(src, mask, img)[2]
    low = Reference(p, m, precision).prepare(src, mask, img)[2]
    gap = float((exact - low).abs().max())
    # TF32 keeps 10 bits of mantissa, e4m3 3: each reads far above fp32's
    # own rounding
    assert gap > (1e-4 if precision == "tf32" else 1e-2)
    assert len(leaves(p)) == len(weights.leaves_of(p))
