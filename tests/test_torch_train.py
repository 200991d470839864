"""PyTorch port, the training side against the JAX package: the joint loss
and its full gradient tree, the compact-batch expansion and the bucket
batcher (bit for bit), the clip + Adam update (against optax), the 50-step
toy loss goldens, dropout, and train_loop with checkpoints and an exact
resume. All on the CPU (device="cpu"), where the kernels' plain versions
run. Parameters come from the JAX init through the weight bridge; batches
from numpy.

Tolerances: 1e-5 absolute for the loss, its aux and the gradients (fp32,
sums in another order); 1e-6 relative for one optimizer update on the same
grads; 1e-4 absolute for the 50-step loss goldens, as the JAX test's."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vag_nmt_tpu.core.config import preset as jax_preset
from vag_nmt_tpu.data.batching import BucketBatcher as JBatcher
from vag_nmt_tpu.models import init_params as jax_init_params
from vag_nmt_tpu.models import loss_fn as jax_loss_fn
from vag_nmt_tpu.train.state import make_optimizer
from vag_nmt_tpu.train.step import expand_compact_batch as j_expand

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.data.batching import BucketBatcher
from vag_nmt_tpu_torch.data.datasets import make_toy_examples, toy_vocab
from vag_nmt_tpu_torch.models.layers import dropout
from vag_nmt_tpu_torch.train.checkpoint import load_checkpoint
from vag_nmt_tpu_torch.train.state import (
    apply_update,
    state_from_params,
    tree_leaves,
    tree_unflatten,
)
from vag_nmt_tpu_torch.train.step import expand_compact_batch, make_eval_step

from tests.test_models import make_batch
from tests.test_torch_params import _flat

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ATOL = 1e-5
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _bridged(jcfg, seed=0, biases=True):
    jp = jax_init_params(jax.random.key(seed), jcfg.model)
    if biases:   # non-zero biases so every bias term is exercised
        leaves, tree = jax.tree.flatten(jp)
        rng = np.random.RandomState(seed)
        leaves = [x if x.ndim > 1 else jnp.asarray(0.1 * rng.randn(*x.shape),
                                                   jnp.float32)
                  for x in leaves]
        jp = jax.tree.unflatten(tree, leaves)
    return jp, vt.params_from_numpy(jax.device_get(jp), jcfg.model,
                                    device="cpu")


LOSS_CASES = {
    "multimodal": dict(),
    "text_only": dict(multimodal=False),
    "tied": dict(tied_readout_embedding=True),
    "hard_negatives": dict(vse_hard_negatives=True),
    "filler_rows": dict(),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_gradient_tree_match_jax(case):
    upd = dict(LOSS_CASES[case], gru_impl="xla", dec_scan_impl="xla")
    jcfg = jax_preset("toy").replace(model=upd)
    m = vt.preset("toy").replace(model=upd).model
    jp, tp = _bridged(jcfg)
    batch = dict(make_batch(jcfg, B=6, T=6, Tt=7, seed=2))
    if case == "filler_rows":
        sm = np.array([1, 1, 1, 1, 0, 0], np.float32)
        batch["sample_mask"] = jnp.asarray(sm)
        batch["tgt_mask"] = batch["tgt_mask"] * sm[:, None]
    (want, jaux), jg = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg.model, batch, None, train=True),
        has_aux=True)(jp)
    leaves = [x.requires_grad_(True) for x in tree_leaves(tp)]
    got, aux = vt.loss_fn(tree_unflatten(tp, leaves), m,
                          {k: torch.as_tensor(np.array(v))
                           for k, v in batch.items()}, None, train=True)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), atol=ATOL)
    assert sorted(aux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), atol=ATOL,
                                   err_msg=k)
    fj = dict(_flat(jg))
    ft = dict(_flat(tree_unflatten(tp, leaves)))
    assert sorted(fj) == sorted(ft)
    for k, v in fj.items():
        g = ft[k].grad
        g = torch.zeros_like(ft[k]) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(v), atol=ATOL,
                                   err_msg=k)


def _toy_examples():
    exs = make_toy_examples(90, seed=3, img_dim=64)
    exs[5].tgt = None                     # a row with no target
    return exs


@pytest.mark.parametrize("mode", ["classic", "compact", "stacked"])
def test_bucket_batcher_matches_jax(mode):
    exs = _toy_examples()
    kw = ({"compact": True, "image_ids": True} if mode != "classic"
          else {"include_image": True, "img_dim": 64})
    jb = JBatcher(exs, 16, (8, 16), seed=11, **kw)
    tb = BucketBatcher(exs, 16, (8, 16), seed=11, **kw)
    for epoch in (0, 1):
        if mode == "stacked":
            got, want = tb.epoch_stacked(epoch, 2), jb.epoch_stacked(epoch, 2)
        else:
            got, want = tb.epoch(epoch), jb.epoch(epoch)
        got, want = list(got), list(want)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tb.num_batches() == jb.num_batches()


def test_expand_compact_batch_matches_jax():
    exs = _toy_examples()
    b = next(iter(BucketBatcher(exs, 16, (8, 16), seed=0, compact=True,
                                image_ids=True).epoch(0)))
    last = JBatcher(exs, 16, (8, 16), seed=0, compact=True, image_ids=True)
    for batch in list(last.epoch(0))[-1:] + [b]:   # the last one has filler
        want = j_expand({k: jnp.asarray(v) for k, v in batch.items()})
        got = expand_compact_batch({k: torch.as_tensor(v.astype(np.int32)
                                                       if v.dtype == np.uint16
                                                       else v)
                                    for k, v in batch.items()})
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)


@pytest.mark.parametrize("clip_fires", [False, True])
def test_clip_adam_update_matches_optax(clip_fires):
    """Several updates on the same grads as optax's chain, one with a
    global norm above grad_clip_norm when clip_fires."""
    cfg = vt.preset("toy")
    jcfg = jax_preset("toy")
    jp, tp = _bridged(jcfg, seed=1, biases=False)
    tx = make_optimizer(jcfg)
    opt = tx.init(jp)
    state = state_from_params(cfg, tp)
    rng = np.random.RandomState(4)
    scale = 1.0 if clip_fires else 1e-3
    leaves, tree = jax.tree.flatten(jp)
    for i in range(3):
        g = [(scale * rng.randn(*x.shape)).astype(np.float32) for x in leaves]
        jg = jax.tree.unflatten(tree, [jnp.asarray(x) for x in g])
        norm = float(optax.global_norm(jg))
        assert (norm >= cfg.train.grad_clip_norm) == clip_fires
        upd, opt = tx.update(jg, opt, jp)
        jp = optax.apply_updates(
            jp, jax.tree.map(lambda u: -jcfg.train.learning_rate * u, upd))
        # jax.tree leaves and tree_leaves share one order (sorted keys)
        state, tnorm = apply_update(cfg, state,
                                    [torch.from_numpy(x) for x in g])
        np.testing.assert_allclose(float(tnorm), norm, rtol=1e-6)
    assert state.step == 3
    for k, v in dict(_flat(jp)).items():
        got = dict(_flat(state.params))[k]
        np.testing.assert_allclose(got.numpy(), np.asarray(v), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def _golden_curve(multimodal):
    cfg = vt.preset("toy").replace(model=dict(multimodal=multimodal))
    jcfg = jax_preset("toy").replace(model=dict(multimodal=multimodal))
    jp = jax.device_get(jax_init_params(jax.random.key(cfg.train.seed),
                                        jcfg.model))
    state = state_from_params(cfg, vt.params_from_numpy(jp, cfg.model,
                                                        device="cpu"))
    exs = make_toy_examples(64, seed=41, img_dim=cfg.model.img_feat_dim)
    batcher = BucketBatcher(exs, cfg.data.batch_size, cfg.data.length_buckets,
                            seed=7, include_image=multimodal,
                            img_dim=cfg.model.img_feat_dim)
    step = vt.make_train_step(cfg)
    losses, epoch = [], 0
    while len(losses) < 50:
        for batch in batcher.epoch(epoch):
            state, aux = step(state, batch)
            losses.append(float(aux["loss"]))
            if len(losses) == 50:
                break
        epoch += 1
    return losses


@pytest.mark.parametrize("multimodal,name", [
    (True, "loss_toy_multimodal.json"), (False, "loss_toy_text_only.json")])
def test_golden_loss_curve(multimodal, name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        golden = json.load(f)
    np.testing.assert_allclose(_golden_curve(multimodal), golden, rtol=0,
                               atol=1e-4)


def test_dropout_keep_share_scale_and_seed():
    x = torch.ones(200_000)
    y = dropout(torch.Generator().manual_seed(0), x, 0.3, True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / 0.7, rtol=1e-6)
    assert torch.equal(y, dropout(torch.Generator().manual_seed(0), x, 0.3, True))
    assert dropout(torch.Generator().manual_seed(0), x, 0.3, False) is x
    assert dropout(None, x, 0.3, True) is x


def test_same_generator_seed_gives_same_loss():
    cfg = vt.preset("toy").replace(model=dict(dropout=0.3))
    jp, tp = _bridged(jax_preset("toy"))
    batch = {k: torch.as_tensor(np.array(v))
             for k, v in make_batch(jax_preset("toy"), seed=3).items()}

    def loss(seed):
        return float(vt.loss_fn(tp, cfg.model, batch,
                                torch.Generator().manual_seed(seed))[0])

    assert loss(5) == loss(5)
    assert loss(5) != loss(6)
    assert loss(5) != float(vt.loss_fn(tp, cfg.model, batch, None)[0])


def test_eval_step_is_loss_fn_without_dropout():
    cfg = vt.preset("toy").replace(model=dict(dropout=0.3))
    _, tp = _bridged(jax_preset("toy"))
    batch = make_batch(jax_preset("toy"), seed=4)
    got = make_eval_step(cfg)(tp, {k: np.array(v) for k, v in batch.items()})
    _, want = vt.loss_fn(tp, cfg.model, {k: torch.as_tensor(np.array(v))
                                         for k, v in batch.items()},
                         torch.Generator().manual_seed(0), train=False)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _loop_setup():
    cfg = vt.preset("toy").replace(train=dict(
        eval_every_steps=4, steps_per_dispatch=2, log_every_steps=3))
    train = make_toy_examples(64, seed=0, img_dim=cfg.model.img_feat_dim)
    dev = make_toy_examples(12, seed=1, img_dim=cfg.model.img_feat_dim)
    vocab = toy_vocab()
    refs = [" ".join(vocab.itos[t] for t in ex.tgt) for ex in dev]
    return cfg, train, dev, vocab, refs


def test_train_loop_runs_evaluates_and_checkpoints(tmp_path):
    cfg, train, dev, vocab, refs = _loop_setup()
    spe = BucketBatcher(train, cfg.data.batch_size,
                        cfg.data.length_buckets).num_batches()
    total = spe + 1                  # one step into epoch 1
    cfg = cfg.replace(train=dict(eval_every_steps=total))
    out = vt.train_loop(cfg, str(tmp_path), train, dev, vocab, refs,
                        max_steps=total, device="cpu")
    assert out["steps"] == float(total) and "dev_bleu" in out
    ckpt = tmp_path / cfg.train.checkpoint_dir
    for tag in ("best", "last"):
        assert (ckpt / f"state_{tag}.pt").exists()
        assert (ckpt / f"meta_{tag}.json").exists()
    meta = json.loads((ckpt / "meta_last.json").read_text())
    assert (meta["step"], meta["epoch"], meta["epoch_cursor"]) == (total, 1, 1)
    recs = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    tags = [r["tag"] for r in recs]
    assert tags.count("eval") == 1 and tags[-1] == "done"
    train_rows = [r for r in recs if r["tag"] == "train"]
    assert [r["step"] for r in train_rows] == list(range(1, total + 1, 3))
    assert {"loss", "ce", "acc", "vse", "grad_norm", "lr"} <= set(train_rows[0])


def test_train_loop_resume_is_bit_exact(tmp_path):
    """Stop inside an epoch, resume, and the final state equals an
    uninterrupted run's bit for bit (the batch stream resumes at the
    cursor, the dropout generator is a function of the step)."""
    cfg, train, dev, vocab, refs = _loop_setup()
    cfg = cfg.replace(model=dict(dropout=0.2))
    vt.train_loop(cfg, str(tmp_path / "ref"), train, dev, vocab, refs,
                  max_steps=7, device="cpu")
    vt.train_loop(cfg, str(tmp_path / "ab"), train, dev, vocab, refs,
                  max_steps=3, device="cpu")
    meta = json.loads((tmp_path / "ab" / cfg.train.checkpoint_dir
                       / "meta_last.json").read_text())
    assert (meta["epoch"], meta["epoch_cursor"]) == (0, 3)
    cfg_r = cfg.replace(train=dict(resume=True))
    vt.train_loop(cfg_r, str(tmp_path / "ab"), train, dev, vocab, refs,
                  max_steps=7, device="cpu")
    # a rerun at max_steps trains nothing more
    vt.train_loop(cfg_r, str(tmp_path / "ab"), train, dev, vocab, refs,
                  max_steps=7, device="cpu")
    a, _ = load_checkpoint(str(tmp_path / "ref" / cfg.train.checkpoint_dir),
                           "last", device="cpu")
    b, _ = load_checkpoint(str(tmp_path / "ab" / cfg.train.checkpoint_dir),
                           "last", device="cpu")
    assert a.step == b.step == 7
    assert torch.equal(a.lr, b.lr)
    for tree in ("params", "mu", "nu"):
        for x, y in zip(tree_leaves(getattr(a, tree)),
                        tree_leaves(getattr(b, tree))):
            assert torch.equal(x, y), tree


def test_train_loop_raises_on_missing_train_image(tmp_path):
    cfg, train, dev, vocab, refs = _loop_setup()
    train[3].img = None
    with pytest.raises(ValueError, match="missing .img"):
        vt.train_loop(cfg, str(tmp_path), train, dev, vocab, refs,
                      max_steps=1, device="cpu")
