"""Traffic kind "train": the port's training step over K-stacks and
leftover single steps, as its ``train_loop`` dispatches them, with no
evaluation and no checkpoint.

Set-up makes the weights, the pairs and their image features (a table on
the device), the feed (``BucketBatcher.epoch_stacked(epoch, K)``, compact
batches of image ids), the one train state, the single step
(``make_train_step``) and the stacks' CUDA graphs (``StepGraphs``). It
captures every shape key of the feed once and runs every leftover shape
once, then puts the state's tensors back to the seed's values in place.
From there it drives the first steps through the window's own calls: one
single step on a leftover batch, then one K-stack, each on batches of
epoch 0 (so on rows that all differ), and keeps what the check reads: the
losses, the first step's gradient as the optimizer got it (Adam's first
moment after one step over 1 - b1) and the parameters after the last. The
window takes that same state on through epochs 1, 2, ... (see below),
then waits for the card.

The window runs whole epochs: it ends with the epoch in which
``--seconds`` have passed, so every run's window holds the same mix of
stacks and leftovers (an epoch's leftovers come at its end, and a window
cut inside an epoch would read faster or slower by where it was cut). The
rate is the non-pad target tokens (<eos> included) of every step in the
window over the window's wall clock. The check runs the plain
reference over the same first steps from the same weights, batches and
dropout stream."""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import gen, weights
from portbench.drivers.common import port_config

SOS, EOS = 2, 3


def _real_rows(hb: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(source lengths, decoder steps) of a compact batch's real rows."""
    tl = np.asarray(hb["tgt_len"]).reshape(-1)
    sl = np.asarray(hb["src_len"]).reshape(-1)
    sm = np.asarray(hb["sample_mask"]).reshape(-1)
    real = (tl >= 0) & (sm > 0)
    return sl[real], tl[real] + 1


class Cell:
    def __init__(self, conf: Dict, traffic: Dict, seed: int, device):
        from vag_nmt_tpu_torch.data.batching import BucketBatcher, Example
        from vag_nmt_tpu_torch.train.graphs import StepGraphs
        from vag_nmt_tpu_torch.train.state import state_from_params
        from vag_nmt_tpu_torch.train.step import make_train_step

        self.conf, self.traffic, self.seed, self.dev = conf, traffic, seed, device
        self.m = conf["model"]
        self.cfg = port_config(conf, seed)
        self.dtype = self.cfg.model.compute_dtype
        self.K = int(self.cfg.train.steps_per_dispatch)
        params = weights.make(self.m, conf["weights"],
                              gen.sub_seed(seed, "weights"), device)
        self.p0 = weights.map_tree(torch.clone, params)
        src, tgt = gen.pairs(traffic, self.m, seed)
        self.src, self.tgt = src, tgt
        self.img = gen.features(len(src), self.m["img_feat_dim"],
                                conf["weights"]["feature_mean"],
                                gen.sub_seed(seed, "features"), device)
        exs = [Example(src=s, tgt=t, index=i)
               for i, (s, t) in enumerate(zip(src, tgt))]
        d = self.cfg.data
        self.batcher = BucketBatcher(
            exs, d.batch_size, d.length_buckets, seed=d.shuffle_seed,
            image_ids=True, img_dim=self.m["img_feat_dim"], compact=True)
        self.step_fn = make_train_step(self.cfg, with_img_table=True)
        self.state = state_from_params(self.cfg, params)
        self.graphs = StepGraphs(self.cfg, self.state, img_table=self.img,
                                 with_img_table=True,
                                 capture=device.type == "cuda")
        self.first: Dict = {}
        self.done: Dict = {}
        self.window_s = 0.0

    def _run(self, hb):
        if np.ndim(hb["src"]) == 3:
            return self.graphs.run(self.state, hb)
        return self.step_fn(self.state, hb, self.img)

    def warm(self) -> None:
        from vag_nmt_tpu_torch.train.state import (copy_state,
                                                   state_from_params,
                                                   tree_leaves)

        seen = set()
        first_stack = first_single = None
        for hb in self.batcher.epoch_stacked(0, self.K):
            key = tuple((k, np.shape(v)) for k, v in sorted(hb.items()))
            stack = np.ndim(hb["src"]) == 3
            if stack and first_stack is None:
                first_stack = hb
            if not stack and first_single is None:
                first_single = hb
            if key not in seen:
                seen.add(key)
                self.state, _ = self._run(hb)
        init = state_from_params(self.cfg, weights.map_tree(torch.clone,
                                                            self.p0))
        self.state = copy_state(self.graphs.state, init)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        # the checked steps: a single step, then a K-stack
        if first_single is None or first_stack is None:
            raise ValueError("the check needs an epoch with a K-stack and a "
                             "leftover batch")
        b1 = first_single
        self.state, aux1 = self._run(b1)
        mu1 = [x.clone() for x in tree_leaves(self.state.mu)]
        self.state, aux2 = self._run(first_stack)
        self.first = {
            "batches": [b1] + [{k: v[i] for k, v in first_stack.items()}
                               for i in range(self.K)],
            "losses": [float(aux1["loss"])] + aux2["loss"].cpu().tolist(),
            "grads": [x / (1.0 - self.cfg.train.adam_b1) for x in mu1],
            "params": [x.clone() for x in tree_leaves(self.state.params)]}

    def window(self, seconds: float, span) -> Dict[str, float]:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        tokens = steps = singles = 0
        batches: List[Tuple[np.ndarray, np.ndarray]] = []
        epoch = 1
        while time.perf_counter() < deadline:
            for hb in self.batcher.epoch_stacked(epoch, self.K):
                stack = np.ndim(hb["src"]) == 3
                with span("portbench.train.stack" if stack
                          else "portbench.train.single"):
                    self.state, _ = self._run(hb)
                n = self.K if stack else 1
                steps += n
                singles += 0 if stack else 1
                for b in ([{k: v[i] for k, v in hb.items()}
                           for i in range(self.K)] if stack else [hb]):
                    sl, st = _real_rows(b)
                    tokens += int(st.sum())
                    batches.append((sl, st))
            epoch += 1
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.window_s = time.perf_counter() - t0
        self.done = {"steps": steps, "singles": singles, "batches": batches,
                     "tokens": tokens}
        return {"train_tok_per_s": tokens / self.window_s}

    def reading(self, trace) -> Dict:
        """What the per-layer metrics read (the pairs only in a traced
        run, the only one that reads them)."""
        b = self.done["batches"]
        return {"kind": "train", "m": self.m, "dtype": self.dtype,
                "window_s": self.window_s, "trace": trace,
                "steps": self.done["steps"], "singles": self.done["singles"],
                "batches": b,
                "pairs": [(int(T), int(Tt)) for sl, st in b
                          for T, Tt in zip(sl, st)] if trace is not None
                else []}

    def release(self) -> None:
        """Free the program's state and graphs before the reference runs."""
        self.graphs = self.state = self.step_fn = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- check
    def ref_batch(self, hb: Dict) -> Dict[str, torch.Tensor]:
        """A step's batch for the reference, rebuilt from the benchmark's
        own pairs: the rows the feed put there (by image id, in its order,
        at its padded shapes), their tokens from the pairs themselves.
        Raises ValueError where the program's batch holds other tokens."""
        sm = np.asarray(hb["sample_mask"], np.float32)
        ids = np.asarray(hb["img_ids"])
        B, T = np.shape(hb["src"])
        Tt = np.shape(hb["tgt"])[1]
        src = np.zeros((B, T), np.int64)
        tgt = np.zeros((B, Tt), np.int64)
        tl = np.full((B,), -1, np.int64)
        sl = np.zeros((B,), np.int64)
        for r in range(B):
            if sm[r] > 0:
                s, t = self.src[ids[r]], self.tgt[ids[r]]
                src[r, :len(s)] = s
                sl[r] = len(s)
                tgt[r, :len(t)] = t
                tl[r] = len(t)
        if not (np.array_equal(src, np.asarray(hb["src"], np.int64))
                and np.array_equal(tgt, np.asarray(hb["tgt"], np.int64))):
            raise ValueError("a checked batch holds tokens that are not its "
                             "rows' pairs")
        pos = np.arange(Tt)[None]
        tgt_in = np.concatenate([np.full((B, 1), SOS), tgt[:, :-1]], 1)
        tgt_out = np.where(pos == tl[:, None], EOS, tgt)
        tmask = ((pos <= tl[:, None]) & (tl[:, None] >= 0)) * sm[:, None]
        dev = self.dev
        return {"src": torch.tensor(src, device=dev),
                "src_mask": (torch.arange(T)[None] < torch.tensor(sl)[:, None]
                             ).float().to(dev),
                "tgt_in": torch.tensor(tgt_in, device=dev),
                "tgt_out": torch.tensor(tgt_out, device=dev),
                "tgt_mask": torch.tensor(tmask, dtype=torch.float32,
                                         device=dev),
                "sample_mask": torch.tensor(sm, device=dev),
                "img": self.img[torch.tensor(ids, device=dev).long()]}

    def hp(self) -> Dict:
        t, m = self.cfg.train, self.cfg.model
        return {"dropout": m.dropout, "vse_margin": m.vse_margin,
                "vse_weight": m.vse_weight, "lr": t.learning_rate,
                "b1": t.adam_b1, "b2": t.adam_b2, "eps": t.adam_eps,
                "clip": t.grad_clip_norm}

    def gens(self, n: int) -> List[torch.Generator]:
        """The dropout generators of steps 0..n-1, seeded as the
        configuration states its dropout stream."""
        out = []
        for step in range(n):
            g = torch.Generator(device=self.dev)
            g.manual_seed(((self.cfg.train.seed + 1) << 32) + step)
            out.append(g)
        return out

    def check(self, sample: int = 0, replace=None) -> Tuple[Dict, int, int]:
        """(numbers compared, attempted, failed): the first steps' losses,
        first gradient and parameter change against the reference's.
        ``replace``: a function (cell) -> the same readings as
        ``self.first`` holds, standing in for the program's (the
        control)."""
        from portbench.reference.model import exact_products, train

        got = replace(self) if replace is not None else self.first
        try:
            batches = [self.ref_batch(b) for b in self.first["batches"]]
        except ValueError:
            inf = float("inf")
            return {"loss_gap": inf, "first_loss_gap": inf, "grad_gap": inf,
                    "update_gap": inf}, len(self.first["batches"]), 1
        with exact_products():
            ref = train(self.p0, self.m, batches, self.gens(len(batches)),
                        self.hp())
        numbers, self.look = compare(got, ref, self.p0)
        return numbers, len(batches) + self.done.get("steps", 0), 0


def compare(got: Dict, ref: Dict, p0) -> Dict[str, float]:
    """(The numbers compared for a training cell, the look behind them:
    each step's loss gap, the worst and median leaves, the leaves left
    out.) ``loss_gap``, the largest
    relative gap of a step's loss; ``first_loss_gap``, the first step's
    (steady from seed to seed, where the later steps carry the two
    trajectories' drift); ``grad_gap``, the worst leaf's gap between the
    two norms of the first clipped gradient, over the larger of the
    reference leaf's norm and the median leaf's; ``update_gap``, the same
    of the parameters' change over the steps, leaving out the leaves whose
    reference gradient is under a thousandth of the median leaf's
    (round-off alone moves them under Adam)."""
    inf = float("inf")
    rl = np.array(ref["losses"])
    gl = np.array(got["losses"])
    if gl.shape != rl.shape or not np.all(np.isfinite(gl)):
        return {"loss_gap": inf, "first_loss_gap": inf, "grad_gap": inf,
                "update_gap": inf}, {}
    steps = np.abs(gl - rl) / np.abs(rl)
    x0 = weights.leaves_of(p0)

    def norms(xs):
        return np.array([float(torch.linalg.vector_norm(x.float())) for x in xs])

    g_ref, g_got = norms(ref["grads"]), norms(got["grads"])
    g_med = float(np.median(g_ref))
    grad = np.abs(g_got - g_ref) / np.maximum(g_ref, g_med)
    d_ref = norms([a - b for a, b in zip(ref["params"], x0)])
    d_got = norms([a - b for a, b in zip(got["params"], x0)])
    keep = g_ref >= 1e-3 * g_med
    d_med = float(np.median(d_ref[keep]))
    upd = np.where(keep, np.abs(d_got - d_ref) / np.maximum(d_ref, d_med), 0.0)
    names = weights.leaf_names(p0)
    look = {"step_loss_gaps": steps.tolist(),
                    "grad_worst": names[int(np.argmax(grad))],
                    "grad_median": float(np.median(grad)),
                    "update_worst": names[int(np.argmax(upd))],
                    "update_median": float(np.median(upd[keep])),
            "left_out": [n for n, k in zip(names, keep) if not k]}
    return {"loss_gap": float(steps.max()), "first_loss_gap": float(steps[0]),
            "grad_gap": float(grad.max()), "update_gap": float(upd.max())}, look


def control(precision: str):
    """The control: the reference at ``precision`` in the program's place
    over the same first steps."""
    def replace(cell: Cell):
        from portbench.reference.model import exact_products, train

        batches = [cell.ref_batch(b) for b in cell.first["batches"]]
        with exact_products():
            out = train(cell.p0, cell.m, batches, cell.gens(len(batches)),
                        cell.hp(), precision)
        return out
    return replace
