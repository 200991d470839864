"""Epoch training loop (counterpart of the single-device path of the JAX
package's ``train/loop.py``): joint CE+VSE steps, periodic dev-set beam
decode + BLEU, LR decay on a plateau, early stop, ``best``/``last``
checkpoints and resume with the in-epoch cursor.

Batches are visited in ``BucketBatcher.epoch_stacked(epoch,
steps_per_dispatch)`` order, as in the JAX loop: a stack of K same-shape
batches runs as one K-step dispatch (on the card a replayed CUDA graph,
``train/graphs.py``; else the eager ``make_multi_step``), a stack that
straddles an eval or max_steps boundary as single steps, so the boundary
falls on the exact step, and the leftover single batches as single eager
steps. Image features and compact batches are kept: the (N, F) feature
table lives on the device and batches carry row ids. The host reads the
device only at log points (one small read a dispatch that holds one), at
evals and at checkpoints.

Under a mesh every rank builds the same batch order and trains on its
data index's rows of each batch (``train/step.py``); with a model axis
each rank holds its vocab slices from the init on. Only rank 0 logs and
writes checkpoints (full tensors: every rank takes part in the gather of
the slices) and every rank waits for a save at a barrier; resume reads on
every rank. The dev eval decodes through the mesh and every rank scores
the gathered hypotheses, so the LR-decay and early-stop decisions agree
without a broadcast. Under a mesh of several ranks the K-stacks run
through the eager ``make_multi_step`` on each rank's rows."""

from __future__ import annotations

import io
import math
import os
import time
from typing import Dict, Iterable, Iterator, Optional, Sequence

import torch

from vag_nmt_tpu_torch.core.config import Config
from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device
from vag_nmt_tpu_torch.core.flops import train_step_flops
from vag_nmt_tpu_torch.core.graphs import resolve_dispatch
from vag_nmt_tpu_torch.core.metrics import MetricsLogger
from vag_nmt_tpu_torch.data.batching import Batch, BucketBatcher, Example
from vag_nmt_tpu_torch.data.vocab import Vocab
from vag_nmt_tpu_torch.decode.translate import build_img_table, translate_corpus
from vag_nmt_tpu_torch.evaluation.bleu import corpus_bleu
from vag_nmt_tpu_torch.parallel.sharding import Mesh
from vag_nmt_tpu_torch.train.checkpoint import (
    has_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from vag_nmt_tpu_torch.train.graphs import StepGraphs, eager_stats
from vag_nmt_tpu_torch.train.state import TrainState, create_train_state
from vag_nmt_tpu_torch.train.step import (make_multi_step, make_train_step,
                                          row)


def _step_rows(stream: Iterable[Batch], n_skip: int) -> Iterator[Batch]:
    """One batch per train step from a (stacked) epoch stream, from step
    n_skip on: the batches the loop trains on, in its order."""
    done = 0
    for b in stream:
        rows = ([row(b, i) for i in range(b["src"].shape[0])]
                if b["src"].ndim == 3 else [b])
        for r in rows:
            if done >= n_skip:
                yield r
            done += 1


def _skip_step_rows(stream: Iterable[Batch], n_skip: int) -> Iterator[Batch]:
    """An epoch's (stacked) batch stream without its first n_skip steps
    (the resume cursor): stacks before the cursor are skipped whole, the
    one that straddles it is split into the single rows after it, and the
    stacks after it stay stacks. The batcher's order is a function of its
    seed and the epoch, so the skipped steps are exactly those the
    interrupted run trained on."""
    skipped = 0
    for b in stream:
        k = b["src"].shape[0] if b["src"].ndim == 3 else 1
        if skipped >= n_skip:
            yield b
        elif skipped + k <= n_skip:
            skipped += k
        else:
            first, skipped = n_skip - skipped, n_skip
            for i in range(first, k):
                yield row(b, i)


def train_loop(
    cfg: Config,
    out_dir: str,
    train_examples: Sequence[Example],
    dev_examples: Sequence[Example],
    tgt_vocab: Vocab,
    dev_refs: Sequence[str],          # de-BPE'd tokenized reference lines
    *,
    mesh: Optional[Mesh] = None,
    max_steps: Optional[int] = None,
    logger: Optional[MetricsLogger] = None,
    device: DeviceLike = None,
    debug_nans: bool = False,
    dispatch: Optional[str] = None,
) -> Dict[str, float]:
    """Train from the seed's init (or resume from ``last`` when
    cfg.train.resume, from the port's checkpoint or the JAX package's) and
    return {"steps", "best_bleu"[, "dev_bleu"]}. device: None = the card.
    A run stopped at max_steps and resumed equals an uninterrupted run bit
    for bit on the same device and dispatch. debug_nans: read each
    dispatch's losses after it and raise FloatingPointError at the first
    that is not finite (one host read a dispatch). mesh: a mesh
    (``parallel.make_mesh``, a model axis included), the same call on
    every rank; ranks other than 0 write nothing (their logger is not
    used).

    dispatch: how a stack of K = cfg.train.steps_per_dispatch same-shape
    batches runs (``core/graphs.resolve_dispatch``): None is "graph" on a
    CUDA device without a mesh of several ranks, else "eager". "graph":
    one replay of a CUDA graph captured for its shape key
    (``train/graphs.py``); "eager": one call of ``make_multi_step``.
    "graph" on the CPU or on such a mesh raises ValueError. Either way the
    leftover single batches, and the rows of a stack that straddles an
    eval or max_steps boundary, run as single eager steps. The run's
    dispatch stats (dispatch, captures, replays, capture_s, pool_bytes)
    are logged once, as "dispatch"."""
    dev = resolve_device(device)
    dispatch = resolve_dispatch(dispatch, dev, mesh)
    if mesh is not None and not mesh.is_main:
        logger = MetricsLogger(None, stream=io.StringIO())
    log = logger or MetricsLogger(os.path.join(out_dir, "metrics.jsonl"))
    try:
        return _train(cfg, out_dir, train_examples, dev_examples, tgt_vocab,
                      dev_refs, max_steps, log, dev, debug_nans, mesh,
                      dispatch)
    finally:
        if logger is None:
            log.close()


def _train(cfg: Config, out_dir: str, train_examples: Sequence[Example],
           dev_examples: Sequence[Example], tgt_vocab: Vocab,
           dev_refs: Sequence[str], max_steps: Optional[int],
           log: MetricsLogger, dev: torch.device,
           debug_nans: bool = False,
           mesh: Optional[Mesh] = None,
           dispatch: str = "eager") -> Dict[str, float]:
    ckpt_dir = os.path.join(out_dir, cfg.train.checkpoint_dir)
    run_meta = {"compute_dtype": cfg.model.compute_dtype}
    if mesh is not None:
        run_meta["data_parallel"] = {"n_data": mesh.n_data,
                                     "n_model": mesh.n_model,
                                     "backend": mesh.backend}
        log.log("data_parallel", **run_meta["data_parallel"])

    def save(tag: str, state: TrainState, meta: Dict) -> None:
        save_checkpoint(ckpt_dir, tag, state, {**meta, **run_meta}, mesh=mesh)
        if mesh is not None:
            mesh.barrier()

    m = cfg.model
    state = create_train_state(
        cfg, torch.Generator().manual_seed(cfg.train.seed), device=dev,
        mesh=mesh)

    use_table = m.multimodal
    train_img_table = dev_img_table = None
    if use_table:
        missing = sum(ex.img is None for ex in train_examples)
        if missing:
            raise ValueError(
                f"multimodal training needs image features for every train "
                f"example; {missing}/{len(train_examples)} are missing .img")
        train_img_table = build_img_table(list(train_examples),
                                          m.img_feat_dim, device=dev)
        if dev_examples:
            if not all(ex.img is not None for ex in dev_examples):
                raise ValueError(
                    "multimodal training needs dev-set image features for "
                    "the periodic BLEU eval (dev examples are missing .img)")
            dev_img_table = build_img_table(list(dev_examples),
                                            m.img_feat_dim, device=dev)
    compact = m.src_vocab_size <= 65535 and m.tgt_vocab_size <= 65535
    batcher = BucketBatcher(
        train_examples, cfg.data.batch_size, cfg.data.length_buckets,
        seed=cfg.data.shuffle_seed, image_ids=use_table,
        img_dim=m.img_feat_dim, compact=compact)
    step_fn = make_train_step(cfg, mesh=mesh, with_img_table=use_table)
    multi_fn = make_multi_step(cfg, mesh=mesh, with_img_table=use_table)
    K = max(1, int(cfg.train.steps_per_dispatch))

    start_epoch = start_cursor = 0
    best_bleu = -1.0
    evals_since_best = 0
    if cfg.train.resume and has_checkpoint(ckpt_dir, "last"):
        state, meta = load_checkpoint(ckpt_dir, "last", device=dev, cfg=m,
                                      mesh=mesh, into=state)
        start_epoch = int(meta.get("epoch", 0))
        start_cursor = int(meta.get("epoch_cursor", 0))
        best_bleu = float(meta.get("best_bleu", -1.0))
        evals_since_best = int(meta.get("evals_since_best", 0))
        log.log("resume", step=state.step, epoch=start_epoch,
                epoch_cursor=start_cursor, best_bleu=best_bleu)

    # The K-stacks' dispatch: replayed CUDA graphs over the state's
    # tensors, or the eager K-step call.
    graphs = (StepGraphs(cfg, state, img_table=train_img_table,
                         with_img_table=use_table)
              if dispatch == "graph" else None)

    def dispatch_stats() -> Dict:
        return eager_stats() if graphs is None else graphs.stats()

    final: Dict[str, float] = {}
    if max_steps is not None and state.step >= max_steps:
        log.log("resume_at_terminal_state", step=state.step,
                max_steps=max_steps)
        log.log("dispatch", **dispatch_stats())
        final.update({"steps": float(state.step), "best_bleu": best_bleu})
        log.log("done", **final)
        return final

    def run_eval(state: TrainState, epoch: int):
        nonlocal best_bleu, evals_since_best
        with torch.inference_mode():
            hyps, dstats = translate_corpus(
                state.params, cfg, dev_examples, tgt_vocab,
                beam_size=cfg.decode.beam_size, img_table=dev_img_table,
                mesh=mesh, device=dev)
        bleu = corpus_bleu(hyps, list(dev_refs)).bleu
        if bleu > best_bleu:
            best_bleu = bleu
            evals_since_best = 0
            save("best", state, {"epoch": epoch, "best_bleu": best_bleu})
        else:
            evals_since_best += 1
            if evals_since_best % cfg.train.lr_decay_patience == 0:
                # in place: a captured graph reads the new rate
                state.lr.mul_(cfg.train.lr_decay_factor)
                log.log("lr_decay", lr=float(state.lr))
        log.log("eval", step=state.step, epoch=epoch, dev_bleu=bleu,
                best_bleu=best_bleu,
                dev_sent_per_sec=dstats.get("sentences_per_sec", 0.0))
        final["dev_bleu"] = bleu
        return state, evals_since_best >= cfg.train.early_stop_patience

    log_every = max(cfg.train.log_every_steps, 1)
    log_rows = mesh is None or mesh.is_main     # one host read a dispatch
    log_mod = 1 % log_every
    eval_every = cfg.train.eval_every_steps
    flops_by_shape: Dict = {}
    last_t, last_step = time.perf_counter(), state.step

    def log_hits(aux, batch, epoch, base: int, k: int) -> None:
        # One fetch a dispatch with a log point; it waits for every step
        # enqueued so far, so step_time_s is a completion rate, not an
        # enqueue rate.
        nonlocal last_t, last_step
        hits = [j for j in range(1, k + 1)
                if (base + j) % log_every == log_mod]
        if not hits or not log_rows:
            return
        keys = sorted(aux)
        rows = torch.stack([aux[kk].float().reshape(-1) for kk in keys],
                           dim=1).cpu().tolist()
        now = time.perf_counter()
        dt = (now - last_t) / max(base + k - last_step, 1)
        last_t, last_step = now, base + k
        tgt = batch["tgt"] if "tgt" in batch else batch["tgt_in"]
        shape = (tuple(batch["src"].shape[-2:]), tgt.shape[-1])
        if shape not in flops_by_shape:
            flops_by_shape[shape] = train_step_flops(cfg, *shape[0],
                                                     shape[1])
        for j in hits:
            log.log("train", step=base + j, epoch=epoch, step_time_s=dt,
                    tflops=flops_by_shape[shape] / max(dt, 1e-9) / 1e12,
                    **dict(zip(keys, rows[j - 1])))

    def check_losses(aux, base: int) -> None:
        # debug_nans: the dispatch's losses in one read, the first that is
        # not finite raised with its step
        losses = aux["loss"].reshape(-1)
        if not bool(torch.isfinite(losses).all()):
            vals = losses.cpu().tolist()
            j = next(i for i, v in enumerate(vals) if not math.isfinite(v))
            raise FloatingPointError(f"loss {vals[j]} at step {base + j + 1}")

    stop = False

    def boundary(epoch: int) -> bool:
        """Eval / max_steps / early-stop bookkeeping after a dispatch;
        True to stop."""
        nonlocal state, stop, last_t, last_step
        if eval_every > 0 and state.step % eval_every == 0:
            state, early = run_eval(state, epoch)
            if early:
                log.log("early_stop", step=state.step)
                stop = True
            last_t, last_step = time.perf_counter(), state.step
        if max_steps is not None and state.step >= max_steps:
            stop = True
        return stop

    for epoch in range(start_epoch, cfg.train.max_epochs):
        cursor = start_cursor if epoch == start_epoch else 0
        interrupted = False
        for hb in _skip_step_rows(batcher.epoch_stacked(epoch, K), cursor):
            k = hb["src"].shape[0] if hb["src"].ndim == 3 else 1
            rem_eval = (eval_every - state.step % eval_every
                        if eval_every > 0 else k + 1)
            rem_max = max_steps - state.step if max_steps is not None else k + 1
            if hb["src"].ndim == 3 and k <= min(rem_eval, rem_max):
                items = [(hb, k)]
            elif hb["src"].ndim == 3:
                # an eval or max_steps boundary falls inside the stack: its
                # rows run as single steps, so the boundary falls on the
                # exact step
                items = [(row(hb, i), 1) for i in range(k)]
            else:
                items = [(hb, 1)]
            for b, n in items:
                base = state.step
                if n > 1 and graphs is not None:
                    state, aux = graphs.run(state, b)
                elif n > 1:
                    state, aux = multi_fn(state, b, train_img_table)
                else:
                    state, aux = step_fn(state, b, train_img_table)
                cursor += n
                if debug_nans:
                    check_losses(aux, base)
                log_hits(aux, b, epoch, base, n)
                if boundary(epoch):
                    interrupted = True
                    break
            if interrupted:
                break
        # A mid-epoch stop records the current epoch and the in-epoch
        # cursor, so resume continues at the exact next batch; an epoch's
        # end records (epoch + 1, cursor 0).
        save("last", state, {"epoch": epoch if interrupted else epoch + 1,
                             "epoch_cursor": cursor if interrupted else 0,
                             "best_bleu": best_bleu,
                             "evals_since_best": evals_since_best})
        last_t, last_step = time.perf_counter(), state.step
        if stop:
            break

    log.log("dispatch", **dispatch_stats())
    final.update({"steps": float(state.step), "best_bleu": best_bleu})
    log.log("done", **final)
    return final
