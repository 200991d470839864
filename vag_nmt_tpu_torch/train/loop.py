"""Epoch training loop (counterpart of the single-device path of the JAX
package's ``train/loop.py``): joint CE+VSE steps, periodic dev-set beam
decode + BLEU, LR decay on a plateau, early stop, ``best``/``last``
checkpoints and resume with the in-epoch cursor.

Batches are visited in ``BucketBatcher.epoch_stacked(epoch,
steps_per_dispatch)`` order, one train step per row of each stack, so the
port trains on the same batches in the same order as the JAX loop (which
runs each stack as one K-step dispatch). Image features and compact
batches are kept: the (N, F) feature table lives on the device and batches
carry row ids. The host reads the device only at log points (one small
row of metrics), at evals and at checkpoints."""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, Iterator, Optional, Sequence

import torch

from vag_nmt_tpu_torch.core.config import Config
from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device
from vag_nmt_tpu_torch.core.flops import train_step_flops
from vag_nmt_tpu_torch.core.metrics import MetricsLogger
from vag_nmt_tpu_torch.data.batching import Batch, BucketBatcher, Example
from vag_nmt_tpu_torch.data.vocab import Vocab
from vag_nmt_tpu_torch.decode.translate import build_img_table, translate_corpus
from vag_nmt_tpu_torch.evaluation.bleu import corpus_bleu
from vag_nmt_tpu_torch.train.checkpoint import (
    has_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from vag_nmt_tpu_torch.train.state import TrainState, create_train_state
from vag_nmt_tpu_torch.train.step import make_train_step


def _step_rows(stream: Iterable[Batch], n_skip: int) -> Iterator[Batch]:
    """One batch per train step from a (stacked) epoch stream, skipping the
    first n_skip steps (the resume cursor): the batcher's order is a
    function of its seed and the epoch, so the skipped rows are exactly
    those the interrupted run trained on."""
    done = 0
    for b in stream:
        rows = ([{k: v[i] for k, v in b.items()} for i in range(b["src"].shape[0])]
                if b["src"].ndim == 3 else [b])
        for row in rows:
            if done >= n_skip:
                yield row
            done += 1


def train_loop(
    cfg: Config,
    out_dir: str,
    train_examples: Sequence[Example],
    dev_examples: Sequence[Example],
    tgt_vocab: Vocab,
    dev_refs: Sequence[str],          # de-BPE'd tokenized reference lines
    *,
    max_steps: Optional[int] = None,
    logger: Optional[MetricsLogger] = None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Train from the seed's init (or resume from ``last`` when
    cfg.train.resume) and return {"steps", "best_bleu"[, "dev_bleu"]}.
    device: None = the card. A run stopped at max_steps and resumed equals
    an uninterrupted run bit for bit on the same device."""
    dev = resolve_device(device)
    log = logger or MetricsLogger(os.path.join(out_dir, "metrics.jsonl"))
    try:
        return _train(cfg, out_dir, train_examples, dev_examples, tgt_vocab,
                      dev_refs, max_steps, log, dev)
    finally:
        if logger is None:
            log.close()


def _train(cfg: Config, out_dir: str, train_examples: Sequence[Example],
           dev_examples: Sequence[Example], tgt_vocab: Vocab,
           dev_refs: Sequence[str], max_steps: Optional[int],
           log: MetricsLogger, dev: torch.device) -> Dict[str, float]:
    ckpt_dir = os.path.join(out_dir, cfg.train.checkpoint_dir)
    m = cfg.model
    state = create_train_state(
        cfg, torch.Generator().manual_seed(cfg.train.seed), device=dev)

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
    step_fn = make_train_step(cfg, with_img_table=use_table)
    K = max(1, int(cfg.train.steps_per_dispatch))

    start_epoch = start_cursor = 0
    best_bleu = -1.0
    evals_since_best = 0
    if cfg.train.resume and has_checkpoint(ckpt_dir, "last"):
        state, meta = load_checkpoint(ckpt_dir, "last", device=dev)
        start_epoch = int(meta.get("epoch", 0))
        start_cursor = int(meta.get("epoch_cursor", 0))
        best_bleu = float(meta.get("best_bleu", -1.0))
        evals_since_best = int(meta.get("evals_since_best", 0))
        log.log("resume", step=state.step, epoch=start_epoch,
                epoch_cursor=start_cursor, best_bleu=best_bleu)

    final: Dict[str, float] = {}
    if max_steps is not None and state.step >= max_steps:
        log.log("resume_at_terminal_state", step=state.step,
                max_steps=max_steps)
        final.update({"steps": float(state.step), "best_bleu": best_bleu})
        log.log("done", **final)
        return final

    def run_eval(state: TrainState, epoch: int):
        nonlocal best_bleu, evals_since_best
        with torch.inference_mode():
            hyps, dstats = translate_corpus(
                state.params, cfg, dev_examples, tgt_vocab,
                beam_size=cfg.decode.beam_size, img_table=dev_img_table,
                device=dev)
        bleu = corpus_bleu(hyps, list(dev_refs)).bleu
        if bleu > best_bleu:
            best_bleu = bleu
            evals_since_best = 0
            save_checkpoint(ckpt_dir, "best", state,
                            {"epoch": epoch, "best_bleu": best_bleu})
        else:
            evals_since_best += 1
            if evals_since_best % cfg.train.lr_decay_patience == 0:
                state = state._replace(lr=state.lr * cfg.train.lr_decay_factor)
                log.log("lr_decay", lr=float(state.lr))
        log.log("eval", step=state.step, epoch=epoch, dev_bleu=bleu,
                best_bleu=best_bleu,
                dev_sent_per_sec=dstats.get("sentences_per_sec", 0.0))
        final["dev_bleu"] = bleu
        return state, evals_since_best >= cfg.train.early_stop_patience

    log_every = max(cfg.train.log_every_steps, 1)
    log_mod = 1 % log_every
    flops_by_shape: Dict = {}
    last_t, last_step = time.perf_counter(), state.step

    def log_row(aux, batch, epoch) -> None:
        # The fetch waits for every step enqueued so far, so step_time_s is
        # a completion rate, not an enqueue rate.
        nonlocal last_t, last_step
        keys = sorted(aux)
        row = torch.stack([aux[k].float() for k in keys]).cpu().tolist()
        now = time.perf_counter()
        dt = (now - last_t) / max(state.step - last_step, 1)
        last_t, last_step = now, state.step
        tgt = batch["tgt"] if "tgt" in batch else batch["tgt_in"]
        shape = (tuple(batch["src"].shape), tuple(tgt.shape))
        if shape not in flops_by_shape:
            flops_by_shape[shape] = train_step_flops(cfg, shape[0][0],
                                                     shape[0][1], shape[1][1])
        log.log("train", step=state.step, epoch=epoch, step_time_s=dt,
                tflops=flops_by_shape[shape] / max(dt, 1e-9) / 1e12,
                **dict(zip(keys, row)))

    stop = False
    for epoch in range(start_epoch, cfg.train.max_epochs):
        cursor = start_cursor if epoch == start_epoch else 0
        interrupted = False
        for batch in _step_rows(batcher.epoch_stacked(epoch, K), cursor):
            state, aux = step_fn(state, batch, train_img_table)
            cursor += 1
            if state.step % log_every == log_mod:
                log_row(aux, batch, epoch)
            if (cfg.train.eval_every_steps > 0
                    and state.step % cfg.train.eval_every_steps == 0):
                state, early = run_eval(state, epoch)
                if early:
                    log.log("early_stop", step=state.step)
                    stop = True
                last_t, last_step = time.perf_counter(), state.step
            if max_steps is not None and state.step >= max_steps:
                stop = True
            if stop:
                interrupted = True
                break
        # A mid-epoch stop records the current epoch and the in-epoch
        # cursor, so resume continues at the exact next batch; an epoch's
        # end records (epoch + 1, cursor 0).
        save_checkpoint(ckpt_dir, "last", state,
                        {"epoch": epoch if interrupted else epoch + 1,
                         "epoch_cursor": cursor if interrupted else 0,
                         "best_bleu": best_bleu,
                         "evals_since_best": evals_since_best})
        last_t, last_step = time.perf_counter(), state.step
        if stop:
            break

    final.update({"steps": float(state.step), "best_bleu": best_bleu})
    log.log("done", **final)
    return final
