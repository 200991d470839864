"""The port's command line (counterpart of the JAX package's ``cli.py``):
preprocess and make-toy (raw text to a data directory), then train,
translate, score, retrieval and translate-text on a data directory.

    python -m vag_nmt_tpu_torch preprocess --raw-dir R --out-dir D --langs en,de
    python -m vag_nmt_tpu_torch make-toy  --out-dir D
    python -m vag_nmt_tpu_torch train     --preset m30k_ende_vag --data-dir D --out-dir O
    python -m vag_nmt_tpu_torch translate --data-dir D --checkpoint O \\
                                          --split test2016 --output hyp.txt
    python -m vag_nmt_tpu_torch score     --hyp hyp.txt --ref ref.txt [--meteor --lang de]
    python -m vag_nmt_tpu_torch retrieval --preset m30k_scaled --data-dir D --checkpoint O
    python -m vag_nmt_tpu_torch translate-text --checkpoint O --input lines.txt

One parser, a preset (or a saved ``config.json``) and dotted overrides
(``--set model.emb_dim=512``) cover every configuration. A run directory
may be the port's or the JAX package's: its checkpoint is read by
``train/checkpoint.load_checkpoint``. Every command runs on the card
unless ``--device cpu`` is given, and raises where there is no card.

Data parallelism: under ``python -m torch.distributed.run
--nproc-per-node N -m vag_nmt_tpu_torch ...`` (``WORLD_SIZE`` > 1) train,
translate and retrieval join the process group (``parallel.
init_distributed``: a card a rank where there are enough, NCCL; ranks
sharing a card or on the CPU, gloo) and build the mesh from ``cfg.mesh``
(``make_mesh``); one process builds none. Only rank 0 writes files and
prints the result line; preprocess, make-toy and translate-text run on
rank 0 alone. ``--set mesh.model_axis=N`` (N > 1) adds the model axis,
vocab-dim tensor parallelism: train, translate and retrieval hold the
embedding and output tables as vocab slices over groups of N ranks
(``parallel/tensor.py``); one process with it raises ValueError."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from vag_nmt_tpu_torch.core.config import Config, preset
from vag_nmt_tpu_torch.core.device import resolve_device, world_env
from vag_nmt_tpu_torch.parallel.sharding import host_shard

NOT_PORTED = ("extract-features",)


def _parse_overrides(pairs: Sequence[str]) -> Dict[str, Dict[str, Any]]:
    """['model.emb_dim=512', 'train.seed=7'] -> {'model': {'emb_dim': 512},
    'train': {'seed': 7}}; a JSON list becomes a tuple (config fields are
    tuples)."""
    out: Dict[str, Dict[str, Any]] = {}
    for p in pairs:
        if "=" not in p or "." not in p.split("=", 1)[0]:
            raise SystemExit(f"--set expects section.key=value, got {p!r}")
        key, val = p.split("=", 1)
        section, name = key.split(".", 1)
        try:
            val = json.loads(val)
        except json.JSONDecodeError:
            pass  # keep as string
        if isinstance(val, list):
            val = tuple(val)
        out.setdefault(section, {})[name] = val
    return out


def _load_cfg(args) -> Config:
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = preset(args.preset)
    ov = _parse_overrides(args.set or [])
    if getattr(args, "data_dir", None):
        ov.setdefault("data", {})["data_dir"] = args.data_dir
    return cfg.replace(**ov) if ov else cfg


def _saved_config(args) -> None:
    """Use the run's own config.json (its vocab sizes) unless --config."""
    saved = os.path.join(args.checkpoint, "config.json")
    if not getattr(args, "config", None) and os.path.exists(saved):
        args.config = saved


def _load_split_data(cfg: Config, split: str, *, with_target: bool = True):
    from vag_nmt_tpu_torch.data.datasets import (default_feature_file,
                                                 load_parallel_split)
    from vag_nmt_tpu_torch.data.vocab import Vocab

    d = cfg.data
    src_vocab = Vocab.load(os.path.join(d.data_dir, f"vocab.{d.src_lang}.json"))
    tgt_vocab = Vocab.load(os.path.join(d.data_dir, f"vocab.{d.tgt_lang}.json"))
    feat = ""
    if cfg.model.multimodal:
        feat = d.feature_file or default_feature_file(split)
        if not os.path.exists(os.path.join(d.data_dir, feat)):
            raise SystemExit(
                f"multimodal config but no feature file {feat} in {d.data_dir}"
                " (or --set model.multimodal=false)")
    exs = load_parallel_split(
        d.data_dir, split, d.src_lang, d.tgt_lang, src_vocab, tgt_vocab,
        with_target=with_target, feature_file=feat,
        max_src_len=d.max_src_len, max_tgt_len=d.max_tgt_len)
    return exs, src_vocab, tgt_vocab


def _sized_cfg(cfg: Config, src_vocab, tgt_vocab) -> Config:
    """The model's vocab sizes set to the vocabulary files'."""
    return cfg.replace(model={"src_vocab_size": len(src_vocab),
                              "tgt_vocab_size": len(tgt_vocab)})


def _rank0() -> bool:
    """Whether this process writes: rank 0 of a launch, or the only one."""
    env = world_env()
    return env is None or env["rank"] == 0


def _mesh_or_none(cfg: Config, dev: torch.device):
    """The mesh of a launch of several processes (from cfg.mesh), None for
    one process; one process with mesh.model_axis > 1 raises ValueError
    (the mesh would not take the world of one)."""
    from vag_nmt_tpu_torch.parallel import init_distributed, make_mesh

    if world_env() is None:
        if cfg.mesh.model_axis > 1:
            raise ValueError(f"mesh (data_axis {cfg.mesh.data_axis} x "
                             f"model_axis {cfg.mesh.model_axis}) must take "
                             "the whole world of 1 process")
        return None
    init_distributed(dev)
    return make_mesh(n_data=cfg.mesh.data_axis,
                     n_model=max(1, cfg.mesh.model_axis))


def _load_state(args, cfg: Config, dev: torch.device, mesh=None):
    """The run's state at --tag; with a mesh's model axis, this rank's
    vocab slices of it."""
    from vag_nmt_tpu_torch.train.checkpoint import load_checkpoint

    ckpt_dir = os.path.join(args.checkpoint, cfg.train.checkpoint_dir)
    state, _ = load_checkpoint(ckpt_dir, args.tag, device=dev, cfg=cfg.model,
                               mesh=mesh)
    return state


# ---------------------------------------------------------------------------
# Commands
# ---------------------------------------------------------------------------

def cmd_preprocess(args) -> None:
    from vag_nmt_tpu_torch.data.pipeline import preprocess_corpus

    langs = args.langs.split(",")
    splits = args.splits.split(",")
    preprocess_corpus(args.raw_dir, args.out_dir, splits, langs,
                      bpe_merges=args.bpe_merges,
                      vocab_min_freq=args.vocab_min_freq,
                      vocab_max_size=args.vocab_max_size,
                      lower=not (args.no_lower or args.truecase),
                      truecase=args.truecase,
                      tokenizer=args.tokenizer)
    print(f"preprocessed {splits} x {langs} -> {args.out_dir}")


def cmd_make_toy(args) -> None:
    from vag_nmt_tpu_torch.data.datasets import write_toy_corpus
    from vag_nmt_tpu_torch.data.pipeline import preprocess_toy

    write_toy_corpus(args.out_dir, n_train=args.n_train, n_val=args.n_val,
                     n_test=args.n_test, img_dim=args.img_dim)
    preprocess_toy(args.out_dir)
    print(f"toy corpus -> {args.out_dir}")


def cmd_train(args) -> None:
    from vag_nmt_tpu_torch.core.metrics import MetricsLogger
    from vag_nmt_tpu_torch.core.profiling import maybe_trace
    from vag_nmt_tpu_torch.data.bpe import remove_bpe
    from vag_nmt_tpu_torch.data.datasets import resolve_splits
    from vag_nmt_tpu_torch.train.loop import train_loop

    dev = resolve_device(args.device)
    cfg = _load_cfg(args)
    train_split, dev_split, _ = resolve_splits(cfg.data.dataset)
    train_exs, src_vocab, tgt_vocab = _load_split_data(cfg, train_split)
    dev_exs, _, _ = _load_split_data(cfg, dev_split)
    cfg = _sized_cfg(cfg, src_vocab, tgt_vocab)
    if args.resume:
        cfg = cfg.replace(train={"resume": True})
    if args.max_epochs:
        cfg = cfg.replace(train={"max_epochs": args.max_epochs})
    dev_refs = [" ".join(remove_bpe(tgt_vocab.decode(ex.tgt)))
                for ex in dev_exs]
    mesh = _mesh_or_none(cfg, dev)
    logger = None
    if _rank0():
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
        logger = MetricsLogger(os.path.join(args.out_dir, "metrics.jsonl"))
    anomaly = (torch.autograd.set_detect_anomaly(True) if args.debug_nans
               else contextlib.nullcontext())
    try:
        with anomaly, maybe_trace(args.profile_dir if _rank0() else ""):
            result = train_loop(cfg, args.out_dir, train_exs, dev_exs,
                                tgt_vocab, dev_refs, mesh=mesh,
                                max_steps=args.max_steps, logger=logger,
                                device=dev, debug_nans=args.debug_nans)
    finally:
        if logger is not None:
            logger.close()
    if _rank0():
        print(json.dumps(result))


def cmd_translate(args) -> None:
    from vag_nmt_tpu_torch.core.profiling import maybe_trace
    from vag_nmt_tpu_torch.decode.translate import translate_corpus

    dev = resolve_device(args.device)
    _saved_config(args)
    cfg = _load_cfg(args)
    exs, src_vocab, tgt_vocab = _load_split_data(cfg, args.split,
                                                 with_target=False)
    cfg = _sized_cfg(cfg, src_vocab, tgt_vocab)
    mesh = _mesh_or_none(cfg, dev)
    state = _load_state(args, cfg, dev, mesh)
    with maybe_trace(args.profile_dir if _rank0() else ""), \
            torch.inference_mode():
        hyps, stats = translate_corpus(state.params, cfg, exs, tgt_vocab,
                                       beam_size=args.beam, nbest=args.nbest,
                                       impl=args.impl, mesh=mesh, device=dev)
    if not _rank0():
        return
    with open(args.output, "w", encoding="utf-8") as f:
        if args.nbest:
            # Moses n-best list convention: "<sent-id> ||| <hyp> ||| <score>"
            for i, cands in enumerate(hyps):
                for text, score in cands:
                    f.write(f"{i} ||| {text} ||| {score:.6f}\n")
        else:
            f.write("\n".join(hyps) + "\n")
    print(json.dumps(stats))


def cmd_score(args) -> None:
    from vag_nmt_tpu_torch.data.datasets import read_lines
    from vag_nmt_tpu_torch.evaluation.bleu import corpus_bleu
    from vag_nmt_tpu_torch.evaluation.meteor import meteor_score

    resolve_device(args.device)
    hyps = read_lines(args.hyp)
    refs = read_lines(args.ref)
    r = corpus_bleu(hyps, refs)
    out = {"bleu": r.bleu, "precisions": r.precisions,
           "brevity_penalty": r.brevity_penalty}
    if args.meteor:
        out["meteor"] = meteor_score(hyps, refs, lang=args.lang,
                                     jar=args.meteor_jar or None)
    if _rank0():
        print(json.dumps(out))
        print(str(r), file=sys.stderr)


def cmd_retrieval(args) -> None:
    from vag_nmt_tpu_torch.data.batching import BucketBatcher
    from vag_nmt_tpu_torch.evaluation.retrieval import retrieval_recall
    from vag_nmt_tpu_torch.models.model import embeddings_for_retrieval

    dev = resolve_device(args.device)
    _saved_config(args)
    cfg = _load_cfg(args)
    exs, src_vocab, tgt_vocab = _load_split_data(cfg, args.split)
    cfg = _sized_cfg(cfg, src_vocab, tgt_vocab)
    mesh = _mesh_or_none(cfg, dev)
    state = _load_state(args, cfg, dev, mesh)
    batcher = BucketBatcher(exs, cfg.decode.decode_batch_size,
                            cfg.data.length_buckets, include_image=True,
                            img_dim=cfg.model.img_feat_dim)
    n = len(exs)
    img = np.zeros((n, cfg.model.shared_dim), np.float32)
    txt = np.zeros((n, cfg.model.shared_dim), np.float32)
    done = np.zeros((n,), bool)
    # under a mesh each data index embeds every n_data-th batch (the
    # ranks of a model group the same ones: the source gather is theirs)
    batches = list(batcher.epoch(0, shuffle=False))
    if mesh is not None:
        batches = host_shard(batches, mesh.data_index, mesh.n_data)
    for batch in batches:
        ie, te = embeddings_for_retrieval(state.params, cfg.model, batch,
                                          device=dev, mesh=mesh)
        real = batch["sample_mask"] > 0
        img[batch["index"][real]] = ie.cpu().numpy()[real]
        txt[batch["index"][real]] = te.cpu().numpy()[real]
        done[batch["index"][real]] = True
    if mesh is not None:
        rows = torch.from_numpy(np.flatnonzero(done))
        img, txt = (mesh.gather_rows(torch.from_numpy(x[done]), rows,
                                     n).numpy() for x in (img, txt))
    if _rank0():
        print(json.dumps(retrieval_recall(img, txt)))


def cmd_translate_text(args) -> None:
    from vag_nmt_tpu_torch.decode.serve import Translator

    dev = resolve_device(args.device)
    tr = Translator.from_run(args.checkpoint, data_dir=args.data_dir or None,
                             tag=args.tag, device=dev)
    if args.input == "-":
        lines = [ln.rstrip("\n") for ln in sys.stdin]
    else:
        with open(args.input, encoding="utf-8") as f:
            lines = [ln.rstrip("\n") for ln in f]
    images = np.load(args.features) if args.features else None
    hyps = tr.translate(lines, images=images, beam_size=args.beam, bulk=True)
    out = open(args.output, "w", encoding="utf-8") if args.output else sys.stdout
    try:
        for h in hyps:
            out.write(h + "\n")
    finally:
        if args.output:
            out.close()


# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="vag_nmt_tpu_torch",
        epilog=f"Not ported yet: {', '.join(NOT_PORTED)} (the JAX package's "
               "command line has it).")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device(p):
        p.add_argument("--device", default=None,
                       help="cuda (default: the card) or cpu; without a "
                            "card the command raises unless --device cpu")

    def common(p, data=True):
        p.add_argument("--preset", default="m30k_ende_vag")
        p.add_argument("--config", default=None,
                       help="config.json path (overrides --preset)")
        p.add_argument("--set", action="append", default=[],
                       metavar="SECTION.KEY=VAL")
        if data:
            p.add_argument("--data-dir", required=True)
        device(p)

    p = sub.add_parser("preprocess", help="tokenize+BPE+vocab artifacts")
    p.add_argument("--raw-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--langs", default="en,de")
    p.add_argument("--splits", default="train,val,test2016,test2017")
    p.add_argument("--bpe-merges", type=int, default=10000)
    p.add_argument("--vocab-min-freq", type=int, default=1)
    p.add_argument("--vocab-max-size", type=int, default=0)
    p.add_argument("--tokenizer", choices=("moses", "simple"),
                   default="moses")
    p.add_argument("--truecase", action="store_true",
                   help="train+apply a truecaser instead of lowercasing")
    p.add_argument("--no-lower", action="store_true",
                   help="keep original casing (no truecaser, no lowercase)")
    p.set_defaults(fn=cmd_preprocess, host=True)

    p = sub.add_parser("train", help="train a preset end to end")
    common(p)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly detection and a finite check of "
                        "each step's loss (slow; debugging only)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("translate", help="decode a split to a file")
    common(p)
    p.add_argument("--checkpoint", required=True, help="train out-dir")
    p.add_argument("--tag", default="best", choices=["best", "last"])
    p.add_argument("--split", default="test2016")
    p.add_argument("--output", required=True)
    p.add_argument("--beam", type=int, default=None)
    p.add_argument("--nbest", type=int, default=0,
                   help="write an n-best list (Moses '<id> ||| <hyp> ||| "
                        "<score>' lines) instead of one line per sentence")
    p.add_argument("--impl", default="auto", choices=["auto", "plain"],
                   help="auto: the CUDA kernels on the card (any beam "
                        "size; above 16 the top-K kernels run in passes); "
                        "plain: their plain PyTorch versions, to check the "
                        "kernels' output")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the decode here")
    p.set_defaults(fn=cmd_translate)

    p = sub.add_parser("score", help="BLEU (+METEOR) a hypothesis file")
    p.add_argument("--hyp", required=True)
    p.add_argument("--ref", required=True)
    p.add_argument("--meteor", action="store_true")
    p.add_argument("--meteor-jar", default="")
    p.add_argument("--lang", default="de")
    device(p)
    p.set_defaults(fn=cmd_score)

    p = sub.add_parser("retrieval", help="image<->text R@K on a split")
    common(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tag", default="best", choices=["best", "last"])
    p.add_argument("--split", default="test2017")
    p.set_defaults(fn=cmd_retrieval)

    p = sub.add_parser("translate-text",
                       help="serving-style: raw text lines -> translations")
    p.add_argument("--checkpoint", required=True, help="train out-dir")
    p.add_argument("--data-dir", default="",
                   help="bpe/vocab artifact dir (default: from saved config)")
    p.add_argument("--tag", default="best", choices=["best", "last"])
    p.add_argument("--input", required=True, help="text file, or - for stdin")
    p.add_argument("--output", default="", help="default: stdout")
    p.add_argument("--features", default="",
                   help="optional (N, 2048) .npy aligned with input lines")
    p.add_argument("--beam", type=int, default=None)
    device(p)
    p.set_defaults(fn=cmd_translate_text, host=True)

    p = sub.add_parser("make-toy", help="materialize the synthetic toy corpus")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--n-train", type=int, default=400)
    p.add_argument("--n-val", type=int, default=50)
    p.add_argument("--n-test", type=int, default=50)
    p.add_argument("--img-dim", type=int, default=64)
    p.set_defaults(fn=cmd_make_toy, host=True)
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    if getattr(args, "host", False) and not _rank0():
        return        # a command without a mesh runs on rank 0 alone
    joined = dist.is_available() and dist.is_initialized()
    try:
        args.fn(args)
    finally:
        if not joined and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()     # the group this command joined


if __name__ == "__main__":
    main()
