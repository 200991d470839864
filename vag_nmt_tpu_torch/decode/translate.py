"""Corpus translation: batched beam or greedy decode -> text (counterpart
of the JAX package's ``decode/translate.py``).

The fused path (the default): the corpus is sorted by source length (a
chunk's beam loop runs until its longest hypothesis finishes, so
homogeneous-length chunks exit earlier), padded to one source bucket,
encoded in super-chunks of about 1024 rows (one encoder pass, whose GRU
products fill the card far better than a 128-row chunk's;
``VAG_SUPER_CHUNK`` sets the rows), and decoded in chunks of
``decode_batch_size`` rows (beam search, or greedy at beam_size 1), or,
per super-chunk, by the streaming-refill decoder (one pool whose working
set of ``decode_batch_size`` rows refills as sentences finish) or the
two-phase straggler decoder (chunks capped at a split length, then
re-packed stragglers on a doubling ladder). Corpus order is restored
afterwards and hypotheses are de-BPE'd on the host.

The bucketed path (``fused=False``): ``BucketBatcher`` batches in example
order, each batch one encode and one beam (or greedy) decode at its own
source bucket.

Under ``decode.compute_dtype="bfloat16"`` (or a model trained in bf16 with
no decode override) the params are cast to bf16 once per call
(``cast_floats``), as the JAX package casts them once per decode
program."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vag_nmt_tpu_torch.core.config import Config
from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device
from vag_nmt_tpu_torch.core.knobs import decode_knobs, over
from vag_nmt_tpu_torch.data.batching import BucketBatcher, Example, _bucket_for
from vag_nmt_tpu_torch.data.vocab import Vocab
from vag_nmt_tpu_torch.decode.beam import (
    beam_search,
    beam_search_streaming,
    beam_search_two_phase,
)
from vag_nmt_tpu_torch.decode.graphs import (Dispatch, dispatch_stats,
                                             loop_graphs)
from vag_nmt_tpu_torch.decode.greedy import greedy_decode
from vag_nmt_tpu_torch.models.decoder import decode_tables
from vag_nmt_tpu_torch.models.layers import compute_dtype
from vag_nmt_tpu_torch.models.model import (DecodeState, cast_floats,
                                            decode_opts, decode_params,
                                            prepare_decode)
from vag_nmt_tpu_torch.parallel.sharding import rows_of_chunks, tp_mesh
from vag_nmt_tpu_torch.parallel.tensor import vocab_shard

SUPER_CHUNK_ROWS = 1024


def build_img_table(examples: Sequence[Example], img_dim: int, *,
                    device: DeviceLike = None) -> torch.Tensor:
    """(N, F) image-feature table in example order (row i = examples[i]),
    on ``device``. Build once and pass to translate_corpus(img_table=...)
    when decoding the same corpus repeatedly."""
    dev = resolve_device(device)
    tbl = np.zeros((len(examples), img_dim), np.float32)
    for i, ex in enumerate(examples):
        tbl[i] = ex.img
    return torch.from_numpy(tbl).to(dev)


def _row_caps(cfg: Config, max_len: int,
              lens: torch.Tensor) -> Optional[torch.Tensor]:
    """Per-row source-relative decode caps (DecodeConfig.max_len_factor):
    ceil(factor * src_len) + offset clamped to [1, max_len]; None when the
    feature is off (factor == 0, the default)."""
    d = cfg.decode
    if d.max_len_factor <= 0.0:
        return None
    cap = torch.ceil(d.max_len_factor * lens.to(torch.float32)).to(
        torch.long) + d.max_len_offset
    return cap.clamp(1, max_len)


def _use_streaming(cfg: Config, beam_size: int) -> bool:
    """The streaming-refill decoder: beam only; VAG_STREAM_DECODE over
    cfg.decode.streaming ("on" streams; "auto" and "off" do not)."""
    if beam_size <= 1:
        return False
    env = decode_knobs().streaming
    return env if env is not None else cfg.decode.streaming == "on"


def _use_two_phase(cfg: Config, beam_size: int, max_len: int) -> bool:
    """The two-phase straggler decoder: beam only; VAG_TWO_PHASE over
    cfg.decode.two_phase ("on", "off", "auto": on iff max_len >= 96, the
    long-caption regime)."""
    if beam_size <= 1:
        return False
    env = decode_knobs().two_phase
    if env is not None:
        return env
    mode = cfg.decode.two_phase
    if mode in ("on", "off"):
        return mode == "on"
    return max_len >= 96


def decode_config(cfg: Config) -> Config:
    """cfg with the model's compute dtype replaced by
    ``decode.compute_dtype`` where that is set: the dtype a decode runs at
    (the params cast to it once, ``cast_floats``)."""
    dd = cfg.decode.compute_dtype
    if dd and dd != cfg.model.compute_dtype:
        return cfg.replace(model=dict(compute_dtype=dd))
    return cfg


def _check_inputs(examples: Sequence[Example], t_src: int, m,
                  img_table: Optional[torch.Tensor]) -> None:
    """The input checks of both paths: every source id a decode reads (the
    first t_src of each example) lies in the embedding table, and an
    img_table has a row for every example."""
    lo = min((min(ex.src[:t_src], default=0) for ex in examples), default=0)
    hi = max((max(ex.src[:t_src], default=0) for ex in examples), default=0)
    if lo < 0 or hi >= m.src_vocab_size:
        # torch raises on (or, on the card, faults at) an index past the
        # embedding table, where the JAX gather clamped it
        raise ValueError(f"source token ids must lie in [0, "
                         f"{m.src_vocab_size})")
    if m.multimodal and img_table is not None and \
            img_table.shape[0] < len(examples):
        # an index past the table would raise in torch; a short table
        # means the rows do not match examples
        raise ValueError(f"img_table has {img_table.shape[0]} rows for "
                         f"{len(examples)} examples (row i must be "
                         f"examples[i]'s)")


def _check_supported(nbest: int, beam_size: int, fused: bool, mesh) -> None:
    if nbest:
        if beam_size <= 1:
            raise ValueError("nbest output requires beam_size > 1")
        if not fused:
            raise ValueError("nbest output requires the fused decode path")
    if mesh is not None and not fused:
        raise ValueError("mesh-sharded decode requires the fused path")


def super_chunks(nb: int, B: int) -> Tuple[int, int]:
    """(ns, S): ns encoder passes of S decode chunks each for nb chunks of
    B rows, S at most VAG_SUPER_CHUNK's rows (default SUPER_CHUNK_ROWS)
    over B and at least 1, balanced (ns = ceil(nb / S_max), S = ceil(nb /
    ns)) so padding adds at most S - 1 filler chunks."""
    rows = over(decode_knobs().super_chunk, SUPER_CHUNK_ROWS)
    s_max = min(max(1, rows // B), nb)
    ns = -(-nb // s_max)
    return ns, -(-nb // ns)


def _detok_rows(toks2d: np.ndarray, lens1d: np.ndarray, tgt_vocab: Vocab,
                de_bpe: bool) -> List[str]:
    """(R, L) ids, (R,) lengths -> R strings; drops <pad>/<sos>/<eos> and
    keeps <unk>, as Vocab.decode does; de-BPE joins '@@'-continued units."""
    itos = np.asarray(tgt_vocab.itos, dtype=object)
    special = np.zeros(len(itos), bool)
    special[[0, 2, 3]] = True
    R, L = toks2d.shape
    t = toks2d.astype(np.int64, copy=False)
    keep = (np.arange(L)[None, :] < lens1d[:, None]) & ~special[t]
    words = itos[t[keep]].tolist()
    offs = np.concatenate([[0], np.cumsum(keep.sum(axis=1))]).tolist()
    lines = [" ".join(words[a:b]) for a, b in zip(offs, offs[1:])]
    if de_bpe:
        # vocab units never contain whitespace, so "\n" separates rows and
        # the "@@ " / "@@\n" rewrites are exactly per-line remove_bpe
        giant = "\n".join(lines)
        giant = giant.replace("@@ ", "").replace("@@\n", "\n")
        if giant.endswith("@@"):
            giant = giant[:-2]
        lines = giant.split("\n")
    return lines


def translate_corpus(
    params,
    cfg: Config,
    examples: Sequence[Example],
    tgt_vocab: Vocab,
    *,
    beam_size: Optional[int] = None,
    max_len: Optional[int] = None,
    batch_size: Optional[int] = None,
    de_bpe: bool = True,
    fused: bool = True,
    img_table: Optional[torch.Tensor] = None,
    mesh=None,
    nbest: int = 0,
    impl: str = "auto",
    use_tables: Optional[bool] = None,
    device: DeviceLike = None,
    dispatch: Dispatch = None,
) -> Tuple[List, Dict]:
    """Returns (hypothesis lines in example-list order, stats); with
    ``nbest`` = N > 0 (beam search on the fused path only, else
    ValueError) each example's up to min(N, beam_size) (text, score)
    pairs instead, best first, with the length-normalized beam scores.

    fused=False takes the bucketed path (``BucketBatcher`` in example
    order, one encode and one beam search, or greedy at beam 1, a batch;
    with it nbest raises ValueError).

    mesh: a data-parallel mesh (``parallel.make_mesh``), the same call on
    every rank (fused path only, else ValueError). B is rounded up to a
    multiple of the data axis; super-chunks are planned globally and each
    rank decodes its contiguous B / n_data rows of every chunk (streaming
    and two-phase: one pool, or one ladder, of its own rows a
    super-chunk). The hypotheses are gathered in example order and
    returned on every rank, equal to one process's: each row's decode is
    its own. The trip stats are the max over the ranks of each chunk's
    (``beam_loop_steps`` their sum), reruns their sum. A mesh with a
    model axis (tensor parallelism) takes params holding this rank's
    vocab slices: the ranks of a model group decode the same rows, each
    beam step's readout merged over the group (``fused_readout_topk
    (vocab=)``), and the gathers and trip maxima run over the data axis.
    There streaming and two-phase are off, as the JAX package turns them
    off on such a mesh (``_mesh_repack_ok``): the chunked loop runs, the
    stats say ``streaming: False`` and ``two_phase: False``, and a call
    that asked for either says so on stderr.

    beam_size 1 decodes greedily; beam search otherwise: pooled per
    super-chunk when the streaming-refill decoder is on (VAG_STREAM_DECODE
    over cfg.decode.streaming), else by the two-phase decoder per
    super-chunk when it is on (VAG_TWO_PHASE over cfg.decode.two_phase,
    "auto" on for max_len >= 96; split length cfg.decode.split_len, 0:
    max(16, max_len // 4)), else chunked, with cfg.decode.beam_unroll
    (VAG_BEAM_UNROLL over it). VAG_BEAM_PRUNE and VAG_BLOCK_NGRAM override
    cfg.decode.beam_prune and block_ngram, greedy included. impl: kernel
    selection for the encoder GRU scan and the beam step ("auto": kernels
    for CUDA tensors, plain PyTorch for CPU tensors; "kernel"; "plain"; the
    step's structure and its optional kernels follow core/knobs.py).
    use_tables: per-vocab decode tables (None = VAG_TOKEN_TABLES, else on
    for CUDA and off for the CPU, whose fixed-seed golden was made
    untabled). device: None = the card. img_table: optional (N, F) feature
    table from build_img_table (row i = examples[i]).

    dispatch: how the decode loops run: "graph" (each loop's U steps a
    CUDA graph, captured once a call per loop shape and replayed, one
    device read a replay; a streaming pool's trip and refill two graphs,
    the refill replayed only on the trips that flag it, one read a trip;
    ``decode/graphs.py``), "eager" (host loops), or None: "graph" on a
    CUDA device with no mesh of several ranks, else "eager"
    (``resolve_dispatch``); "graph" on the CPU or such a mesh raises
    ValueError. One ``LoopGraphs`` serves the call: every super-chunk's
    pool or chunk of one shape is loaded into the same loop. A capture
    that fails raises: nothing falls back to eager.

    stats: sentences_per_sec, elapsed_s (host clock from the first upload
    to the last hypothesis on the host, de-BPE excluded), chunk_steps (the
    realized decode-loop trips of each chunk in length order; streaming:
    of each super-chunk's pool; two-phase: each chunk's phase-1 trips),
    beam_loop_steps (their sum, plus the phase-2 trips = decoder steps
    run), n_chunks, rows_per_chunk, t_src, reruns (chunks rerun at the
    readout's depth K in the deferred mode); streaming adds
    ``streaming=True`` and ``refills`` (refill events per super-chunk);
    two-phase adds ``two_phase=True`` and ``phase2_steps`` (resume trips
    per super-chunk); every path adds ``dispatch`` ("graph" or "eager"),
    ``captures`` (graphs captured), ``replays`` (graph replays) and
    ``capture_s`` (their warm-ups' and captures' host seconds, inside
    elapsed_s)."""
    dev = resolve_device(device)
    cfg = decode_config(cfg)
    beam_size = beam_size if beam_size is not None else cfg.decode.beam_size
    max_len = max_len if max_len is not None else cfg.decode.max_len
    B = batch_size if batch_size is not None else cfg.decode.decode_batch_size
    _check_supported(nbest, beam_size, fused, mesh)
    n_data = 1 if mesh is None else mesh.n_data
    tp = tp_mesh(mesh)
    if B % n_data:
        # equal rows on every rank; filler rows replicate real ones
        B += n_data - B % n_data
    dtype = compute_dtype(cfg.model)
    if dtype != torch.float32:
        params = cast_floats(params, dtype)     # once per call
    opts = decode_opts(dtype, mesh)             # the step choices, once
    if use_tables is None:
        use_tables = decode_knobs().tables
    if use_tables is None:
        use_tables = dev.type == "cuda"
    m = cfg.model
    params = decode_params(params, m, opts, beam=beam_size > 1,
                           tables=use_tables)
    if m.multimodal and img_table is None and any(ex.img is None
                                                  for ex in examples):
        raise ValueError("multimodal decode needs features: either every "
                         "example carries .img or an img_table is passed")
    n = len(examples)
    if not n:
        return [], {"sentences_per_sec": 0.0, "elapsed_s": 0.0,
                    "sentences": 0, "beam_size": beam_size}
    t_src = _bucket_for(max(len(ex.src) for ex in examples),
                        cfg.data.length_buckets)
    _check_inputs(examples, t_src, m, img_table)
    if not fused:
        return _translate_bucketed(params, cfg, examples, tgt_vocab,
                                   beam_size, max_len, B, de_bpe, img_table,
                                   impl, use_tables, opts, dev,
                                   loop_graphs(dispatch, dev))
    streaming = _use_streaming(cfg, beam_size)
    two_phase = not streaming and _use_two_phase(cfg, beam_size, max_len)
    if tp is not None and (streaming or two_phase):
        if mesh.is_main:
            print(f"[tensor parallel] {'streaming' if streaming else 'two-phase'}"
                  " decode is off on a mesh with a model axis: the chunked "
                  "loop runs", file=sys.stderr)
        streaming = two_phase = False
    # the call's loop graphs (None: eager), freed with the call
    graphs = loop_graphs(dispatch, dev, mesh)
    loops = "eager" if graphs is None else graphs

    ns, S = super_chunks(-(-n // B), B)
    nb = ns * S
    order = sorted(range(n), key=lambda i: len(examples[i].src))

    src = np.zeros((nb * B, t_src), np.int64)
    lens = np.zeros((nb * B,), np.int64)
    ids = np.zeros((nb * B,), np.int64)
    for r, i in enumerate(order):
        s = examples[i].src[:t_src]
        src[r, :len(s)] = s
        lens[r] = len(s)
    ids[:n] = order
    if n < nb * B:
        # Filler rows replicate a real row (source and features): an empty
        # source may never emit <eos> and would hold its chunk to max_len.
        # Rows padding the last real chunk copy its last row; rows of whole
        # filler chunks copy row 0, the shortest sentence.
        first_filler_chunk_row = (-(-n // B)) * B
        for a, b, r in ((n, first_filler_chunk_row, n - 1),
                        (first_filler_chunk_row, nb * B, 0)):
            src[a:b], lens[a:b], ids[a:b] = src[r], lens[r], ids[r]
    if m.multimodal:
        if img_table is None:
            img_table = build_img_table(examples, m.img_feat_dim, device=dev)
        img_table = img_table.to(dev)

    mine = None
    if n_data > 1:
        # this rank's rows of every chunk; it decodes chunks of Bd rows
        mine = rows_of_chunks(nb, B, mesh)
        src, lens, ids = src[mine], lens[mine], ids[mine]
    Bd = B // n_data

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tables = (decode_tables(params["decoder"], w_out_bf16=opts.readout_bf16,
                            vocab=vocab_shard(tp, m.tgt_vocab_size))
              if use_tables else None)
    # per row: the best hypothesis, or with nbest the top nb_k beams and
    # their scores (the beam loops rank beams best first)
    nb_k = min(nbest, beam_size) if nbest else 0
    rk = (nb_k,) if nbest else ()
    out_toks = np.zeros((nb * Bd, *rk, max_len), np.int64)
    out_lens = np.zeros((nb * Bd, *rk), np.int64)
    out_scores = np.zeros((nb * Bd, nb_k), np.float32)

    def keep(rows, res):
        """The rows' results of one decode (a BeamResult) into the outputs."""
        if nbest:
            out_toks[rows] = res.tokens[:, :nb_k].cpu().numpy()
            out_lens[rows] = res.lengths[:, :nb_k].cpu().numpy()
            out_scores[rows] = res.scores[:, :nb_k].cpu().numpy()
        else:
            out_toks[rows] = res.best_tokens.cpu().numpy()
            out_lens[rows] = res.best_lengths.cpu().numpy()

    chunk_steps: List[int] = []
    refills: List[int] = []
    phase2: List[int] = []
    reruns = 0
    d = cfg.decode
    block_ngram, unroll, beam_kw = _beam_args(cfg, beam_size, max_len,
                                              tables, impl, opts, dev)
    for sc in range(ns):
        rows = slice(sc * S * Bd, (sc + 1) * S * Bd)
        src_d = torch.from_numpy(src[rows]).to(dev)
        lens_d = torch.from_numpy(lens[rows]).to(dev)
        batch = {"src": src_d,
                 "src_mask": (torch.arange(t_src, device=dev)[None, :]
                              < lens_d[:, None]).to(torch.float32)}
        if m.multimodal:
            batch["img"] = img_table[torch.from_numpy(ids[rows]).to(dev)]
        state = prepare_decode(params, m, batch, device=dev, impl=impl,
                               mesh=mesh)
        row_cap = _row_caps(cfg, max_len, lens_d)
        if streaming:
            res, steps, n_refill = beam_search_streaming(
                params, m, state, slots=Bd, refill_threshold=d.refill_threshold,
                row_cap=row_cap, dispatch=loops, **beam_kw)
            keep(rows, res)
            chunk_steps.append(steps)
            refills.append(n_refill)
            continue
        if two_phase:
            res, steps1, steps2 = beam_search_two_phase(
                params, m, state, chunk=Bd,
                split_len=d.split_len or max(16, max_len // 4),
                row_cap=row_cap, dispatch=loops, **beam_kw)
            keep(rows, res)
            chunk_steps.extend(steps1)
            phase2.append(steps2)
            continue
        for c in range(S):
            cr = slice(c * Bd, (c + 1) * Bd)
            chunk = DecodeState(*(x[cr] for x in state))
            cap = None if row_cap is None else row_cap[cr]
            g = slice(sc * S * Bd + c * Bd, sc * S * Bd + (c + 1) * Bd)
            if beam_size <= 1:
                res = greedy_decode(params, m, chunk, max_len, tables=tables,
                                    row_cap=cap, block_ngram=block_ngram,
                                    opts=opts, dispatch=loops)
                out_toks[g] = res.tokens.cpu().numpy()
                out_lens[g] = res.lengths.cpu().numpy()
            else:
                res = beam_search(params, m, chunk, row_cap=cap,
                                  unroll=unroll, dispatch=loops, **beam_kw)
                keep(g, res)
                reruns += res.reruns
            chunk_steps.append(res.steps)
    if mine is not None:
        out_toks, out_lens, out_scores = (
            mesh.gather_rows(torch.from_numpy(x), mine, nb * B).numpy()
            for x in (out_toks, out_lens, out_scores))
        chunk_steps, refills, phase2 = (
            mesh.all_reduce(torch.tensor(x, dtype=torch.int64), "max").tolist()
            if x else x for x in (chunk_steps, refills, phase2))
        reruns = int(mesh.all_reduce(torch.tensor(reruns)))
    elapsed = time.perf_counter() - t0

    if nbest:
        # only the rows asked for are detokenized
        lines = _detok_rows(out_toks[:n].reshape(n * nb_k, max_len),
                            out_lens[:n].reshape(n * nb_k), tgt_vocab, de_bpe)
        hyps: List = [[] for _ in range(n)]
        for r, i in enumerate(order):
            hyps[i] = [(lines[r * nb_k + k], float(out_scores[r, k]))
                       for k in range(nb_k)]
    else:
        lines = _detok_rows(out_toks[:n], out_lens[:n], tgt_vocab, de_bpe)
        hyps = [""] * n
        for r, i in enumerate(order):
            hyps[i] = lines[r]
    stats = {"sentences_per_sec": n / max(elapsed, 1e-9),
             "elapsed_s": elapsed, "sentences": n, "beam_size": beam_size,
             "beam_loop_steps": int(sum(chunk_steps) + sum(phase2)),
             "chunk_steps": chunk_steps, "n_chunks": nb,
             "rows_per_chunk": B, "t_src": int(t_src), "reruns": reruns,
             "device": str(dev), "impl": impl, "tables": bool(use_tables),
             **dispatch_stats(graphs)}
    if tp is not None:
        stats["streaming"] = stats["two_phase"] = False
    if streaming:
        stats["streaming"] = True
        stats["refills"] = refills
    if two_phase:
        stats["two_phase"] = True
        stats["phase2_steps"] = phase2
    return hyps, stats


def _beam_args(cfg: Config, beam_size: int, max_len: int, tables, impl: str,
               opts, dev: torch.device):
    """(block_ngram, unroll, beam_kw): the selection variables over
    cfg.decode, as every decode loop of a call takes them."""
    d = cfg.decode
    kn = decode_knobs()
    block_ngram = over(kn.block_ngram, d.block_ngram)
    beam_kw = dict(beam_size=beam_size, max_len=max_len,
                   length_norm_alpha=d.length_norm_alpha, tables=tables,
                   beam_finish=d.beam_finish,
                   prune=over(kn.beam_prune, d.beam_prune != "off"),
                   block_ngram=block_ngram, impl=impl, device=dev,
                   opts=opts)
    return block_ngram, over(kn.beam_unroll, d.beam_unroll), beam_kw


def _translate_bucketed(params, cfg: Config, examples: Sequence[Example],
                        tgt_vocab: Vocab, beam_size: int, max_len: int,
                        B: int, de_bpe: bool,
                        img_table: Optional[torch.Tensor], impl: str,
                        use_tables: bool, opts, dev: torch.device,
                        graphs) -> Tuple[List[str], Dict]:
    """The bucketed path (the JAX package's fused=False): BucketBatcher's
    batches in example order, each padded to its own source bucket and
    decoded by one encode and one beam search (greedy at beam 1), with
    the fused path's tables, row caps, n-gram blocking and prune, its
    loops on ``graphs`` (the call's LoopGraphs, one loop a batch shape;
    None: eager). Hypotheses come back in list order, whatever the
    examples' .index."""
    m = cfg.model
    if m.multimodal:
        img_table = (build_img_table(examples, m.img_feat_dim, device=dev)
                     if img_table is None else img_table.to(dev))
    # rows keyed by list position, so output order and table rows agree
    positioned = [dataclasses.replace(ex, index=i)
                  for i, ex in enumerate(examples)]
    batcher = BucketBatcher(positioned, B, cfg.data.length_buckets,
                            image_ids=m.multimodal, img_dim=m.img_feat_dim)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tables = (decode_tables(params["decoder"], w_out_bf16=opts.readout_bf16)
              if use_tables else None)
    loops = "eager" if graphs is None else graphs
    block_ngram, unroll, beam_kw = _beam_args(cfg, beam_size, max_len,
                                              tables, impl, opts, dev)
    pending, chunk_steps = [], []
    for batch in batcher.epoch(0, shuffle=False):
        src_d = torch.from_numpy(batch["src"]).to(dev)
        mask_d = torch.from_numpy(batch["src_mask"]).to(dev)
        b = {"src": src_d, "src_mask": mask_d}
        if m.multimodal:
            b["img"] = img_table[torch.from_numpy(batch["img_ids"]).to(
                dev).long()]
        state = prepare_decode(params, m, b, device=dev, impl=impl)
        row_cap = _row_caps(cfg, max_len, mask_d.sum(-1).long())
        if beam_size <= 1:
            res = greedy_decode(params, m, state, max_len, tables=tables,
                                row_cap=row_cap, block_ngram=block_ngram,
                                opts=opts, dispatch=loops)
            toks, lens = res.tokens, res.lengths
        else:
            res = beam_search(params, m, state, row_cap=row_cap,
                              unroll=unroll, dispatch=loops, **beam_kw)
            toks, lens = res.best_tokens, res.best_lengths
        chunk_steps.append(res.steps)
        pending.append((toks, lens, batch["index"], batch["sample_mask"]))
    n = len(examples)
    hyps: List[Optional[str]] = [None] * n
    for toks, lens, index, smask in pending:
        keep = smask != 0
        lines = _detok_rows(toks.cpu().numpy()[keep], lens.cpu().numpy()[keep],
                            tgt_vocab, de_bpe)
        for i, line in zip(index[keep].tolist(), lines):
            hyps[i] = line
    elapsed = time.perf_counter() - t0
    n_done = sum(h is not None for h in hyps)
    assert n_done == n, f"decoded {n_done} of {n} sentences"
    return hyps, {"sentences_per_sec": n / max(elapsed, 1e-9),
                  "elapsed_s": elapsed, "sentences": n,
                  "beam_size": beam_size, "bucketed": True,
                  "beam_loop_steps": int(sum(chunk_steps)),
                  "chunk_steps": chunk_steps, "n_chunks": len(chunk_steps),
                  "rows_per_chunk": B, "device": str(dev), "impl": impl,
                  "tables": bool(use_tables), **dispatch_stats(graphs)}
