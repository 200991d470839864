"""Corpus translation: batched beam decode -> text (counterpart of the
fused path of the JAX package's ``decode/translate.py``).

The corpus is sorted by source length (a chunk's beam loop runs until its
longest hypothesis finishes, so homogeneous-length chunks exit earlier),
padded to one source bucket, encoded in super-chunks of about 1024 rows
(one encoder pass, whose GRU products fill the card far better than a
128-row chunk's), and beam-decoded in chunks of ``decode_batch_size``
rows. Corpus order is restored afterwards and hypotheses are de-BPE'd on
the host."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vag_nmt_tpu_torch.core.config import Config
from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device
from vag_nmt_tpu_torch.data.batching import Example, _bucket_for
from vag_nmt_tpu_torch.data.vocab import Vocab
from vag_nmt_tpu_torch.decode.beam import beam_search
from vag_nmt_tpu_torch.models.decoder import decode_tables
from vag_nmt_tpu_torch.models.model import DecodeState, prepare_decode

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


def _later_slice(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is a later slice of the PyTorch port")


def _check_supported(cfg: Config, beam_size: int, max_len: int, nbest: int,
                     fused: bool, mesh) -> None:
    d = cfg.decode
    if beam_size <= 1:
        raise _later_slice("greedy decode (beam_size <= 1)")
    if nbest:
        raise _later_slice("nbest output")
    if not fused:
        raise _later_slice("the bucketed (fused=False) decode path")
    if mesh is not None:
        raise _later_slice("mesh-sharded decode")
    if d.streaming == "on":
        raise _later_slice("the streaming-refill decoder")
    if d.two_phase == "on" or (d.two_phase == "auto" and max_len >= 96):
        raise _later_slice("the two-phase straggler decoder")
    if d.beam_unroll > 1:
        raise _later_slice("beam_unroll > 1")
    if cfg.model.compute_dtype != "float32":
        raise _later_slice("bf16 decode")


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
) -> Tuple[List[str], Dict]:
    """Returns (hypothesis lines in example-list order, stats).

    impl: kernel selection for the encoder GRU scan and the fused
    readout->top-K ("auto": kernels for CUDA tensors, plain PyTorch for CPU
    tensors; "kernel"; "plain"). use_tables: per-vocab decode tables (None
    = on for CUDA, off for the CPU, whose fixed-seed golden was made
    untabled). device: None = the card. img_table: optional (N, F) feature
    table from build_img_table (row i = examples[i]).

    stats: sentences_per_sec, elapsed_s (host clock from the first upload
    to the last hypothesis on the host, de-BPE excluded), chunk_steps (the
    realized beam-loop trips of each chunk, in length order),
    beam_loop_steps (their sum = decoder steps run), n_chunks,
    rows_per_chunk, t_src."""
    dev = resolve_device(device)
    dd = cfg.decode.compute_dtype
    if dd and dd != cfg.model.compute_dtype:
        cfg = cfg.replace(model=dict(compute_dtype=dd))
    beam_size = beam_size if beam_size is not None else cfg.decode.beam_size
    max_len = max_len if max_len is not None else cfg.decode.max_len
    B = batch_size if batch_size is not None else cfg.decode.decode_batch_size
    _check_supported(cfg, beam_size, max_len, nbest, fused, mesh)
    use_tables = dev.type == "cuda" if use_tables is None else use_tables
    m = cfg.model
    if m.multimodal and img_table is None and any(ex.img is None
                                                  for ex in examples):
        raise ValueError("multimodal decode needs features: either every "
                         "example carries .img or an img_table is passed")
    n = len(examples)
    if not n:
        return [], {"sentences_per_sec": 0.0, "elapsed_s": 0.0,
                    "sentences": 0, "beam_size": beam_size}

    # Super-chunks of ~SUPER_CHUNK_ROWS rows, balanced so padding adds at
    # most S-1 filler chunks.
    nb = -(-n // B)
    s_max = min(max(1, SUPER_CHUNK_ROWS // B), nb)
    ns = -(-nb // s_max)
    S = -(-nb // ns)
    nb = ns * S
    t_src = _bucket_for(max(len(ex.src) for ex in examples),
                        cfg.data.length_buckets)
    order = sorted(range(n), key=lambda i: len(examples[i].src))

    src = np.zeros((nb * B, t_src), np.int64)
    lens = np.zeros((nb * B,), np.int64)
    ids = np.zeros((nb * B,), np.int64)
    for r, i in enumerate(order):
        s = examples[i].src[:t_src]
        src[r, :len(s)] = s
        lens[r] = len(s)
    ids[:n] = order
    if src.size and (src.min() < 0 or src.max() >= m.src_vocab_size):
        # torch raises on (or, on the card, faults at) an index past the
        # embedding table, where the JAX gather clamped it
        raise ValueError(f"source token ids must lie in [0, "
                         f"{m.src_vocab_size})")
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
        elif img_table.shape[0] < n:
            # an index past the table would raise in torch; a short table
            # means the rows do not match examples
            raise ValueError(f"img_table has {img_table.shape[0]} rows for "
                             f"{n} examples (row i must be examples[i]'s)")
        img_table = img_table.to(dev)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tables = decode_tables(params["decoder"]) if use_tables else None
    out_toks = np.zeros((nb * B, max_len), np.int64)
    out_lens = np.zeros((nb * B,), np.int64)
    chunk_steps: List[int] = []
    for sc in range(ns):
        rows = slice(sc * S * B, (sc + 1) * S * B)
        src_d = torch.from_numpy(src[rows]).to(dev)
        lens_d = torch.from_numpy(lens[rows]).to(dev)
        batch = {"src": src_d,
                 "src_mask": (torch.arange(t_src, device=dev)[None, :]
                              < lens_d[:, None]).to(torch.float32)}
        if m.multimodal:
            batch["img"] = img_table[torch.from_numpy(ids[rows]).to(dev)]
        state = prepare_decode(params, m, batch, device=dev, impl=impl)
        row_cap = _row_caps(cfg, max_len, lens_d)
        for c in range(S):
            cr = slice(c * B, (c + 1) * B)
            res = beam_search(
                params, m, DecodeState(*(x[cr] for x in state)),
                beam_size=beam_size, max_len=max_len,
                length_norm_alpha=cfg.decode.length_norm_alpha,
                tables=tables, beam_finish=cfg.decode.beam_finish,
                row_cap=None if row_cap is None else row_cap[cr],
                prune=cfg.decode.beam_prune != "off",
                block_ngram=cfg.decode.block_ngram, impl=impl, device=dev)
            g = slice(sc * S * B + c * B, sc * S * B + (c + 1) * B)
            out_toks[g] = res.best_tokens.cpu().numpy()
            out_lens[g] = res.best_lengths.cpu().numpy()
            chunk_steps.append(res.steps)
    elapsed = time.perf_counter() - t0

    lines = _detok_rows(out_toks[:n], out_lens[:n], tgt_vocab, de_bpe)
    hyps: List[str] = [""] * n
    for r, i in enumerate(order):
        hyps[i] = lines[r]
    stats = {"sentences_per_sec": n / max(elapsed, 1e-9),
             "elapsed_s": elapsed, "sentences": n, "beam_size": beam_size,
             "beam_loop_steps": int(sum(chunk_steps)),
             "chunk_steps": chunk_steps, "n_chunks": nb,
             "rows_per_chunk": B, "t_src": int(t_src),
             "device": str(dev), "impl": impl, "tables": bool(use_tables)}
    return hyps, stats
