"""Greedy decoding (counterpart of the JAX package's ``decode/greedy.py``):
the K=1 decoder step and an argmax per row, finished rows emitting <pad>,
until every row has emitted <eos> or max_len steps have run (the JAX
``while_loop`` is a Python loop here; its condition reads one bool from
the device per step)."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from vag_nmt_tpu_torch.core.config import EOS_ID, ModelConfig, PAD_ID, SOS_ID
from vag_nmt_tpu_torch.decode.beam import _resolve_block, ngram_ban
from vag_nmt_tpu_torch.models.model import (DecodeOpts, DecodeState,
                                             decode_opts, decode_step)
from vag_nmt_tpu_torch.ops.readout_topk import ban_mask
from vag_nmt_tpu_torch.parallel.tensor import vocab_parallel_argmax, vocab_shard


class GreedyResult(NamedTuple):
    tokens: torch.Tensor     # (B, max_len) <pad>-padded
    lengths: torch.Tensor    # (B,) incl. <eos> when produced
    steps: int               # realized loop trips (decoder steps run)


def greedy_decode(
    params: Dict[str, Any],
    cfg: ModelConfig,
    state: DecodeState,
    max_len: int,
    tables=None,
    row_cap: Optional[torch.Tensor] = None,
    block_ngram: int = 0,
    opts: Optional[DecodeOpts] = None,
) -> GreedyResult:
    """tables: optional per-vocab decode tables (models.decoder
    .decode_tables). row_cap: optional (B,) per-row step cap. block_ngram:
    no-repeat n-gram blocking order (n <= 1 disables), the beam paths'
    semantics at K=1: a token that would complete an n-gram already in the
    row's hypothesis gets -inf before the argmax. Ties go to the first
    index, as ``jnp.argmax``. opts: the decode's step choices
    (``models.model.DecodeOpts``; None: read once here); under tensor
    parallelism (``opts.tp``) each rank holds its vocab slice's logits
    and the argmax is ``vocab_parallel_argmax``'s."""
    B = state.s0.shape[0]
    V = cfg.tgt_vocab_size
    dev = state.s0.device
    block_ngram = _resolve_block(block_ngram)
    if opts is None:
        opts = decode_opts(state.ctx.dtype)
    vocab = vocab_shard(opts.tp, V)
    t = 0
    tok = torch.full((B,), SOS_ID, dtype=torch.long, device=dev)
    s = state.s0[:, None, :]
    tokens = torch.full((B, max_len), PAD_ID, dtype=torch.long, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B,), dtype=torch.long, device=dev)
    while t < max_len and not bool(finished.all()):
        if row_cap is not None:
            finished = finished | (t >= row_cap)
        s, logits = decode_step(params, cfg, tok[:, None], s, state, tables,
                                opts)
        lg = logits[:, 0]
        if block_ngram > 0:
            ban = ngram_ban(tokens[:, None, :], t, block_ngram, V)[:, 0]
            mask = ban_mask(ban, V).bool()
            if vocab is not None:
                mask = mask[:, vocab.v0:vocab.v1]
            lg = torch.where(mask, torch.full_like(lg, float("-inf")), lg)
        nxt = (torch.argmax(lg, dim=-1) if vocab is None
               else vocab_parallel_argmax(lg, vocab))
        nxt = torch.where(finished, torch.full_like(nxt, PAD_ID), nxt)
        tokens[:, t] = nxt
        lengths = torch.where(finished, lengths, lengths + 1)
        finished = finished | (nxt == EOS_ID)
        tok = nxt
        t += 1
    return GreedyResult(tokens=tokens, lengths=lengths, steps=t)
