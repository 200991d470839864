"""Greedy decoding (counterpart of the JAX package's ``decode/greedy.py``):
the K=1 decoder step and an argmax per row, finished rows emitting <pad>,
until every row has emitted <eos> or max_len steps have run (the JAX
``while_loop``: on the card a CUDA graph of one step replayed until its
exit flag is set, one device read a replay; on the CPU, or with
``dispatch="eager"``, a host loop; ``decode/graphs.py``)."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from vag_nmt_tpu_torch.core.config import EOS_ID, ModelConfig, PAD_ID, SOS_ID
from vag_nmt_tpu_torch.decode.beam import _device_t, _resolve_block, ngram_ban
from vag_nmt_tpu_torch.decode.graphs import Dispatch, loop_graphs, run_loop
from vag_nmt_tpu_torch.models.model import (DecodeOpts, DecodeState,
                                             decode_opts, decode_step)
from vag_nmt_tpu_torch.ops.readout_topk import ban_mask
from vag_nmt_tpu_torch.parallel.tensor import vocab_parallel_argmax, vocab_shard


class GreedyResult(NamedTuple):
    tokens: torch.Tensor     # (B, max_len) <pad>-padded
    lengths: torch.Tensor    # (B,) incl. <eos> when produced
    steps: int               # realized loop trips (decoder steps run)


def _make_greedy_body(params, cfg: ModelConfig, state: DecodeState, tables,
                      row_cap: Optional[torch.Tensor], block_ngram: int,
                      opts: DecodeOpts):
    """The greedy step over the carry (t (0-dim, on the device), tok (B,),
    s (B, 1, H), tokens (B, L), finished (B,), lengths (B,)): rows past
    their cap freeze first, then one K=1 step and the argmax; the token
    lands at t by a one-hot mask. No host copy, no device read."""
    V = cfg.tgt_vocab_size
    vocab = vocab_shard(opts.tp, V)

    def body(carry):
        t, tok, s, tokens, finished, lengths = carry
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
        hit = torch.arange(tokens.shape[1], device=tokens.device) == t
        tokens = torch.where(hit, nxt[:, None], tokens)
        lengths = torch.where(finished, lengths, lengths + 1)
        return (t + 1, nxt, s, tokens, finished | (nxt == EOS_ID), lengths)

    return body


def greedy_decode(
    params: Dict[str, Any],
    cfg: ModelConfig,
    state: DecodeState,
    max_len: int,
    tables=None,
    row_cap: Optional[torch.Tensor] = None,
    block_ngram: int = 0,
    opts: Optional[DecodeOpts] = None,
    dispatch: Dispatch = None,
) -> GreedyResult:
    """tables: optional per-vocab decode tables (models.decoder
    .decode_tables). row_cap: optional (B,) per-row step cap. block_ngram:
    no-repeat n-gram blocking order (n <= 1 disables), the beam paths'
    semantics at K=1: a token that would complete an n-gram already in the
    row's hypothesis gets -inf before the argmax. Ties go to the first
    index, as ``jnp.argmax``. opts: the decode's step choices
    (``models.model.DecodeOpts``; None: read once here); under tensor
    parallelism (``opts.tp``) each rank holds its vocab slice's logits
    and the argmax is ``vocab_parallel_argmax``'s. dispatch: as
    ``beam_search``'s (the loop a replayed CUDA graph of one step, or a
    host loop)."""
    B = state.s0.shape[0]
    dev = state.s0.device
    block_ngram = _resolve_block(block_ngram)
    if opts is None:
        opts = decode_opts(state.ctx.dtype)
    graphs = loop_graphs(dispatch, dev, opts.tp)
    carry = (_device_t(0, dev),
             torch.full((B,), SOS_ID, dtype=torch.long, device=dev),
             state.s0[:, None, :],
             torch.full((B, max_len), PAD_ID, dtype=torch.long, device=dev),
             torch.zeros((B,), dtype=torch.bool, device=dev),
             torch.zeros((B,), dtype=torch.long, device=dev))

    def make_body(st, rc):
        return _make_greedy_body(params, cfg, st, tables, rc, block_ngram,
                                 opts)

    out, t = run_loop(make_body, state, row_cap, carry, 0, max_len, fin=4,
                      graphs=graphs,
                      key=("greedy", block_ngram, id(params), id(tables), opts))
    return GreedyResult(tokens=out[3], lengths=out[5], steps=t)
