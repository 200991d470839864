"""Batched beam search (counterpart of the JAX package's ``decode/beam.py``,
single-loop decoder at unroll 1).

- encode once; the beams of a sentence share the encoder context;
- each step: one decoder step over all rows, fused candidate scoring and
  top-K over the (beam * vocab) grid, gathers of state and history by beam;
- finished hypotheses emit <pad> at log-prob 0, so they ride along frozen
  and keep competing in the top-K at their final score;
- the loop exits when every hypothesis of the batch is finished (the JAX
  ``while_loop`` is a Python loop here; its condition reads one bool from
  the device per step);
- the final ranking divides by length ** alpha.

The two-phase and streaming decoders and greedy decode are later slices."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from vag_nmt_tpu_torch.core.config import EOS_ID, ModelConfig, PAD_ID, SOS_ID
from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device, same_device
from vag_nmt_tpu_torch.models.model import DecodeState, decode_step_topk

NEG_INF = -1e9


class BeamResult(NamedTuple):
    tokens: torch.Tensor        # (B, K, L) <pad>-padded, best beam first
    lengths: torch.Tensor       # (B, K) incl. <eos> when produced
    scores: torch.Tensor        # (B, K) fp32 length-normalized, descending
    best_tokens: torch.Tensor   # (B, L)
    best_lengths: torch.Tensor  # (B,)
    steps: int                  # realized loop trips (decoder steps run)


def ngram_ban(tokens: torch.Tensor, t: int, n: int, V: int) -> torch.Tensor:
    """Per-step no-repeat n-gram ban list (fairseq semantics).

    tokens: (B, K, L) token buffer; t: current decode position; n: n-gram
    order (> 1); V: vocab size, the "no ban" sentinel. Returns (B, K, L)
    banned ids: each entry is the token that would complete an n-gram
    already present in that beam's own hypothesis, or V."""
    nm1 = n - 1
    B, K, L = tokens.shape
    # -1 tail padding never equals a real id, so windows past L never match.
    padded = torch.cat([tokens, torch.full((B, K, nm1), -1, dtype=tokens.dtype,
                                           device=tokens.device)], dim=-1)
    match = torch.ones((B, K, L), dtype=torch.bool, device=tokens.device)
    for j in range(nm1):
        # suffix token at absolute position t - (n-1) + j
        idx = min(max(t + j - nm1, 0), L - 1)
        match &= padded[:, :, j:j + L] == tokens[:, :, idx:idx + 1]
    # window [i, i+n-1] must lie fully in the decoded past
    valid = torch.arange(L, device=tokens.device) <= t - n
    return torch.where(match & valid, padded[:, :, nm1:nm1 + L],
                       torch.full_like(tokens, V))


def _make_body_1(params, cfg: ModelConfig, state: DecodeState, tables,
                 max_len: int, eos_top: bool = False, row_cap=None,
                 prune_alpha: Optional[float] = None, block_ngram: int = 0,
                 impl: str = "auto"):
    """The per-step beam body over the carry (t, last_tok (B,K), s (B,K,H),
    scores (B,K), tokens (B,K,L), finished (B,K), lengths (B,K)).

    eos_top: once a sentence's top-ranked beam is finished, every beam of
    that sentence freezes. row_cap: optional (B,) per-row step cap. Exact
    admissible pruning (prune_alpha not None): when every live beam's best
    achievable normalized score raw / cap ** alpha is strictly below the
    sentence's worst frozen normalized score, the sentence freezes; the
    ranking of completed hypotheses is unchanged (proof in the JAX
    package's decode/beam.py). block_ngram > 0: no-repeat n-gram ban."""
    V = cfg.tgt_vocab_size

    def body_1(carry):
        t, last_tok, s, scores, tokens, finished, lengths = carry
        ban = ngram_ban(tokens, t, block_ngram, V) if block_ngram > 0 else None
        finished = finished | (t >= max_len)
        if row_cap is not None:
            finished = finished | (t >= row_cap[:, None])
        s_new, top_scores, idx = decode_step_topk(
            params, cfg, last_tok, s, state, scores, finished,
            impl=impl, tables=tables, ban=ban)
        beam_idx = torch.div(idx, V, rounding_mode="floor")
        tok = idx - beam_idx * V

        s_sel = torch.gather(s_new, 1, beam_idx[..., None].expand_as(s_new))
        tokens = torch.gather(tokens, 1, beam_idx[..., None].expand_as(tokens))
        fin_sel = torch.gather(finished, 1, beam_idx)
        len_sel = torch.gather(lengths, 1, beam_idx)
        tokens[:, :, t] = tok                  # finished rows wrote PAD
        lengths = torch.where(fin_sel, len_sel, len_sel + 1)
        finished = fin_sel | (tok == EOS_ID)
        if eos_top:
            finished = finished | finished[:, :1]
        if prune_alpha is not None:
            a = prune_alpha
            fnorm = top_scores / lengths.clamp_min(1).to(torch.float32) ** a
            inf = torch.full_like(fnorm, float("inf"))
            frozen_norm_min = torch.where(finished, fnorm, inf).amin(
                1, keepdim=True)
            any_frozen = finished.any(1, keepdim=True)
            if row_cap is None:
                capf = torch.tensor(float(max_len), device=fnorm.device)
            else:
                capf = row_cap.clamp_max(max_len).to(torch.float32)[:, None]
            bound = top_scores / capf ** a
            ok = finished | (bound < frozen_norm_min)
            finished = finished | (any_frozen & ok.all(1, keepdim=True))
        return (t + 1, tok, s_sel, top_scores, tokens, finished, lengths)

    return body_1


def _resolve_prune(prune: bool, length_norm_alpha: float) -> Optional[float]:
    """prune_alpha for _make_body_1: None when pruning is off or alpha < 0
    (the bound r / cap ** alpha is admissible only for alpha >= 0)."""
    if not prune or length_norm_alpha < 0:
        return None
    return float(length_norm_alpha)


def _resolve_block(block_ngram: int) -> int:
    """n <= 1 disables (a 1-gram ban would forbid every used token)."""
    return block_ngram if block_ngram > 1 else 0


def _beam_init(state: DecodeState, K: int, buf_len: int):
    """Initial carry for a beam search over state's B sentences."""
    B, H = state.s0.shape
    dev = state.s0.device
    scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    # Beam 0 active, the others at NEG_INF so identical initial beams do not
    # flood the first top-K with duplicates.
    scores[:, 0] = 0.0
    return (
        0,
        torch.full((B, K), SOS_ID, dtype=torch.long, device=dev),
        state.s0[:, None, :].expand(B, K, H),
        scores,
        torch.full((B, K, buf_len), PAD_ID, dtype=torch.long, device=dev),
        torch.zeros((B, K), dtype=torch.bool, device=dev),
        torch.zeros((B, K), dtype=torch.long, device=dev),
    )


def _finalize(tokens, lengths, scores, max_len: int, length_norm_alpha: float,
              mask_incomplete: bool = False, steps: int = 0) -> BeamResult:
    """Length-normalize, rank beams best-first (stable: ties keep the lower
    beam), slice the token buffer. mask_incomplete ("eos_top"): beams whose
    last counted token is not <eos> are masked out of the ranking, unless
    the sentence has no complete beam at all."""
    tokens = tokens[:, :, :max_len]
    norm = lengths.clamp_min(1).to(torch.float32) ** length_norm_alpha
    final_scores = scores / norm
    if mask_incomplete:
        last = torch.gather(tokens, 2, (lengths - 1).clamp_min(0)[..., None])[..., 0]
        completed = (lengths > 0) & (last == EOS_ID)
        any_c = completed.any(1, keepdim=True)
        final_scores = torch.where(completed | ~any_c, final_scores,
                                   torch.full_like(final_scores, NEG_INF))
    order = torch.argsort(-final_scores, dim=1, stable=True)
    tokens = torch.gather(tokens, 1, order[..., None].expand_as(tokens))
    lengths = torch.gather(lengths, 1, order)
    final_scores = torch.gather(final_scores, 1, order)
    return BeamResult(tokens=tokens, lengths=lengths, scores=final_scores,
                      best_tokens=tokens[:, 0], best_lengths=lengths[:, 0],
                      steps=steps)


def beam_search(
    params: Dict[str, Any],
    cfg: ModelConfig,
    state: DecodeState,
    *,
    beam_size: int,
    max_len: int,
    length_norm_alpha: float = 1.0,
    tables=None,
    beam_finish: str = "all_frozen",
    row_cap: Optional[torch.Tensor] = None,
    prune: bool = True,
    block_ngram: int = 0,
    impl: str = "auto",
    device: DeviceLike = None,
) -> BeamResult:
    """Beam search over state's B sentences.

    beam_finish: "all_frozen" (decode until all K beams are finished) or
    "eos_top" (stop a sentence once its top-ranked beam is finished; its
    unfinished beams are masked out of the final ranking). row_cap:
    optional (B,) per-row step cap. prune: exact admissible pruning (see
    _make_body_1). block_ngram: no-repeat n-gram blocking (0 disables).
    tables: optional per-vocab decode tables (models.decoder.decode_tables).
    impl: the beam step's impl (models.model.decode_step_topk).
    device: where the search runs (None = the card); state must lie there."""
    dev = resolve_device(device)
    same_device(dev, state.s0, "decode state")
    if beam_size <= 1:
        raise NotImplementedError(
            "beam_size <= 1 (greedy decode) is a later slice of the port")
    if beam_finish not in ("all_frozen", "eos_top"):
        raise ValueError(f"unknown beam_finish {beam_finish!r}")
    eos_top = beam_finish == "eos_top"
    body_1 = _make_body_1(params, cfg, state, tables, max_len,
                          eos_top=eos_top, row_cap=row_cap,
                          prune_alpha=_resolve_prune(prune, length_norm_alpha),
                          block_ngram=_resolve_block(block_ngram), impl=impl)
    carry = _beam_init(state, beam_size, max_len)
    while carry[0] < max_len and not bool(carry[5].all()):
        carry = body_1(carry)
    t, _, _, scores, tokens, _, lengths = carry
    return _finalize(tokens, lengths, scores, max_len, length_norm_alpha,
                     mask_incomplete=eos_top, steps=t)
