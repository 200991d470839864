"""Batched beam search (counterpart of the JAX package's ``decode/beam.py``:
the chunked single-loop decoder, the two-phase straggler decoder and the
streaming-refill decoder).

- encode once; the beams of a sentence share the encoder context;
- each step: one decoder step over all rows, fused candidate scoring and
  top-K over the (beam * vocab) grid, gathers of state and history by beam;
- finished hypotheses emit <pad> at log-prob 0, so they ride along frozen
  and keep competing in the top-K at their final score;
- the loop exits when every hypothesis of the batch is finished (the JAX
  ``while_loop``: on the card a CUDA graph of U steps replayed until its
  exit flag is set, one device read a replay; on the CPU, or with
  ``dispatch="eager"``, a host loop; ``decode/graphs.py``);
- the final ranking divides by length ** alpha.

With the readout top-K at a slot depth below K (``VAG_FRT_SLOTS``), the
chunked loop carries the readout's live-row watermark flag and reruns the
chunk at depth K when it fired (read once, at the chunk's end); the
two-phase and streaming loops recover each step instead
(``ops/readout_topk.py``). Either way the hypotheses are those of depth K.

Each function reads ``VAG_BEAM_PRUNE`` and ``VAG_BLOCK_NGRAM`` (and
``beam_search`` ``VAG_BEAM_UNROLL``) where its argument is left at None
(core/knobs.py)."""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from vag_nmt_tpu_torch.core.config import EOS_ID, ModelConfig, PAD_ID, SOS_ID
from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device, same_device
from vag_nmt_tpu_torch.core.knobs import decode_knobs, over
from vag_nmt_tpu_torch.decode.graphs import (DONE, REFILL, Dispatch, Stream,
                                             loop_graphs, run_loop,
                                             run_stream)
from vag_nmt_tpu_torch.models.model import (DecodeOpts, DecodeState,
                                             decode_opts, decode_step_topk)
from vag_nmt_tpu_torch.ops.readout_topk import deferred_exactness_active

NEG_INF = -1e9


class BeamResult(NamedTuple):
    tokens: torch.Tensor        # (B, K, L) <pad>-padded, best beam first
    lengths: torch.Tensor       # (B, K) incl. <eos> when produced
    scores: torch.Tensor        # (B, K) fp32 length-normalized, descending
    best_tokens: torch.Tensor   # (B, L)
    best_lengths: torch.Tensor  # (B,)
    steps: int                  # realized loop trips (decoder steps run)
    reruns: int = 0             # chunk reruns at slot depth K (deferred mode)


def ngram_ban(tokens: torch.Tensor, t, n: int, V: int) -> torch.Tensor:
    """Per-step no-repeat n-gram ban list (fairseq semantics).

    tokens: (B, K, L) token buffer; t: current decode position, an int, a
    0-dim tensor or a (B,) tensor of per-row positions (an int is a host
    position, made a device tensor here); n: n-gram order (> 1); V: vocab
    size, the "no ban" sentinel. Returns (B, K, L) banned ids: each entry
    is the token that would complete an n-gram already present in that
    beam's own hypothesis, or V."""
    nm1 = n - 1
    B, K, L = tokens.shape
    dev = tokens.device
    if isinstance(t, int):
        t = _device_t(t, dev)
    t = t.expand(B)
    # -1 tail padding never equals a real id, so windows past L never match.
    padded = torch.cat([tokens, torch.full((B, K, nm1), -1, dtype=tokens.dtype,
                                           device=dev)], dim=-1)
    match = torch.ones((B, K, L), dtype=torch.bool, device=dev)
    for j in range(nm1):
        # suffix token at absolute position t - (n-1) + j
        idx = (t + (j - nm1)).clamp(0, L - 1)[:, None, None]
        last = torch.gather(tokens, 2, idx.expand(B, K, 1))
        match &= padded[:, :, j:j + L] == last
    # window [i, i+n-1] must lie fully in the decoded past
    valid = (torch.arange(L, device=dev)[None, :] <= t[:, None] - n)[:, None]
    return torch.where(match & valid, padded[:, :, nm1:nm1 + L],
                       torch.full_like(tokens, V))


def _make_body_1(params, cfg: ModelConfig, state: DecodeState, tables,
                 mode: str, max_len: int, eos_top: bool = False, row_cap=None,
                 prune_alpha: Optional[float] = None, block_ngram: int = 0,
                 impl: str = "auto", opts: Optional[DecodeOpts] = None):
    """The per-step beam body over the carry (t, last_tok (B,K), s (B,K,H),
    scores (B,K), tokens (B,K,L), finished (B,K), lengths (B,K)), plus, in
    mode "defer", the 0-dim bool flag that ORs the readout's live-row
    watermark flags (mode: "plain" | "defer" | "exact", the last running the
    readout at slot depth K; see beam_search). t is a tensor on the
    device, never a host int, so a captured graph replays the body at
    every step: 0-dim (all rows in step) or (B,) per-row positions (the
    streaming-refill loop), where freezing compares per row. The token
    lands at t by a one-hot mask over the length axis; a row whose t has
    run past the buffer writes nothing. Rows freeze at t >= max_len, so
    the steps an unrolled loop runs past max_len are no-ops. The body
    makes no host copy and reads nothing back (a graph captures it).

    eos_top: once a sentence's top-ranked beam is finished, every beam of
    that sentence freezes. row_cap: optional (B,) per-row step cap. Exact
    admissible pruning (prune_alpha not None): when every live beam's best
    achievable normalized score raw / cap ** alpha is strictly below the
    sentence's worst frozen normalized score, the sentence freezes; the
    ranking of completed hypotheses is unchanged (proof in the JAX
    package's decode/beam.py). block_ngram > 0: no-repeat n-gram ban.
    opts: the decode's step choices (None: ``decode_opts`` at ctx's dtype,
    read here once for the body)."""
    V = cfg.tgt_vocab_size
    if opts is None:
        opts = decode_opts(state.ctx.dtype)
    dev = state.s0.device
    # the prune's cap without row caps, made once (torch.full: no host copy)
    max_capf = torch.full((), float(max_len), dtype=torch.float32, device=dev)

    def body_1(carry):
        t, last_tok, s, scores, tokens, finished, lengths = carry[:7]
        per_row = t.dim() > 0
        t_col = t[:, None] if per_row else t
        ban = ngram_ban(tokens, t, block_ngram, V) if block_ngram > 0 else None
        finished = finished | (t_col >= max_len)
        if row_cap is not None:
            finished = finished | (t_col >= row_cap[:, None])
        s_new, top_scores, idx, *flag = decode_step_topk(
            params, cfg, last_tok, s, state, scores, finished,
            impl=impl, tables=tables, ban=ban, defer_exact=mode == "defer",
            exact=mode == "exact", opts=opts)
        beam_idx = torch.div(idx, V, rounding_mode="floor")
        tok = idx - beam_idx * V

        s_sel = torch.gather(s_new, 1, beam_idx[..., None].expand_as(s_new))
        tokens = torch.gather(tokens, 1, beam_idx[..., None].expand_as(tokens))
        fin_sel = torch.gather(finished, 1, beam_idx)
        len_sel = torch.gather(lengths, 1, beam_idx)
        hit = torch.arange(tokens.shape[-1], device=dev) == (
            t[:, None, None] if per_row else t)
        tokens = torch.where(hit, tok[:, :, None], tokens)  # finished: PAD
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
            capf = (max_capf if row_cap is None else
                    row_cap.clamp_max(max_len).to(torch.float32)[:, None])
            bound = top_scores / capf ** a
            ok = finished | (bound < frozen_norm_min)
            finished = finished | (any_frozen & ok.all(1, keepdim=True))
        out = (t + 1, tok, s_sel, top_scores, tokens, finished, lengths)
        return out + (carry[7] | flag[0],) if mode == "defer" else out

    return body_1


def _resolve_prune(prune: Optional[bool],
                   length_norm_alpha: float) -> Optional[float]:
    """prune_alpha for _make_body_1 (prune None: VAG_BEAM_PRUNE, else on):
    None when pruning is off or alpha < 0 (the bound r / cap ** alpha is
    admissible only for alpha >= 0)."""
    if prune is None:
        prune = over(decode_knobs().beam_prune, True)
    if not prune or length_norm_alpha < 0:
        return None
    return float(length_norm_alpha)


def _resolve_block(block_ngram: Optional[int]) -> int:
    """block_ngram None: VAG_BLOCK_NGRAM, else 0. n <= 1 disables (a 1-gram
    ban would forbid every used token)."""
    if block_ngram is None:
        block_ngram = over(decode_knobs().block_ngram, 0)
    return block_ngram if block_ngram > 1 else 0


def _fresh_scores(n: int, K: int, dev) -> torch.Tensor:
    """Beam 0 active, the others at NEG_INF so identical initial beams do
    not flood the first top-K with duplicates."""
    scores = torch.full((n, K), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    return scores


def _device_t(t: int, dev) -> torch.Tensor:
    """A loop's position t as the 0-dim int64 tensor its carry holds."""
    return torch.full((), t, dtype=torch.long, device=dev)


def _beam_init(state: DecodeState, K: int, buf_len: int):
    """Initial carry for a beam search over state's B sentences."""
    B, H = state.s0.shape
    dev = state.s0.device
    return (
        _device_t(0, dev),
        torch.full((B, K), SOS_ID, dtype=torch.long, device=dev),
        state.s0[:, None, :].expand(B, K, H),
        _fresh_scores(B, K, dev),
        torch.full((B, K, buf_len), PAD_ID, dtype=torch.long, device=dev),
        torch.zeros((B, K), dtype=torch.bool, device=dev),
        torch.zeros((B, K), dtype=torch.long, device=dev),
    )


def _finalize(tokens, lengths, scores, max_len: int, length_norm_alpha: float,
              mask_incomplete: bool = False, steps: int = 0,
              reruns: int = 0) -> BeamResult:
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
                      steps=steps, reruns=reruns)


def beam_search(
    params: Dict[str, Any],
    cfg: ModelConfig,
    state: DecodeState,
    *,
    beam_size: int,
    max_len: int,
    length_norm_alpha: float = 1.0,
    unroll: int = 0,
    tables=None,
    beam_finish: str = "all_frozen",
    row_cap: Optional[torch.Tensor] = None,
    prune: Optional[bool] = None,
    block_ngram: Optional[int] = None,
    impl: str = "auto",
    device: DeviceLike = None,
    opts: Optional[DecodeOpts] = None,
    dispatch: Dispatch = None,
) -> BeamResult:
    """Beam search over state's B sentences.

    beam_finish: "all_frozen" (decode until all K beams are finished) or
    "eos_top" (stop a sentence once its top-ranked beam is finished; its
    unfinished beams are masked out of the final ranking). row_cap:
    optional (B,) per-row step cap. prune: exact admissible pruning (see
    _make_body_1; None: VAG_BEAM_PRUNE, else on). block_ngram: no-repeat
    n-gram blocking (None: VAG_BLOCK_NGRAM, else 0; 0 disables). tables:
    optional per-vocab decode tables (models.decoder.decode_tables). impl:
    the beam step's impl (models.model.decode_step_topk). device: where the
    search runs (None = the card); state must lie there. opts: the
    decode's step choices (``models.model.DecodeOpts``; None: read from
    the selection variables once a loop body). dispatch: "graph" (the
    loop's U steps a replayed CUDA graph), "eager" (a host loop), None
    ("graph" on a CUDA device unless ``opts`` holds a mesh of several
    ranks, else "eager"; ``decode/graphs.resolve_dispatch``), or a
    caller's ``LoopGraphs``, shared by its loops; a failed capture raises.

    unroll: decoder steps per check of the exit condition (0:
    VAG_BEAM_UNROLL, else 1). The token buffer is padded to a multiple of
    it and sliced back; rows freeze at max_len, so the hypotheses do not
    depend on it, only the steps run past the last finish do.

    Device reads: one per check of the exit condition (all finished?), and
    in the deferred mode (``deferred_exactness_active``) one more at the
    chunk's end, the OR of the readout's live-row watermark flags; when it
    is set, the chunk runs again from the same initial carry with the
    readout at depth K (under "graph" a loop of its own, captured only
    when a flag fires). ``steps`` counts every decoder step run, the
    rerun's included; ``reruns`` the reruns."""
    dev = resolve_device(device)
    same_device(dev, state.s0, "decode state")
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    if beam_finish not in ("all_frozen", "eos_top"):
        raise ValueError(f"unknown beam_finish {beam_finish!r}")
    eos_top = beam_finish == "eos_top"
    if unroll <= 0:
        unroll = over(decode_knobs().beam_unroll, 1)
    U = min(max(unroll, 1), max_len)
    max_len_pad = -(-max_len // U) * U
    K = beam_size
    prune_alpha = _resolve_prune(prune, length_norm_alpha)
    block_n = _resolve_block(block_ngram)
    graphs = loop_graphs(dispatch, dev, None if opts is None else opts.tp)

    def run(mode, carry):
        def make_body(st, rc):
            return _make_body_1(params, cfg, st, tables, mode, max_len,
                                eos_top=eos_top, row_cap=rc,
                                prune_alpha=prune_alpha, block_ngram=block_n,
                                impl=impl, opts=opts)
        key = ("beam", mode, eos_top, prune_alpha, block_n, impl, max_len,
               id(params), id(tables), opts)
        return run_loop(make_body, state, row_cap, carry, 0, max_len_pad,
                        unroll=U, graphs=graphs, key=key)

    init = _beam_init(state, K, max_len_pad)
    reruns = 0
    if deferred_exactness_active(K):
        out, steps = run("defer", init + (torch.zeros((), dtype=torch.bool,
                                                      device=dev),))
        if bool(out[7]):
            out, rerun_steps = run("exact", init)
            steps += rerun_steps
            reruns = 1
    else:
        out, steps = run("plain", init)
    _, _, _, scores, tokens, _, lengths = out[:7]
    return _finalize(tokens, lengths, scores, max_len, length_norm_alpha,
                     mask_incomplete=eos_top, steps=steps, reruns=reruns)


def beam_search_two_phase(
    params: Dict[str, Any],
    cfg: ModelConfig,
    state: DecodeState,
    *,
    beam_size: int,
    max_len: int,
    chunk: int,
    split_len: int,
    length_norm_alpha: float = 1.0,
    tables=None,
    beam_finish: str = "all_frozen",
    row_cap: Optional[torch.Tensor] = None,
    prune: Optional[bool] = None,
    block_ngram: Optional[int] = None,
    impl: str = "auto",
    device: DeviceLike = None,
    opts: Optional[DecodeOpts] = None,
    dispatch: Dispatch = None,
) -> Tuple[BeamResult, List[int], int]:
    """Two-phase straggler-compacted beam search over N = S * chunk
    sentences (counterpart of the JAX package's ``beam_search_two_phase``,
    whose docstring has the measurements behind it).

    Phase 1: each of the S chunks runs its own early-exit loop for at most
    L1 = split_len steps. Then, for each rung of the doubling ladder L1 ->
    2 L1 -> ... -> max_len: the sentences are re-packed on the device by a
    stable argsort of the per-sentence finished flag, stragglers first,
    and only the first ceil(n_unfinished / chunk) chunks resume, each from
    the previous rung's cap until this rung's or until its rows are all
    finished. Finally the rows go back to their original order and are
    ranked (``_finalize``). Exact: the step body is row-local, so a row's
    hypotheses do not depend on the chunk it rides in.

    The bodies run in mode "plain": at a readout slot depth below K each
    step recovers its flagged rows itself. Other arguments as beam_search;
    under "graph" phase 1 and every rung replay one graph (a chunk of B
    rows whatever its t), each resume copying its t_start into the device
    t.

    Device reads: one per loop trip (all finished?), and one per rung, the
    count of unfinished sentences.

    Returns (BeamResult over the N rows, steps1: the trips of each chunk's
    phase 1, steps2: the resume trips of all rungs). Each trip is one
    chunk-row decoder step; ``BeamResult.steps`` is their sum."""
    dev = resolve_device(device)
    same_device(dev, state.s0, "decode state")
    N = state.s0.shape[0]
    B = chunk
    if N % B:
        raise ValueError(f"two-phase decode needs N ({N}) % chunk ({B}) == 0")
    if beam_finish not in ("all_frozen", "eos_top"):
        raise ValueError(f"unknown beam_finish {beam_finish!r}")
    eos_top = beam_finish == "eos_top"
    S = N // B
    K = beam_size
    L1 = min(max(int(split_len), 1), max_len)
    rungs = []                           # doubling caps, ending at max_len
    cap = L1
    while cap < max_len:
        cap = min(cap * 2, max_len)
        rungs.append(cap)
    prune_alpha = _resolve_prune(prune, length_norm_alpha)
    block_n = _resolve_block(block_ngram)
    graphs = loop_graphs(dispatch, dev, None if opts is None else opts.tp)

    def make_body(st, rc):
        return _make_body_1(params, cfg, st, tables, "plain", max_len,
                            eos_top=eos_top, row_cap=rc,
                            prune_alpha=prune_alpha, block_ngram=block_n,
                            impl=impl, opts=opts)

    key = ("two_phase", eos_top, prune_alpha, block_n, impl, max_len,
           id(params), id(tables), opts)

    def run(st, rc, carry, t0, t_end):
        return run_loop(make_body, st, rc, carry, t0, t_end, graphs=graphs,
                        key=key)

    # ---- phase 1: per-chunk early-exit loops capped at L1 ----------------
    steps1: List[int] = []
    outs = []
    for c in range(S):
        sl = slice(c * B, (c + 1) * B)
        st = DecodeState(*(x[sl] for x in state))
        rc = None if row_cap is None else row_cap[sl]
        out, t = run(st, rc, _beam_init(st, K, max_len), 0, L1)
        steps1.append(t)
        outs.append(out[1:])
    # (last_tok, s, scores, tokens, finished, lengths) over the N rows
    packed = [torch.cat([o[j] for o in outs]) for j in range(6)]
    work = DecodeState(*state)
    cap_p = row_cap
    order = torch.arange(N, device=dev)   # packed row -> original row
    steps2 = 0
    t_start = L1
    for t_end in rungs:
        # ---- compact: stragglers first (stable argsort) -------------------
        fin_sent = packed[4].all(1)
        perm = torch.argsort(fin_sent.to(torch.int32), stable=True)
        n_unfin = N - int(fin_sent.sum())
        packed = [a[perm] for a in packed]
        work = DecodeState(*(x[perm] for x in work))
        cap_p = None if cap_p is None else cap_p[perm]
        order = order[perm]
        # ---- resume straggler chunks from t_start to t_end ----------------
        i = 0
        while i < S and i * B < n_unfin:
            sl = slice(i * B, (i + 1) * B)
            st = DecodeState(*(x[sl] for x in work))
            rc = None if cap_p is None else cap_p[sl]
            out, t = run(st, rc, (_device_t(t_start, dev),)
                         + tuple(a[sl] for a in packed), t_start, t_end)
            for a, v in zip(packed, out[1:]):
                a[sl] = v
            steps2 += t - t_start
            i += 1
        t_start = t_end

    # ---- scatter back to the original row order + finalize ---------------
    inv = torch.argsort(order)
    _, _, scores, tokens, _, lengths = (a[inv] for a in packed)
    res = _finalize(tokens, lengths, scores, max_len, length_norm_alpha,
                    mask_incomplete=eos_top, steps=sum(steps1) + steps2)
    return res, steps1, steps2


class StreamSet(NamedTuple):
    """The streaming loop's device state (the JAX loop's carry): the
    working set's W slots, each at its own position t, and the loop's
    outputs. The trip and the refill write it in place."""
    ids: torch.Tensor        # (W,) each slot's pool row; N: exhausted
    t: torch.Tensor          # (W,) each slot's position
    last_tok: torch.Tensor   # (W, K)
    s: torch.Tensor          # (W, K, H)
    scores: torch.Tensor     # (W, K)
    hist: torch.Tensor       # (W, K, max_len)
    finished: torch.Tensor   # (W, K)
    lengths: torch.Tensor    # (W, K)
    ctx: torch.Tensor        # the slots' DecodeState rows
    ctx_proj: torch.Tensor
    src_mask: torch.Tensor
    s0: torch.Tensor
    cap: Optional[torch.Tensor]   # (W,) the slots' step caps
    nxt: torch.Tensor        # () the next pool row
    refills: torch.Tensor    # () refills run
    o_tok: torch.Tensor      # (N + 1, K, max_len) per pool row; N: scratch
    o_sc: torch.Tensor       # (N + 1, K)
    o_len: torch.Tensor      # (N + 1, K)
    flag: torch.Tensor       # () the trip's verdict (decode/graphs REFILL,
                             # DONE, else 0)

    def carry(self) -> Tuple[torch.Tensor, ...]:
        """The beam body's carry (t, last_tok, s, scores, hist, finished,
        lengths)."""
        return (self.t, self.last_tok, self.s, self.scores, self.hist,
                self.finished, self.lengths)

    def slot_rows(self) -> Tuple[Optional[torch.Tensor], ...]:
        """Every tensor with one row a slot."""
        return (self.ids, *self.carry(), self.ctx, self.ctx_proj,
                self.src_mask, self.s0, self.cap)


def _stream_init(pool: DecodeState, row_cap: Optional[torch.Tensor], W: int,
                 K: int, max_len: int) -> StreamSet:
    """The set over pool rows [0, W), and empty outputs."""
    N, H = pool.s0.shape
    dev = pool.s0.device

    def scalar(v):
        return torch.full((), v, dtype=torch.long, device=dev)

    return StreamSet(
        ids=torch.arange(W, device=dev),
        t=torch.zeros((W,), dtype=torch.long, device=dev),
        last_tok=torch.full((W, K), SOS_ID, dtype=torch.long, device=dev),
        s=pool.s0[:W, None, :].expand(W, K, H),
        scores=_fresh_scores(W, K, dev),
        hist=torch.full((W, K, max_len), PAD_ID, dtype=torch.long,
                        device=dev),
        finished=torch.zeros((W, K), dtype=torch.bool, device=dev),
        lengths=torch.zeros((W, K), dtype=torch.long, device=dev),
        ctx=pool.ctx[:W], ctx_proj=pool.ctx_proj[:W],
        src_mask=pool.src_mask[:W], s0=pool.s0[:W],
        cap=None if row_cap is None else row_cap[:W],
        nxt=scalar(W), refills=scalar(0),
        o_tok=torch.full((N + 1, K, max_len), PAD_ID, dtype=torch.long,
                         device=dev),
        o_sc=torch.zeros((N + 1, K), dtype=torch.float32, device=dev),
        o_len=torch.zeros((N + 1, K), dtype=torch.long, device=dev),
        flag=scalar(0))


def _refill(pool: DecodeState, row_cap: Optional[torch.Tensor],
            st: StreamSet, slot: torch.Tensor, fresh: torch.Tensor) -> None:
    """One refill of the set, in place: the reference's masked form, on
    device tensors of fixed shapes over all W slots (no host read, no
    shape from a device value). A stable argsort of the finished flags
    puts the live slots first; the n_fin slots [W - n_fin, W) emit their
    rows into the outputs (every other slot into scratch row N) and take
    pool rows nxt, nxt + 1, ..., those at N or beyond the exhausted
    sentinel N, finished at once. slot: arange(W); fresh: the (W, K)
    initial scores."""
    N, W = pool.s0.shape[0], slot.shape[0]
    fin = st.finished.all(1)
    n_fin = fin.sum()
    perm = torch.argsort(fin.to(torch.int32), stable=True)
    for x in st.slot_rows():
        if x is not None:
            x.copy_(x[perm])
    n_live = W - n_fin
    new = slot >= n_live                        # the slots refilled
    emit = torch.where(new, st.ids, N)
    st.o_tok.index_copy_(0, emit, st.hist)
    st.o_sc.index_copy_(0, emit, st.scores)
    st.o_len.index_copy_(0, emit, st.lengths)
    cand = st.nxt + slot - n_live
    sent = cand >= N
    ids = torch.where(new, torch.where(sent, N, cand), st.ids)
    gid = ids.clamp_max(N - 1)
    for w, p in zip((st.ctx, st.ctx_proj, st.src_mask, st.s0, st.cap),
                    (*pool, row_cap)):
        if w is not None:
            m = new.view(W, *(1,) * (w.dim() - 1))
            w.copy_(torch.where(m, p[gid], w))
    st.s.copy_(torch.where(new[:, None, None], st.s0[:, None, :], st.s))
    st.t.masked_fill_(new, 0)
    st.last_tok.masked_fill_(new[:, None], SOS_ID)
    st.scores.copy_(torch.where(new[:, None], fresh, st.scores))
    st.hist.masked_fill_(new[:, None, None], PAD_ID)
    st.finished.copy_(torch.where(new[:, None], (new & sent)[:, None],
                                  st.finished))
    st.lengths.masked_fill_(new[:, None], 0)
    st.nxt.copy_((st.nxt + n_fin).clamp_max(N))
    st.refills.add_(1)
    st.ids.copy_(ids)


def _make_stream(params, cfg: ModelConfig, tables, max_len: int, R: int,
                 **body_kw):
    """make_stream for ``decode/graphs.run_stream``: over the static pool,
    its step caps and the set, the trip (one step of the set's beam body,
    built once, written back in place; then on the device the set's
    finished count n_fin and the flag: REFILL where n_fin >= R and the
    pool has rows left, DONE where it has none and every slot is
    finished) and the refill (``_refill``)."""
    def make(pool: DecodeState, row_cap, st: StreamSet) -> Stream:
        N, W = pool.s0.shape[0], st.ids.shape[0]
        dev = st.ids.device
        body = _make_body_1(params, cfg, DecodeState(st.ctx, st.ctx_proj,
                                                     st.src_mask, st.s0),
                            tables, "plain", max_len, row_cap=st.cap,
                            **body_kw)
        slot = torch.arange(W, device=dev)
        fresh = _fresh_scores(W, st.scores.shape[1], dev)

        def trip():
            carry = st.carry()
            for dst, src in zip(carry, body(carry)):
                dst.copy_(src)
            n_fin = st.finished.all(1).sum()
            refill = (n_fin >= R) & (st.nxt < N)
            done = (st.nxt >= N) & (n_fin == W)
            st.flag.copy_(refill.long() * REFILL + done.long() * DONE)

        return Stream(trip=trip,
                      refill=lambda: _refill(pool, row_cap, st, slot, fresh),
                      flag=st.flag)

    return make


def beam_search_streaming(
    params: Dict[str, Any],
    cfg: ModelConfig,
    state: DecodeState,
    *,
    beam_size: int,
    max_len: int,
    slots: int,
    refill_threshold: int = 0,
    length_norm_alpha: float = 1.0,
    tables=None,
    beam_finish: str = "all_frozen",
    row_cap: Optional[torch.Tensor] = None,
    prune: Optional[bool] = None,
    block_ngram: Optional[int] = None,
    impl: str = "auto",
    device: DeviceLike = None,
    opts: Optional[DecodeOpts] = None,
    dispatch: Dispatch = None,
) -> Tuple[BeamResult, int, int]:
    """Streaming-refill beam search over state's N-sentence pool
    (counterpart of the JAX package's ``beam_search_streaming``): a working
    set of ``slots`` rows decodes in one loop, each row at its own position
    t, and whenever at least ``refill_threshold`` (0: max(1, slots // 4))
    sentences of the set are finished and the pool has rows left, the set
    is compacted (a stable argsort puts the live rows first), the finished
    rows' results go to per-pool-row outputs and the next pool rows take
    their slots. Exact per sentence: the step body is row-local, so a row's
    hypotheses do not depend on the slot it rides in or its neighbours.

    The loop is two programs over device tensors (``StreamSet``), a trip
    and the masked refill (``_refill``), both in place; the next pool row
    and the refill count stay on the device. Each trip ends in a flag on
    the device (refill next, done, or neither), which the host reads once
    a trip; it runs the refill only on the trips that flag it, as the
    reference's ``lax.cond`` fires. dispatch as beam_search: "graph" (the
    trip and the refill each a captured CUDA graph, one stream and one
    memory pool, the refill graph replayed only when flagged;
    ``decode/graphs.run_stream``), "eager" (the host enqueues both
    programs), None ("graph" on a CUDA device unless ``opts`` holds a
    mesh of several ranks), or a caller's ``LoopGraphs``, which keeps one
    loop per pool shape and loads each pool into it; a failed capture
    raises. Both dispatches run the same programs, so their hypotheses,
    scores, trips and refills are equal bit for bit. The bodies run in
    mode "plain" (see beam_search_two_phase); prune and block_ngram as
    beam_search.

    Returns (BeamResult over the N pool rows in pool order, steps (loop
    trips, each one ``slots``-row decoder step), refills (refill events))."""
    dev = resolve_device(device)
    same_device(dev, state.s0, "decode state")
    if beam_finish not in ("all_frozen", "eos_top"):
        raise ValueError(f"unknown beam_finish {beam_finish!r}")
    eos_top = beam_finish == "eos_top"
    prune_alpha = _resolve_prune(prune, length_norm_alpha)
    block_n = _resolve_block(block_ngram)
    N = state.s0.shape[0]
    W = min(slots, N)
    R = refill_threshold if refill_threshold > 0 else max(1, W // 4)
    R = min(R, W)
    graphs = loop_graphs(dispatch, dev, None if opts is None else opts.tp)
    make = _make_stream(params, cfg, tables, max_len, R, eos_top=eos_top,
                        prune_alpha=prune_alpha, block_ngram=block_n,
                        impl=impl, opts=opts)
    key = ("stream", eos_top, prune_alpha, block_n, impl, max_len, R,
           id(params), id(tables), opts)
    st, steps, _ = run_stream(make, state, row_cap,
                              _stream_init(state, row_cap, W, beam_size,
                                           max_len),
                              graphs=graphs, key=key)
    # Final emission: every resident slot holds a distinct pool row (or the
    # scratch row).
    st.o_tok[st.ids] = st.hist
    st.o_sc[st.ids] = st.scores
    st.o_len[st.ids] = st.lengths
    res = _finalize(st.o_tok[:N], st.o_len[:N], st.o_sc[:N], max_len,
                    length_norm_alpha, mask_incomplete=eos_top, steps=steps)
    return res, steps, int(st.refills)
