"""Faults planted underneath the timed path, for the check's own tests
and for the readings of its limits: each breaks the program where the
fault would live and leaves the harness and the reference alone.

- ``state_unchanged``: a step that returns its state unchanged (training:
  the update applies nothing; decode: the beam step hands back the state
  it was given);
- ``half_batch``: half of the batch left out (training: the loss is the
  mean over the first half of the rows; decode: the second half of each
  chunk's rows comes back empty);
- ``token_altered``: a token altered where it is produced (decode: the
  first token of each best hypothesis);
- ``search_wrong``: a search that keeps a wrong candidate (decode: at each
  sentence's first step the beam step's best candidate is dropped and
  the second-best kept in its place, with its true score)."""

from __future__ import annotations

import contextlib
from unittest import mock

FAULTS = {"train": ("state_unchanged", "half_batch"),
          "decode": ("state_unchanged", "half_batch", "token_altered",
                     "search_wrong")}


def _train(fault: str):
    from vag_nmt_tpu_torch.train import step as st

    if fault == "state_unchanged":
        orig = st.apply_update

        def apply_update(cfg, state, grads, mesh=None):
            _, norm = orig(cfg, state, grads, mesh)
            return state._replace(step=state.step + 1,
                                  count=state.count + 1), norm
        return mock.patch.object(st, "apply_update", apply_update)
    orig_loss = st.loss_fn

    def loss_fn(params, cfg, batch, gen=None, **kw):
        half = batch["src"].shape[0] // 2
        return orig_loss(params, cfg, {k: v[:half] for k, v in batch.items()},
                         gen, **kw)
    return mock.patch.object(st, "loss_fn", loss_fn)


def _decode(fault: str):
    import torch

    from vag_nmt_tpu_torch.decode import beam, translate

    if fault == "state_unchanged":
        orig_step = beam.decode_step_topk

        def decode_step_topk(params, cfg, tok, s, *a, **kw):
            out = orig_step(params, cfg, tok, s, *a, **kw)
            return (s,) + tuple(out[1:])
        return mock.patch.object(beam, "decode_step_topk", decode_step_topk)
    if fault == "search_wrong":
        orig_step = beam.decode_step_topk

        def decode_step_topk(params, cfg, tok, s, state, scores, *a, **kw):
            s_new, top, idx, *rest = orig_step(params, cfg, tok, s, state,
                                               scores, *a, **kw)
            # a sentence's first step: only beam 0 holds a live score
            first = (scores[:, 1:] <= beam.NEG_INF / 2).all(1, keepdim=True)
            top = torch.where(first, torch.cat([top[:, 1:2], top[:, 1:]], 1),
                              top)
            idx = torch.where(first, torch.cat([idx[:, 1:2], idx[:, 1:]], 1),
                              idx)
            return (s_new, top, idx, *rest)
        return mock.patch.object(beam, "decode_step_topk", decode_step_topk)

    def broken(res, V):
        tokens, lengths, scores = (res.tokens.clone(), res.lengths.clone(),
                                   res.scores.clone())
        if fault == "half_batch":
            h = tokens.shape[0] // 2
            tokens[h:], lengths[h:], scores[h:] = 0, 0, 0.0
        else:
            first = tokens[:, 0, 0]
            tokens[:, 0, 0] = (first - 4 + 1) % (V - 4) + 4
        return res._replace(tokens=tokens, lengths=lengths, scores=scores,
                            best_tokens=tokens[:, 0],
                            best_lengths=lengths[:, 0])

    def wrap(fn):
        def inner(params, cfg, *a, **kw):
            out = fn(params, cfg, *a, **kw)
            V = cfg.tgt_vocab_size
            if isinstance(out, tuple) and not hasattr(out, "_replace"):
                return (broken(out[0], V),) + tuple(out[1:])
            return broken(out, V)
        return inner

    stack = contextlib.ExitStack()
    for name in ("beam_search", "beam_search_two_phase",
                 "beam_search_streaming"):
        stack.enter_context(mock.patch.object(
            translate, name, wrap(getattr(translate, name))))
    return stack


@contextlib.contextmanager
def planted(fault, kind: str):
    """The block with ``fault`` planted in a ``kind`` cell's program (None:
    nothing planted)."""
    if fault is None:
        yield
        return
    if fault not in FAULTS[kind]:
        raise ValueError(f"no fault {fault!r} for a {kind} cell")
    with (_train(fault) if kind == "train" else _decode(fault)):
        yield
