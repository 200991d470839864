"""The decode path's selection variables, read in one place.

The JAX package picks its decode paths with environment variables, each
read where it is used. The port reads the same variables, with the same
values and defaults, here, so one A/B setting drives both packages:

- ``VAG_DEC_STEP``: "on" / "1" / "true" runs the fused beam decode step
  (``ops/dec_step.py``) when decode tables are on; default off.
- ``VAG_READOUT_TOPK``: "fused" (the vocab projection inside the readout
  top-K, ``ops/readout_topk.py``) or "unfused" (materialized logits, then
  ``ops/topk.py::beam_topk``). Unset, the port takes "fused" on every
  device (the JAX package takes "unfused" off the TPU; both give the same
  candidates).
- ``VAG_TOPK_IMPL``: the unfused step's top-K: "pallas_lanes" (kernel 6),
  "pallas" / "pallas_rows" (the two legacy kernels, gens 1 and 2), "xla"
  (the plain version). Unset, kernel 6 for CUDA tensors and the plain
  version for CPU tensors.
- ``VAG_STREAM_DECODE``: "on" / "1" or "off" / "0" over
  ``cfg.decode.streaming``.
- ``VAG_TOKEN_TABLES``: "on" / "1" or "off" / "0" over the default (on for
  the card, off for the CPU).
- ``VAG_BEAM_PRUNE``: "on" / "1" or "off" / "0" over the exact admissible
  pruning argument (default on).
- ``VAG_BLOCK_NGRAM``: an int over the no-repeat n-gram order (n <= 1
  disables); it applies to beam, two-phase, streaming and, through
  ``translate_corpus``, greedy decode.
- ``VAG_BEAM_UNROLL``: an int over ``cfg.decode.beam_unroll`` (decoder steps
  per host check of the chunked beam loop).
- ``VAG_TWO_PHASE``: "on" / "1" or "off" / "0" over ``cfg.decode.two_phase``.
- ``VAG_FRT_SLOTS``: the readout top-K's per-lane slot depth (an int;
  unset means K, the unconditionally exact depth). Below K a watermark
  flags the rows that may be inexact, and they are recovered at depth K.
- ``VAG_FRT_DEFER``: "0" turns the chunk-level deferred recovery off (the
  per-step recovery then runs).
- ``VAG_FRT_NOCOND``: "1" skips the recovery altogether. Not exact; for
  measuring the recovery's cost only, as in the JAX package.
- ``VAG_ATTN_E_DTYPE``: the beam attention's (B, K, T, A) energies. "fp32"
  keeps them fp32 in a bf16 decode; "bf16" / "bfloat16" makes them bf16
  in an fp32 decode; unset, they follow the decode's compute dtype.
- ``VAG_FRT_GEMM_DTYPE``: "bf16" / "bfloat16" runs the fused readout
  top-K's vocab GEMM on bf16 operands in an fp32 decode (the output
  matrix cast once a decode, the activations once a step: kernel 1's bf16
  instance on the card); unset, the operands keep the decode's dtype.
- ``VAG_SUPER_CHUNK``: rows of source a corpus decode encodes in one
  encoder pass (an int, default ``translate.SUPER_CHUNK_ROWS``); "", "0"
  and "1" mean one encoder pass per decode chunk.

An explicit argument to a port function wins over its variable; a config
value does not (``translate_corpus`` lets the variable override it, as the
JAX package does).

One training variable, read by ``gru_stream_fp32``:

- ``VAG_GRU_STREAM``: "fp32" keeps the GRU and decoder scans' time
  streams (and their kernels' instances) in fp32 under
  ``compute_dtype="bfloat16"``; unset (or anything else) lets them follow
  the compute dtype, bf16 there, as ``ops/pallas_gru.py`` and
  ``ops/pallas_dec_scan.py`` read it."""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, TypeVar

T = TypeVar("T")


class DecodeKnobs(NamedTuple):
    dec_step: bool
    readout_topk: str            # "fused" | "unfused"
    topk_impl: str               # "auto" | "xla" | "pallas_lanes" | "pallas" | "pallas_rows"
    streaming: Optional[bool]    # None: cfg.decode.streaming decides
    tables: Optional[bool]       # None: on for the card, off for the CPU
    beam_prune: Optional[bool]   # None: the argument decides
    block_ngram: Optional[int]   # None: the argument decides
    beam_unroll: Optional[int]   # None: the argument decides
    two_phase: Optional[bool]    # None: cfg.decode.two_phase decides
    frt_slots: Optional[int]     # None: K
    frt_defer: bool              # False when VAG_FRT_DEFER is "0"
    frt_nocond: bool             # True when VAG_FRT_NOCOND is "1"
    attn_e_dtype: Optional[str]  # "bf16" | "fp32" | None (the ctx's dtype)
    frt_gemm_bf16: bool          # VAG_FRT_GEMM_DTYPE is "bf16"/"bfloat16"
    super_chunk: Optional[int]   # None: translate.SUPER_CHUNK_ROWS


def _on_off(name: str) -> Optional[bool]:
    v = os.environ.get(name, "")
    if v in ("on", "1"):
        return True
    if v in ("off", "0"):
        return False
    return None


def _int(name: str) -> Optional[int]:
    v = os.environ.get(name, "")
    return int(v) if v else None


def _attn_e_dtype() -> Optional[str]:
    v = os.environ.get("VAG_ATTN_E_DTYPE", "")
    if v in ("bf16", "bfloat16"):
        return "bf16"
    return "fp32" if v == "fp32" else None


def _super_chunk() -> Optional[int]:
    # as the JAX package: int(os.environ.get(name, "1024") or 0)
    v = os.environ.get("VAG_SUPER_CHUNK")
    return None if v is None else int(v or 0)


def decode_knobs() -> DecodeKnobs:
    """The current values of the decode selection variables."""
    readout = os.environ.get("VAG_READOUT_TOPK", "")
    topk = os.environ.get("VAG_TOPK_IMPL", "")
    return DecodeKnobs(
        dec_step=os.environ.get("VAG_DEC_STEP", "").lower() in ("on", "1",
                                                                 "true"),
        readout_topk=readout if readout in ("fused", "unfused") else "fused",
        topk_impl=topk if topk in ("xla", "pallas", "pallas_rows",
                                   "pallas_lanes") else "auto",
        streaming=_on_off("VAG_STREAM_DECODE"),
        tables=_on_off("VAG_TOKEN_TABLES"),
        beam_prune=_on_off("VAG_BEAM_PRUNE"),
        block_ngram=_int("VAG_BLOCK_NGRAM"),
        beam_unroll=_int("VAG_BEAM_UNROLL"),
        two_phase=_on_off("VAG_TWO_PHASE"),
        frt_slots=_int("VAG_FRT_SLOTS"),
        frt_defer=os.environ.get("VAG_FRT_DEFER", "") != "0",
        frt_nocond=os.environ.get("VAG_FRT_NOCOND", "") == "1",
        attn_e_dtype=_attn_e_dtype(),
        frt_gemm_bf16=os.environ.get("VAG_FRT_GEMM_DTYPE", "") in (
            "bf16", "bfloat16"),
        super_chunk=_super_chunk(),
    )


def over(knob: Optional[T], default: T) -> T:
    """A variable's value where it is set, else ``default``."""
    return default if knob is None else knob


def gru_stream_fp32() -> bool:
    """Whether VAG_GRU_STREAM forces the scans' fp32 streams ("fp32")."""
    return os.environ.get("VAG_GRU_STREAM", "") == "fp32"
