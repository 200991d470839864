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
- ``VAG_TOPK_IMPL``: the unfused step's top-K: "pallas_lanes" (the
  kernel), "xla" (the plain version), "pallas" / "pallas_rows" (the bench
  kernels, not ported yet: they raise where they are used). Unset, the
  kernel for CUDA tensors and the plain version for CPU tensors.
- ``VAG_STREAM_DECODE``: "on" / "1" or "off" / "0" over
  ``cfg.decode.streaming``.
- ``VAG_TOKEN_TABLES``: "on" / "1" or "off" / "0" over the default (on for
  the card, off for the CPU).

An explicit argument to a port function wins over its variable."""

from __future__ import annotations

import os
from typing import NamedTuple, Optional


class DecodeKnobs(NamedTuple):
    dec_step: bool
    readout_topk: str            # "fused" | "unfused"
    topk_impl: str               # "auto" | "xla" | "pallas_lanes" | "pallas" | "pallas_rows"
    streaming: Optional[bool]    # None: cfg.decode.streaming decides
    tables: Optional[bool]       # None: on for the card, off for the CPU


def _on_off(name: str) -> Optional[bool]:
    v = os.environ.get(name, "")
    if v in ("on", "1"):
        return True
    if v in ("off", "0"):
        return False
    return None


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
    )
