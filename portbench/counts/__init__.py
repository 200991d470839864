"""The benchmark's own operation and byte counts (its copy of the port's
``core/flops.py`` and of the bound arithmetic of its chip script), and the
table of peaks that every share of a roofline or of a peak divides by.

Every count is taken from the algorithm's shapes and the inputs' own
lengths, never from how a kernel is tiled: a product of an (m, k) and a
(k, n) matrix is 2·m·k·n operations whatever it pads, and each input byte
is read once and each output byte written once. A row-step is one row of
one recurrence step that the inputs need (a source token of the encoder, a
target position of the decoder, a beam of a decoded step), so padding,
filler rows and the steps run for rows already finished count as time and
not as work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
products in fp32 at 165 TFLOP/s (the TF32 tensor rate of 495 TFLOP/s over
the three passes that an fp32-exact product takes), in bf16 at 989
TFLOP/s, and 3.35 TB/s of HBM."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def least_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take for ``flops`` products in
    ``dtype`` and ``nbytes`` of traffic: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------- model

def prepare_flops(m: Dict, T: int) -> int:
    """One sentence of source length T: the bidirectional encoder, the
    decoder attention's context projection, and (multimodal) the image
    projection, the grounding attention, the text projection and the
    decoder init."""
    H, C, A, D, S = (m["hidden_dim"], 2 * m["hidden_dim"], m["attn_dim"],
                     m["dec_hidden_dim"], m["shared_dim"])
    f = 0
    for layer in range(m["enc_layers"]):
        x = m["emb_dim"] if layer == 0 else C
        f += 2 * (2 * T * x * 3 * H + 2 * T * H * 3 * H)
    f += 2 * T * C * A + 2 * C * D
    if m.get("multimodal", True):
        f += 2 * m["img_feat_dim"] * S
        f += 2 * T * C * A + 2 * S * A + 2 * T * A + 2 * T * C
        f += 2 * C * S + 2 * C * D
    return f


def decode_step_flops(m: Dict, T: int) -> int:
    """One decoder step of one row: GRU1, the attention over T positions,
    GRU2, the readout and the vocab projection."""
    E, D, A, C, V = (m["emb_dim"], m["dec_hidden_dim"], m["attn_dim"],
                     2 * m["hidden_dim"], m["tgt_vocab_size"])
    R = E
    return (2 * E * 3 * D + 2 * D * 3 * D + 2 * D * A + 2 * T * A
            + 2 * T * C + 2 * C * 3 * D + 2 * D * 3 * D
            + 2 * (E * R + D * R + C * R) + 2 * R * V)


def decode_sentence_flops(m: Dict, T: int, steps: int, beams: int) -> int:
    """A sentence of source length T decoded in ``steps`` steps of
    ``beams`` rows: its encode once and its own steps, not its chunk's."""
    return prepare_flops(m, T) + steps * beams * decode_step_flops(m, T)


def train_pair_flops(m: Dict, T: int, Tt: int) -> int:
    """Forward and backward of one pair (source T, Tt decoder steps): three
    times the forward, the usual count."""
    return 3 * (prepare_flops(m, T) + Tt * decode_step_flops(m, T))


def train_batch_flops(m: Dict, lens: Iterable[Tuple[int, int]]) -> int:
    """A batch of real pairs (source length, decoder steps): each pair at
    its own lengths plus the in-batch VSE similarity matrix."""
    lens = list(lens)
    n = len(lens)
    f = sum(train_pair_flops(m, T, Tt) for T, Tt in lens)
    if m.get("multimodal", True):
        f += 3 * 2 * n * n * m["shared_dim"]
    return f


# -------------------------------------------------------------- kernels

def readout_counts(m: Dict, rows: int, calls: int, dtype: str
                   ) -> Tuple[float, float]:
    """Kernel 1 (1b): the vocab projection of ``rows`` beam row-steps with
    its log-sum-exp and top-K, over ``calls`` launches: (operations,
    bytes). Each launch reads W (E, V) and the bias once; each row reads
    its activations and writes its top-K values, ids and lse."""
    E, V = m["emb_dim"], m["tgt_vocab_size"]
    b = DTYPE_BYTES[dtype]
    flops = 2.0 * rows * E * V
    nbytes = calls * (E * V * b + 4 * V) + rows * (E * b + 4 + 16 * 8)
    return flops, nbytes


def gru_fwd_counts(m: Dict, row_steps: int, scans: int, dtype: str
                   ) -> Tuple[float, float]:
    """Kernel 2 (2b): the recurrence of ``row_steps`` (row, step) pairs of
    one direction each, over ``scans`` scans: per row-step the (H) x
    (H, 3H) product; reads the input gates (3H), writes the state (H);
    each scan reads Uh and bh."""
    H = m["hidden_dim"]
    b = DTYPE_BYTES[dtype]
    flops = 2.0 * row_steps * H * 3 * H
    nbytes = row_steps * (3 * H * b + 4 + H * b) + scans * (3 * H * H + 3 * H) * 4
    return flops, nbytes


def gru_bwd_counts(m: Dict, row_steps: int, scans: int, dtype: str
                   ) -> Tuple[float, float]:
    """Kernel 3 (3b): the backward of the recurrence of ``row_steps``
    one-direction row-steps: per row-step the carry's (3H) x (3H, H)
    product and the weight grad's share, twice the forward's products;
    reads the states, the input gates and the incoming grads, writes the
    input gates' grads; each scan reads Uh and writes dUh and dbh."""
    H = m["hidden_dim"]
    b = DTYPE_BYTES[dtype]
    flops = 2.0 * 2 * row_steps * H * 3 * H
    nbytes = (row_steps * (H * b + 3 * H * b + H * 4 + 3 * H * 4 + 4)
              + scans * 2 * (3 * H * H + 3 * H) * 4)
    return flops, nbytes


def dec_scan_step_flops(m: Dict, T: int) -> int:
    """The decoder recurrence's products of one row-step with T source
    positions (the scan of kernels 4 and 5: GRU1's recurrent product, the
    query, the attention's scores and context, GRU2 and the readout's
    state and context terms; the time-parallel input products and the
    vocab projection run outside it)."""
    D, A, C, R = (m["dec_hidden_dim"], m["attn_dim"], 2 * m["hidden_dim"],
                  m["emb_dim"])
    return (2 * D * 3 * D + 2 * D * A + 2 * T * A + 2 * T * C
            + 2 * C * 3 * D + 2 * D * 3 * D + 2 * D * R + 2 * C * R)


def _dec_scan_weight_bytes(m: Dict, b: int) -> int:
    D, A, C, R = (m["dec_hidden_dim"], m["attn_dim"], 2 * m["hidden_dim"],
                  m["emb_dim"])
    return b * (D * 3 * D + D * A + C * 3 * D + D * 3 * D + D * R + C * R) \
        + 4 * (A + 3 * D * 2 + 3 * D)


def dec_scan_fwd_counts(m: Dict, pairs: Iterable[Tuple[int, int]],
                        scans: int, dtype: str) -> Tuple[float, float]:
    """Kernel 4 (4b) over real pairs (source length T, decoder steps Tt):
    the recurrence once (a backward's replay of it is recomputation, not
    work); reads each pair's context and its projection once, the input
    streams and writes the readout activations; each scan reads the
    weights."""
    D, A, C, R = (m["dec_hidden_dim"], m["attn_dim"], 2 * m["hidden_dim"],
                  m["emb_dim"])
    b = DTYPE_BYTES[dtype]
    flops = nbytes = 0.0
    for T, Tt in pairs:
        flops += Tt * dec_scan_step_flops(m, T)
        nbytes += T * (C * b + A * 4 + 4) + Tt * (3 * D * b + R * 4 + R * 4)
    return flops, nbytes + scans * _dec_scan_weight_bytes(m, b)


def dec_scan_bwd_counts(m: Dict, pairs: Iterable[Tuple[int, int]],
                        scans: int, dtype: str) -> Tuple[float, float]:
    """Kernel 5 (5b): the recurrence's backward, twice the forward's
    products (the grads of the activations and of the weights); reads the
    forward's residuals of each row-step and writes the input streams'
    grads; each scan reads the weights and writes their grads."""
    D, A, C, R = (m["dec_hidden_dim"], m["attn_dim"], 2 * m["hidden_dim"],
                  m["emb_dim"])
    b = DTYPE_BYTES[dtype]
    flops = nbytes = 0.0
    for T, Tt in pairs:
        flops += 2 * Tt * dec_scan_step_flops(m, T)
        nbytes += (T * (C * b + A * 4 + C * 4 + A * 4)
                   + Tt * (R * 4 + 3 * D * 4 + R * 4 + (2 * D + C) * b))
    return flops, nbytes + scans * 2 * _dec_scan_weight_bytes(m, b)
