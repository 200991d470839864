"""Analytic FLOP and byte accounting (own copy of the JAX package's
``core/flops.py``, with the H100 SXM's peaks beside the v5e's).

Counts matmul FLOPs (2*m*k*n) mirroring the model code paths exactly:
models/encoder.py (bidirectional GRU layers), models/decoder.py
(step_from_xgates / decode_step_beams), ops/attention.py (hoisted ctx_proj +
per-step query/score/weighted-sum), models/vse.py (projection + grounding),
models/model.py (decoder init). Elementwise/softmax work is ignored — it is
<2% of the matmul FLOPs at these shapes.

Peak numbers: TPU v5e ≈ 197 TFLOP/s bf16, ≈ 819 GB/s HBM (public spec);
H100 SXM 67 TFLOP/s fp32 outside the tensor cores, 495 TFLOP/s TF32 and
989 TFLOP/s bf16 on the tensor cores (dense), 3.35 TB/s HBM (NVIDIA data
sheet, at the full 700 W power limit).

``roofline`` takes both peaks as arguments, with no default: the roof a
decode sits under depends on the dtype it resolves to (fp32 products on
the tensor cores in 3xTF32, or bf16), where the JAX package defaults to
the v5e's bf16 peak."""

from __future__ import annotations

from typing import Dict

from vag_nmt_tpu_torch.core.config import Config, ModelConfig

V5E_PEAK_BF16_FLOPS = 197.0e12
V5E_PEAK_FP32_FLOPS = 98.5e12        # bf16 rate / 2 (fp32 via 2x-pass)
V5E_HBM_BYTES_PER_S = 819.0e9
H100_PEAK_FP32_FLOPS = 67e12         # outside the tensor cores
H100_PEAK_TF32_FLOPS = 495e12        # tensor cores, dense
H100_PEAK_BF16_FLOPS = 989e12        # tensor cores, dense
H100_HBM_BYTES_PER_S = 3.35e12


def _gru_dir_flops(in_dim: int, hidden: int, T: int) -> int:
    """One direction of a GRU over T steps, one row: time-parallel input
    gates (T,in)->(T,3H) plus T recurrent (H)->(3H) matmuls."""
    return 2 * T * in_dim * 3 * hidden + 2 * T * hidden * 3 * hidden


def encoder_flops(m: ModelConfig, T: int) -> int:
    """Per sentence: enc_layers bidirectional GRU layers (models/encoder.py;
    layer 0 consumes embeddings, later layers the (T, 2H) output)."""
    total = 0
    for layer in range(m.enc_layers):
        in_dim = m.emb_dim if layer == 0 else m.ctx_dim
        total += 2 * _gru_dir_flops(in_dim, m.hidden_dim, T)
    return total


def prepare_flops(m: ModelConfig, T: int) -> int:
    """Per sentence: encode + decoder ctx_proj hoist + (multimodal) image
    projection, visual grounding attention, txt projection + decoder init."""
    C, A, D, S = m.ctx_dim, m.attn_dim, m.dec_hidden_dim, m.shared_dim
    f = encoder_flops(m, T)
    f += 2 * T * C * A                      # decoder attention ctx_proj
    f += 2 * C * D                          # init: mean_ctx @ w_ctx
    if m.multimodal:
        f += 2 * m.img_feat_dim * S         # image_embedding
        f += 2 * T * C * A + 2 * S * A + 2 * T * A + 2 * T * C  # ground attn
        f += 2 * C * S                      # txt_proj
        f += 2 * C * D                      # init: t_vec @ w_vis
    return f


def decode_step_flops(m: ModelConfig, T: int) -> int:
    """One decoder step for ONE row (a beam entry or a greedy sentence):
    GRU1, Bahdanau attention (query/scores/weighted sum), GRU2, readout."""
    E, D, A, C = m.emb_dim, m.dec_hidden_dim, m.attn_dim, m.ctx_dim
    R, V = m.emb_dim, m.tgt_vocab_size
    return (2 * E * 3 * D + 2 * D * 3 * D          # gru1 x-gates + recurrent
            + 2 * D * A + 2 * T * A + 2 * T * C    # attention
            + 2 * C * 3 * D + 2 * D * 3 * D        # gru2
            + 2 * (E * R + D * R + C * R)          # readout tanh inputs
            + 2 * R * V)                           # output projection


def train_step_flops(cfg: Config, B: int, T: int, Tt: int) -> int:
    """Forward+backward for one (B, T)->(B, Tt) batch: backward of a matmul
    chain costs 2x forward, so total = 3x forward (standard accounting)."""
    m = cfg.model
    fwd = B * (prepare_flops(m, T) + Tt * decode_step_flops(m, T))
    if m.multimodal:
        fwd += 2 * B * B * m.shared_dim        # VSE similarity matrix
    return 3 * fwd


def decode_flops(cfg: Config, n_sentences: int, beam_size: int, T: int,
                 steps_per_sentence: float) -> float:
    """Whole-corpus beam decode: per-sentence prepare + executed loop steps
    x (beam rows x step). ``steps_per_sentence`` should be the realized
    loop trips (chunk max hypothesis lengths), not max_len."""
    m = cfg.model
    return n_sentences * (prepare_flops(m, T)
                          + steps_per_sentence * beam_size
                          * decode_step_flops(m, T))


def param_count(m: ModelConfig) -> int:
    """Matmul-weight parameter count along the decode path (embeddings and
    biases excluded: gathers and adds stream through no product)."""
    E, H, D, A, C = (m.emb_dim, m.hidden_dim, m.dec_hidden_dim, m.attn_dim,
                     m.ctx_dim)
    R, V = m.emb_dim, m.tgt_vocab_size
    n = 0
    for layer in range(m.enc_layers):
        in_dim = E if layer == 0 else C
        n += 2 * (in_dim * 3 * H + H * 3 * H)
    n += C * A + D * A + A                      # decoder attention
    n += E * 3 * D + D * 3 * D + C * 3 * D + D * 3 * D
    n += E * R + D * R + C * R + R * V
    return n


def decode_step_bytes(m: ModelConfig, rows: int, T: int,
                      dtype_bytes: int = 2) -> int:
    """Memory traffic of one decode step: the whole weight set once (the
    loop is sequential, no reuse across steps) plus each row's attention
    reads of ctx (T, C) and ctx_proj (T, A)."""
    weights = param_count(m) * dtype_bytes
    acts = rows * T * (m.ctx_dim + m.attn_dim) * dtype_bytes
    return weights + acts


def roofline(achieved_flops_per_s: float, bytes_per_s: float,
             peak_flops: float, peak_bytes: float) -> Dict[str, float]:
    """Compute utilization ("mfu"), memory utilization ("hbm_util") and
    the roof that binds ("bound"): the higher utilization's ("mxu" for
    compute, "hbm" for memory) when it reaches 0.5, or exceeds 0.15 and
    twice the other, else "latency"."""
    mfu = achieved_flops_per_s / peak_flops
    hbm = bytes_per_s / peak_bytes
    hi, lo, hi_name = ((mfu, hbm, "mxu") if mfu >= hbm else (hbm, mfu, "hbm"))
    if hi >= 0.5 or (hi > 2 * lo and hi > 0.15):
        bound = hi_name
    else:
        bound = "latency"
    return {"mfu": mfu, "hbm_util": hbm, "bound": bound}
