"""Conditional-GRU attention decoder (counterpart of the JAX package's
``models/decoder.py``).

dl4mt-style two-cell step: GRU1 on the target embedding, masked Bahdanau
attention queried by the intermediate state, GRU2 on the attention context,
then a tanh readout ``t``. In decoding the vocab projection of ``t`` runs
either here (``decode_step_beams``, logits materialized) or fused with the
top-K (``decode_step_beams_readout`` + ops/readout_topk; with the decode
tables and ``VAG_DEC_STEP=on`` its mid-section is one fused step,
ops/dec_step). In training, ``teacher_forced_logits`` hoists the
token-parallel GEMMs out of the recurrence, runs the recurrence as one
``ops/dec_scan.decoder_scan`` and the vocab projection as one GEMM after
it."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from vag_nmt_tpu_torch.core.config import ModelConfig
from vag_nmt_tpu_torch.core.knobs import decode_knobs
from vag_nmt_tpu_torch.models.layers import (
    dropout,
    embed,
    glorot_uniform,
    init_embedding,
    mm,
)
from vag_nmt_tpu_torch.ops.attention import (
    bahdanau_attend,
    bahdanau_attend_beams,
    bahdanau_attend_beams_q,
    init_attention_params,
    precompute_ctx_proj,
)
from vag_nmt_tpu_torch.ops.dec_scan import decoder_scan
from vag_nmt_tpu_torch.ops.dec_step import decode_step_fused
from vag_nmt_tpu_torch.ops.gru import (
    gru_cell_from_gates,
    gru_cell_from_xgates,
    gru_gates_from_x,
    init_gru_params,
)
from vag_nmt_tpu_torch.parallel.tensor import VocabShard, copy_to_model

Tables = Dict[str, torch.Tensor]


def init_decoder(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    H, C, E, R = cfg.dec_hidden_dim, cfg.ctx_dim, cfg.emb_dim, cfg.emb_dim
    p: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.tgt_vocab_size, E),
        "gru1": init_gru_params(gen, E, H),
        "attn": init_attention_params(gen, C, H, cfg.attn_dim),
        "gru2": init_gru_params(gen, C, H),
        "readout": {
            "wy": glorot_uniform(gen, (E, R)),
            "ws": glorot_uniform(gen, (H, R)),
            "wc": glorot_uniform(gen, (C, R)),
            "b": torch.zeros((R,), dtype=torch.float32),
            "b_out": torch.zeros((cfg.tgt_vocab_size,), dtype=torch.float32),
        },
    }
    if not cfg.tied_readout_embedding:
        p["readout"]["w_out"] = glorot_uniform(gen, (R, cfg.tgt_vocab_size))
    return p


def _out_matrix(params: Dict[str, Any], cfg: ModelConfig) -> torch.Tensor:
    if cfg.tied_readout_embedding:
        return params["embed"]["table"].T  # (E, V)
    return params["readout"]["w_out"]


def decode_tables(params: Dict[str, Any], *,
                  w_out_bf16: bool = False,
                  vocab: Optional[VocabShard] = None) -> Tables:
    """Per-vocab decode tables: GRU1's input gates and the readout's y-term
    depend only on the previous token, so they are computed once over the
    whole vocab and the per-step embed -> matmul chains become one row
    gather. The two concatenated weight matrices fuse the remaining per-step
    GEMMs pairwise (same input rows, same per-column dot products):
      gy  = [embed @ wi1 + bi1 | embed @ wy]   (V, 3H + R)
      w_s = [ua | uh2]                          (H, A + 3H)
      w_c = [wi2 | wc]                          (C, 3H + R)
    gy is fp32, w_s and w_c keep the params' dtype. With w_out_bf16 (the
    decode's ``DecodeOpts.readout_bf16``: ``VAG_FRT_GEMM_DTYPE=bf16``) and
    fp32 params the tables also carry "w_out", the output matrix cast to
    bf16 once for the fused readout top-K (the JAX package's cast hoisted
    out of its beam loop).

    vocab (tensor parallelism): the params hold this rank's slice of the
    target vocab, so ``gy`` holds the slice's rows (a step gathers them
    through ``vocab_embed``); a tied output matrix, the slice's columns
    of the embedding's transpose, is made contiguous here once."""
    emb = params["embed"]["table"]
    tables = {
        "gy": torch.cat([gru_gates_from_x(params["gru1"], emb),
                         mm(emb, params["readout"]["wy"])], dim=1),
        "w_s": torch.cat([params["attn"]["ua"], params["gru2"]["uh"]], dim=1),
        "w_c": torch.cat([params["gru2"]["wi"], params["readout"]["wc"]], dim=1),
    }
    r = params["readout"]
    w_out = r["w_out"] if "w_out" in r else emb.T
    if w_out_bf16 and w_out.dtype == torch.float32:
        tables["w_out"] = w_out.to(torch.bfloat16).contiguous()
    elif vocab is not None and "w_out" not in r:
        tables["w_out"] = w_out.contiguous()
    return tables


def _readout_t(
    params: Dict[str, Any],
    ty: torch.Tensor,         # (N, R) precomputed y-term (y_emb @ wy)
    s_new: torch.Tensor,      # (N, H)
    c: torch.Tensor,          # (N, C)
    tc: Optional[torch.Tensor] = None,  # (N, R) precomputed c @ wc
) -> torch.Tensor:
    """Readout activations t = tanh(ty + s@ws + c@wc + b)."""
    r = params["readout"]
    if tc is None:
        tc = mm(c, r["wc"])
    return torch.tanh(ty + mm(s_new, r["ws"]) + tc + r["b"])


def step_acts_from_xgates(
    params: Dict[str, Any],
    ty: torch.Tensor,         # (N, R) precomputed readout y-term (y @ wy)
    xg1: torch.Tensor,        # (N, 3H) precomputed GRU1 input gates
    s: torch.Tensor,          # (N, H)
    ctx: torch.Tensor,        # (N, T, C)
    ctx_proj: torch.Tensor,   # (N, T, A)
    src_mask: torch.Tensor,   # (N, T)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder step up to the readout activations (pre-dropout, pre
    vocab GEMM): the per-step oracle of the teacher-forced scan. Returns
    (s_new (N, H), t (N, R), attn (N, T))."""
    s_tilde = gru_cell_from_xgates(params["gru1"], xg1, s)
    c, w = bahdanau_attend(params["attn"], s_tilde, ctx, ctx_proj, src_mask)
    s_new = gru_cell_from_xgates(
        params["gru2"], gru_gates_from_x(params["gru2"], c), s_tilde)
    return s_new, _readout_t(params, ty, s_new, c), w


def _beams_step_core(
    params: Dict[str, Any],
    tok: torch.Tensor,        # (B, K)
    s: torch.Tensor,          # (B, K, H)
    ctx: torch.Tensor,
    ctx_proj: torch.Tensor,
    src_mask: torch.Tensor,
    tables: Optional[Tables] = None,
    attn_bf16: Optional[bool] = None,
    vocab: Optional[VocabShard] = None,
):
    """Shared GRU1 -> attention -> GRU2 body of a beam decoder step.
    Returns (s_new (B*K, H), ty (B*K, R), c_flat (B*K, C), tc (B*K, R) or
    None, attn (B, K, T)). attn_bf16: the attention's energies in bf16
    (None: under a bf16 ctx; ops/attention.py). vocab: the target vocab's
    slice under tensor parallelism (the token rows through
    ``vocab_embed``)."""
    B, K = tok.shape
    H = s.shape[-1]
    flat_tok = tok.reshape(-1)
    if tables is None:
        y = embed(params["embed"], flat_tok, vocab).to(ctx.dtype)
        xg1 = gru_gates_from_x(params["gru1"], y)
        ty = mm(y, params["readout"]["wy"])
    else:
        gy = embed({"table": tables["gy"]}, flat_tok, vocab)
        xg1, ty = gy[:, :3 * H], gy[:, 3 * H:]
    s_tilde = gru_cell_from_xgates(params["gru1"], xg1, s.reshape(B * K, H))
    if tables is not None:
        A = params["attn"]["ua"].shape[1]
        g2 = params["gru2"]
        qh = mm(s_tilde, tables["w_s"])                  # (B*K, A+3H)
        c, w = bahdanau_attend_beams_q(
            params["attn"], qh[:, :A].reshape(B, K, A), ctx, ctx_proj,
            src_mask, bf16_energies=attn_bf16)
        c_flat = c.reshape(B * K, -1)
        xc = mm(c_flat, tables["w_c"])                   # (B*K, 3H+R)
        s_new = gru_cell_from_gates(xc[:, :3 * H] + g2["bi"],
                                    qh[:, A:] + g2["bh"], s_tilde)
        tc = xc[:, 3 * H:]
    else:
        c, w = bahdanau_attend_beams(params["attn"], s_tilde.reshape(B, K, H),
                                     ctx, ctx_proj, src_mask,
                                     bf16_energies=attn_bf16)
        c_flat = c.reshape(B * K, -1)
        s_new = gru_cell_from_xgates(
            params["gru2"], gru_gates_from_x(params["gru2"], c_flat), s_tilde)
        tc = None
    return s_new, ty, c_flat, tc, w


def decode_step_beams(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tok: torch.Tensor,        # (B, K) previous tokens, K beams/sentence
    s: torch.Tensor,          # (B, K, H)
    ctx: torch.Tensor,        # (B, T, C), not tiled across beams
    ctx_proj: torch.Tensor,   # (B, T, A)
    src_mask: torch.Tensor,   # (B, T)
    tables: Optional[Tables] = None,
    *,
    attn_bf16: Optional[bool] = None,
    vocab: Optional[VocabShard] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder step for K beams per sentence sharing the encoder state.
    Returns (s_new (B, K, H), logits (B, K, V) fp32, attn (B, K, T)); with
    a vocab slice (tensor parallelism) the logits of the slice, (B, K,
    v1 - v0)."""
    B, K = tok.shape
    H = s.shape[-1]
    s_new, ty, c_flat, tc, w = _beams_step_core(params, tok, s, ctx, ctx_proj,
                                                src_mask, tables, attn_bf16,
                                                vocab)
    t = _readout_t(params, ty, s_new, c_flat, tc=tc)
    logits = (mm(t.to(c_flat.dtype), _out_matrix(params, cfg))
              + params["readout"]["b_out"]).to(torch.float32)
    return s_new.reshape(B, K, H), logits.reshape(B, K, -1), w


def decode_step_beams_readout(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tok: torch.Tensor,        # (B, K)
    s: torch.Tensor,          # (B, K, H)
    ctx: torch.Tensor,
    ctx_proj: torch.Tensor,
    src_mask: torch.Tensor,
    tables: Optional[Tables] = None,
    *,
    dec_step: Optional[bool] = None,
    impl: str = "auto",
    attn_bf16: Optional[bool] = None,
    vocab: Optional[VocabShard] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam decoder step stopping at the readout activations: returns
    (s_new (B, K, H), t (B*K, R) in ctx's dtype, w_out (R, V), b_out (V,)
    fp32) so the vocab projection can run fused with the top-K
    (ops/readout_topk).

    With tables and dec_step (None: VAG_DEC_STEP, default off) the whole
    mid-section runs as one call of the fused step
    (ops/dec_step.decode_step_fused; impl: "auto", "kernel" or "plain"),
    as the JAX package's tabled step does with VAG_DEC_STEP=on. attn_bf16:
    the attention's energies in bf16 (None: under a bf16 ctx). vocab: the
    target vocab's slice under tensor parallelism (w_out and b_out are
    the slice's)."""
    B, K = tok.shape
    H = s.shape[-1]
    if dec_step is None:
        dec_step = decode_knobs().dec_step
    w_out = (tables["w_out"] if tables is not None and "w_out" in tables
             else _out_matrix(params, cfg))
    b_out = params["readout"]["b_out"].to(torch.float32)
    if tables is not None and dec_step:
        s_new3, t = decode_step_fused(params, tables, tok, s, ctx, ctx_proj,
                                      src_mask, impl=impl, vocab=vocab)
        return s_new3, t.to(ctx.dtype), w_out, b_out
    s_new, ty, c_flat, tc, _ = _beams_step_core(params, tok, s, ctx, ctx_proj,
                                                src_mask, tables, attn_bf16,
                                                vocab)
    t = _readout_t(params, ty, s_new, c_flat, tc=tc)
    return s_new.reshape(B, K, H), t.to(c_flat.dtype), w_out, b_out


def teacher_forced_logits(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tgt_in: torch.Tensor,     # (B, Tt) int, starts with <sos>
    s0: torch.Tensor,         # (B, H)
    ctx: torch.Tensor,        # (B, T, C)
    src_mask: torch.Tensor,   # (B, T)
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    vocab: Optional[VocabShard] = None,
) -> torch.Tensor:
    """Logits for every target position, (B, Tt, V) fp32. The GRU1 input
    gates and the readout y-term run time-parallel before the scan, the
    (R, V) vocab projection as one (B*Tt, R) GEMM after it. In training
    (train=True with a generator) dropout applies to the target embeddings
    and to the stacked readout activations, drawn in that order. The scan
    runs per cfg.dec_scan_impl: "auto" (kernels for CUDA tensors, plain for
    CPU tensors), "pallas" (the kernels) or "xla" (the plain versions),
    with or without grad (the JAX package's "kernel when training or
    bf16": the port takes the kernels in fp32 eval too). Under bf16 (ctx
    bf16) the embeddings are bf16, the scan streams bf16
    (``ops/dec_scan.decoder_scan``) and the vocab GEMM takes t_all rounded
    to bf16, as in the JAX package; the logits are fp32. vocab (tensor
    parallelism): the params hold this rank's slice of the target vocab;
    the logits are the slice's, (B, Tt, v1 - v0), and t_all enters the
    slice's GEMM through ``copy_to_model`` (its grad summed over the
    model group)."""
    y = embed(params["embed"], tgt_in, vocab).to(ctx.dtype)   # (B, Tt, E)
    y = dropout(generator, y, cfg.dropout, train)
    xg1 = gru_gates_from_x(params["gru1"], y)                 # (B, Tt, 3H)
    ty = mm(y, params["readout"]["wy"])                       # (B, Tt, R)
    ctx_proj = precompute_ctx_proj(params["attn"], ctx)
    t_all = decoder_scan(params, ty, xg1, s0, ctx, ctx_proj, src_mask,
                         impl=cfg.dec_scan_impl)
    t_all = dropout(generator, t_all, cfg.dropout, train)
    if vocab is not None:
        t_all = copy_to_model(t_all, vocab.mesh)
    return (mm(t_all.to(ctx.dtype), _out_matrix(params, cfg))
            + params["readout"]["b_out"])
