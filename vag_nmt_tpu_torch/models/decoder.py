"""Conditional-GRU attention decoder, decode side (counterpart of the JAX
package's ``models/decoder.py``).

dl4mt-style two-cell step: GRU1 on the target embedding, masked Bahdanau
attention queried by the intermediate state, GRU2 on the attention context,
then a tanh readout ``t``; the vocab projection of ``t`` runs either here
(``decode_step_beams``, logits materialized) or fused with the top-K
(``decode_step_beams_readout`` + ops/readout_topk). The teacher-forced
training scan waits for the training slice."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from vag_nmt_tpu_torch.core.config import ModelConfig
from vag_nmt_tpu_torch.models.layers import embed, glorot_uniform, init_embedding
from vag_nmt_tpu_torch.ops.attention import (
    bahdanau_attend_beams,
    bahdanau_attend_beams_q,
    init_attention_params,
)
from vag_nmt_tpu_torch.ops.gru import (
    gru_cell_from_gates,
    gru_cell_from_xgates,
    gru_gates_from_x,
    init_gru_params,
)

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


def decode_tables(params: Dict[str, Any]) -> Tables:
    """Per-vocab decode tables: GRU1's input gates and the readout's y-term
    depend only on the previous token, so they are computed once over the
    whole vocab and the per-step embed -> matmul chains become one row
    gather. The two concatenated weight matrices fuse the remaining per-step
    GEMMs pairwise (same input rows, same per-column dot products):
      gy  = [embed @ wi1 + bi1 | embed @ wy]   (V, 3H + R)
      w_s = [ua | uh2]                          (H, A + 3H)
      w_c = [wi2 | wc]                          (C, 3H + R)"""
    emb = params["embed"]["table"]
    return {
        "gy": torch.cat([gru_gates_from_x(params["gru1"], emb),
                         emb @ params["readout"]["wy"]], dim=1),
        "w_s": torch.cat([params["attn"]["ua"], params["gru2"]["uh"]], dim=1),
        "w_c": torch.cat([params["gru2"]["wi"], params["readout"]["wc"]], dim=1),
    }


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
        tc = c @ r["wc"]
    return torch.tanh(ty + s_new @ r["ws"] + tc + r["b"])


def _beams_step_core(
    params: Dict[str, Any],
    tok: torch.Tensor,        # (B, K)
    s: torch.Tensor,          # (B, K, H)
    ctx: torch.Tensor,
    ctx_proj: torch.Tensor,
    src_mask: torch.Tensor,
    tables: Optional[Tables] = None,
):
    """Shared GRU1 -> attention -> GRU2 body of a beam decoder step.
    Returns (s_new (B*K, H), ty (B*K, R), c_flat (B*K, C), tc (B*K, R) or
    None, attn (B, K, T))."""
    B, K = tok.shape
    H = s.shape[-1]
    flat_tok = tok.reshape(-1)
    if tables is None:
        y = embed(params["embed"], flat_tok).to(ctx.dtype)
        xg1 = gru_gates_from_x(params["gru1"], y)
        ty = y @ params["readout"]["wy"]
    else:
        gy = tables["gy"][flat_tok]
        xg1, ty = gy[:, :3 * H], gy[:, 3 * H:]
    s_tilde = gru_cell_from_xgates(params["gru1"], xg1, s.reshape(B * K, H))
    if tables is not None:
        A = params["attn"]["ua"].shape[1]
        g2 = params["gru2"]
        qh = s_tilde @ tables["w_s"]                      # (B*K, A+3H)
        c, w = bahdanau_attend_beams_q(
            params["attn"], qh[:, :A].reshape(B, K, A), ctx, ctx_proj,
            src_mask)
        c_flat = c.reshape(B * K, -1)
        xc = c_flat @ tables["w_c"]                       # (B*K, 3H+R)
        s_new = gru_cell_from_gates(xc[:, :3 * H] + g2["bi"],
                                    qh[:, A:] + g2["bh"], s_tilde)
        tc = xc[:, 3 * H:]
    else:
        c, w = bahdanau_attend_beams(params["attn"], s_tilde.reshape(B, K, H),
                                     ctx, ctx_proj, src_mask)
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder step for K beams per sentence sharing the encoder state.
    Returns (s_new (B, K, H), logits (B, K, V) fp32, attn (B, K, T))."""
    B, K = tok.shape
    H = s.shape[-1]
    s_new, ty, c_flat, tc, w = _beams_step_core(params, tok, s, ctx, ctx_proj,
                                                src_mask, tables)
    t = _readout_t(params, ty, s_new, c_flat, tc=tc)
    logits = t @ _out_matrix(params, cfg) + params["readout"]["b_out"]
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam decoder step stopping at the readout activations: returns
    (s_new (B, K, H), t (B*K, R), w_out (R, V), b_out (V,)) so the vocab
    projection can run fused with the top-K (ops/readout_topk)."""
    B, K = tok.shape
    H = s.shape[-1]
    s_new, ty, c_flat, tc, _ = _beams_step_core(params, tok, s, ctx, ctx_proj,
                                                src_mask, tables)
    t = _readout_t(params, ty, s_new, c_flat, tc=tc)
    return (s_new.reshape(B, K, H), t, _out_matrix(params, cfg),
            params["readout"]["b_out"])
