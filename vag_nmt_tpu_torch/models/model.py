"""Model assembly (counterpart of the JAX package's ``models/model.py``):
parameter init and the weight bridge from the JAX parameter tree, the
joint training loss (cross-entropy + max-margin VSE), the per-batch decode
state (encoder, visual grounding, image-guided decoder init) and the fused
beam step.

Image-guided decoder init:  s0 = tanh(mean_ctx @ w_ctx + t_vec @ w_vis + b)
where ``t_vec`` is the grounding-attention summary; the text-only model
omits the ``w_vis`` term.

Parameters are nested dicts (and, for encoder layers, lists) of tensors
under the JAX package's own paths, in JAX's ``(in, out)`` layout.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vag_nmt_tpu_torch.core.config import ModelConfig
from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device, same_device
from vag_nmt_tpu_torch.core.knobs import decode_knobs
from vag_nmt_tpu_torch.models import decoder as dec
from vag_nmt_tpu_torch.models import encoder as enc
from vag_nmt_tpu_torch.models import vse
from vag_nmt_tpu_torch.models.layers import glorot_uniform, masked_mean
from vag_nmt_tpu_torch.ops.attention import precompute_ctx_proj
from vag_nmt_tpu_torch.ops.readout_topk import ban_mask, fused_readout_topk
from vag_nmt_tpu_torch.ops.topk import beam_topk

Params = Dict[str, Any]


class DecodeState(NamedTuple):
    """Everything the per-step decoder needs, computed once per batch."""
    ctx: torch.Tensor        # (B, T, C)
    ctx_proj: torch.Tensor   # (B, T, A)
    src_mask: torch.Tensor   # (B, T)
    s0: torch.Tensor         # (B, H)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: DeviceLike = None) -> Params:
    """Random parameters with the same tree, shapes and distributions as
    the JAX package's ``init_params`` (not the same numbers: the draws come
    from ``generator``). Drawn on the CPU, then moved to ``device``."""
    dev = resolve_device(device)
    p: Params = {
        "encoder": enc.init_encoder(generator, cfg),
        "decoder": dec.init_decoder(generator, cfg),
        "init": {
            "w_ctx": glorot_uniform(generator, (cfg.ctx_dim, cfg.dec_hidden_dim)),
            "b": torch.zeros((cfg.dec_hidden_dim,), dtype=torch.float32),
        },
    }
    if cfg.multimodal:
        p["vse"] = vse.init_vse(generator, cfg)
        p["init"]["w_vis"] = glorot_uniform(generator,
                                            (cfg.ctx_dim, cfg.dec_hidden_dim))
    return _tree_map(lambda x: x.to(dev), p)


def params_from_numpy(tree: Any, cfg: ModelConfig, *,
                      device: DeviceLike = None) -> Params:
    """The weight bridge: the JAX parameter tree as nested dicts/lists of
    numpy arrays under JAX's own paths (e.g. ``jax.device_get(params)``)
    -> the port's parameters. Strict: a missing or extra path, a list of
    the wrong length or a shape that differs from what ``cfg`` implies
    raises; every leaf is used."""
    dev = resolve_device(device)
    template = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def conv(tmpl, node, path):
        if isinstance(tmpl, dict):
            if not isinstance(node, dict):
                raise ValueError(f"{path or '/'}: expected a dict, got "
                                 f"{type(node).__name__}")
            missing = sorted(set(tmpl) - set(node))
            extra = sorted(set(node) - set(tmpl))
            if missing or extra:
                raise ValueError(f"{path or '/'}: missing {missing}, "
                                 f"unexpected {extra}")
            return {k: conv(tmpl[k], node[k], f"{path}/{k}") for k in tmpl}
        if isinstance(tmpl, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(tmpl):
                raise ValueError(f"{path}: expected a list of {len(tmpl)}")
            return [conv(t, n, f"{path}[{i}]")
                    for i, (t, n) in enumerate(zip(tmpl, node))]
        arr = np.asarray(node)
        if arr.shape != tuple(tmpl.shape):
            raise ValueError(f"{path}: shape {arr.shape}, expected "
                             f"{tuple(tmpl.shape)}")
        return torch.tensor(arr, dtype=torch.float32, device=dev)

    return conv(template, tree, "")


def _init_decoder_state(params: Params, cfg: ModelConfig, ctx: torch.Tensor,
                        src_mask: torch.Tensor,
                        t_vec: Optional[torch.Tensor]) -> torch.Tensor:
    pre = masked_mean(ctx, src_mask) @ params["init"]["w_ctx"]
    if cfg.multimodal and t_vec is not None:
        pre = pre + t_vec @ params["init"]["w_vis"]
    return torch.tanh(pre + params["init"]["b"]).to(ctx.dtype)


def _encode_and_ground(params: Params, cfg: ModelConfig,
                       batch: Dict[str, torch.Tensor], *, train: bool,
                       generator: Optional[torch.Generator] = None,
                       impl: Optional[str] = None):
    """Encoder, image embedding + grounding and decoder init on tensors
    already on the params' device. Returns (ctx, s0, img_emb, txt_emb)."""
    src_mask = batch["src_mask"]
    ctx = enc.encode(params["encoder"], cfg, batch["src"].long(), src_mask,
                     impl=impl, train=train, generator=generator)
    img_emb = txt_emb = t_vec = None
    if cfg.multimodal:
        img_emb = vse.image_embedding(params["vse"], batch["img"].to(ctx.dtype))
        txt_emb, t_vec, _ = vse.ground(params["vse"], img_emb, ctx, src_mask)
    s0 = _init_decoder_state(params, cfg, ctx, src_mask, t_vec)
    return ctx, s0, img_emb, txt_emb


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator] = None, *,
            train: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Joint loss L = CE + vse_weight * VSE; returns (loss, aux) with aux
    keys ce, acc, ntokens, loss and, multimodal, vse (0-dim tensors on the
    params' device).

    batch (tensors on the params' device): src (B, T) int, src_mask (B, T),
    tgt_in (B, Tt) int starting with <sos>, tgt_out (B, Tt) ending with
    <eos>, tgt_mask (B, Tt); img (B, F) when cfg.multimodal; optional
    sample_mask (B,). Dropout (train=True) draws from ``generator``: the
    encoder's first, then the decoder's."""
    ctx, s0, img_emb, txt_emb = _encode_and_ground(
        params, cfg, batch, train=train, generator=generator)
    logits = dec.teacher_forced_logits(
        params["decoder"], cfg, batch["tgt_in"].long(), s0, ctx,
        batch["src_mask"], train=train, generator=generator)
    tgt_out = batch["tgt_out"].long()
    logp = torch.log_softmax(logits, dim=-1)
    tgt_logp = torch.gather(logp, -1, tgt_out[..., None])[..., 0]
    tmask = batch["tgt_mask"].to(torch.float32)
    ntok = tmask.sum().clamp_min(1.0)
    ce = -(tgt_logp * tmask).sum() / ntok
    acc = ((logits.argmax(-1) == tgt_out) * tmask).sum() / ntok
    aux = {"ce": ce, "acc": acc, "ntokens": tmask.sum()}
    total = ce
    if cfg.multimodal:
        vse_l = vse.max_margin_loss(img_emb, txt_emb, cfg.vse_margin,
                                    cfg.vse_hard_negatives,
                                    sample_mask=batch.get("sample_mask"))
        total = ce + cfg.vse_weight * vse_l
        aux["vse"] = vse_l
    aux["loss"] = total
    return total, aux


def prepare_decode(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
                   device: DeviceLike = None,
                   impl: Optional[str] = None) -> DecodeState:
    """Encode once per batch: encoder, image embedding + grounding, decoder
    init and the attention's context projection. batch: src (B, T) int,
    src_mask (B, T) float, img (B, F) when cfg.multimodal (tensors or numpy
    arrays; moved to ``device``). impl: the encoder GRU scan's impl (None =
    cfg.gru_impl)."""
    dev = resolve_device(device)
    same_device(dev, params["decoder"]["embed"]["table"], "params")
    src_mask = torch.as_tensor(batch["src_mask"], device=dev).to(torch.float32)
    b = {"src": torch.as_tensor(batch["src"], device=dev).long(),
         "src_mask": src_mask}
    if cfg.multimodal:
        b["img"] = torch.as_tensor(batch["img"], device=dev)
    ctx, s0, _, _ = _encode_and_ground(params, cfg, b, train=False, impl=impl)
    return DecodeState(
        ctx=ctx,
        ctx_proj=precompute_ctx_proj(params["decoder"]["attn"], ctx),
        src_mask=src_mask,
        s0=s0,
    )


def decode_step(params: Params, cfg: ModelConfig, tok: torch.Tensor,
                s: torch.Tensor, state: DecodeState,
                tables: Optional[dec.Tables] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (s_new (B, K, H), fp32 logits (B, K, V))."""
    s_new, logits, _ = dec.decode_step_beams(
        params["decoder"], cfg, tok, s, state.ctx, state.ctx_proj,
        state.src_mask, tables)
    return s_new, logits


def decode_step_topk(
    params: Params,
    cfg: ModelConfig,
    tok: torch.Tensor,        # (B, K) previous tokens
    s: torch.Tensor,          # (B, K, H)
    state: DecodeState,
    scores: torch.Tensor,     # (B, K) fp32 running beam scores
    finished: torch.Tensor,   # (B, K) bool
    *,
    impl: str = "auto",
    tables: Optional[dec.Tables] = None,
    ban: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One beam step fused with candidate scoring + top-K: returns
    (s_new (B, K, H), top_scores (B, K), flat_idx (B, K), flat =
    beam * V + token), with ops/topk.beam_topk's candidate semantics.

    impl: the step's structure and kernels. "fused" or "unfused" names the
    structure; "auto", "kernel" or "plain" names the kernels (auto: kernels
    for CUDA tensors, plain versions for CPU tensors) and takes the
    structure from VAG_READOUT_TOPK (core/knobs.py; default fused). Fused:
    the vocab projection runs inside ops/readout_topk.fused_readout_topk,
    and with the decode tables and VAG_DEC_STEP=on the mid-section is the
    fused step (ops/dec_step). Unfused: the logits are materialized, the
    ban is scattered to -1e9 and ops/topk.beam_topk takes the top-K (its
    kernel per VAG_TOPK_IMPL), as the JAX package's unfused path.

    ban: optional (B, K, M) banned ids for no-repeat n-gram blocking (id V
    is the "no ban" sentinel and is dropped). Banned mass is excluded from
    the softmax normalization on both paths."""
    if impl in ("fused", "unfused"):
        structure, impl = impl, "auto"
    else:
        structure = decode_knobs().readout_topk
    if structure == "unfused":
        s_new, logits = decode_step(params, cfg, tok, s, state, tables)
        if ban is not None:
            Bk, Kk, Vk = logits.shape
            flat = logits.reshape(Bk * Kk, Vk)
            mask = ban_mask(ban.reshape(Bk * Kk, -1), Vk).bool()
            flat = torch.where(mask, flat.clamp_max(-1e9), flat)
            logits = flat.reshape(Bk, Kk, Vk)
        top_scores, idx = beam_topk(logits, scores, finished, impl=impl)
        return s_new, top_scores, idx
    s_new, t, w_out, b_out = dec.decode_step_beams_readout(
        params["decoder"], cfg, tok, s, state.ctx, state.ctx_proj,
        state.src_mask, tables, impl=impl)
    top_scores, idx = fused_readout_topk(
        t, w_out, b_out, scores, finished,
        None if ban is None else ban.reshape(t.shape[0], -1), impl=impl)
    return s_new, top_scores, idx
