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

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from vag_nmt_tpu_torch.core.config import ModelConfig
from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device, same_device
from vag_nmt_tpu_torch.core.knobs import decode_knobs
from vag_nmt_tpu_torch.models import decoder as dec
from vag_nmt_tpu_torch.models import encoder as enc
from vag_nmt_tpu_torch.models import vse
from vag_nmt_tpu_torch.models.layers import (RowDraws, glorot_uniform,
                                             masked_mean, mm)
from vag_nmt_tpu_torch.ops.attention import precompute_ctx_proj
from vag_nmt_tpu_torch.ops.readout_topk import ban_mask, fused_readout_topk
from vag_nmt_tpu_torch.ops.topk import beam_topk
from vag_nmt_tpu_torch.parallel.sharding import (BatchShard, Mesh, shard_tree,
                                                 tp_mesh)
from vag_nmt_tpu_torch.parallel.tensor import (
    gather_logits,
    vocab_parallel_argmax,
    vocab_parallel_log_softmax_target,
    vocab_shard,
)

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


def cast_floats(tree, dtype: torch.dtype):
    """Every floating leaf cast to ``dtype``, integer leaves untouched (the
    JAX package's ``utils/pytree.cast_floats``). A bf16 decode casts its
    params once per decode call; a leaf already of ``dtype`` is returned
    as it is."""
    return _tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                     tree)


class DecodeOpts(NamedTuple):
    """A decode call's step choices, resolved once (``decode_opts``) and
    passed down with the tables."""
    structure: str       # "fused" | "unfused" (VAG_READOUT_TOPK)
    dec_step: bool       # the fused mid-section, kernel 7 (VAG_DEC_STEP)
    attn_bf16: bool      # the beam attention's energies in bf16
    readout_bf16: bool   # the fused readout's GEMM on bf16 t and W
    tp: Optional[Mesh] = None   # a mesh with a model axis: vocab slices


def decode_opts(dtype: torch.dtype, mesh: Optional[Mesh] = None
                ) -> DecodeOpts:
    """The step choices of a decode at ``dtype`` under the selection
    variables (``core/knobs.py``), read once: the energies in bf16 under
    bf16 unless ``VAG_ATTN_E_DTYPE=fp32``, or with ``=bf16``; the readout's
    GEMM in bf16 under bf16 or with ``VAG_FRT_GEMM_DTYPE=bf16``. mesh:
    the decode's mesh; with a model axis (tensor parallelism) the params
    hold vocab slices and the steps take them as such (``tp``)."""
    kn = decode_knobs()
    bf = dtype == torch.bfloat16
    return DecodeOpts(
        structure=kn.readout_topk, dec_step=kn.dec_step,
        attn_bf16=(bf and kn.attn_e_dtype != "fp32")
        or kn.attn_e_dtype == "bf16",
        readout_bf16=bf or kn.frt_gemm_bf16,
        tp=tp_mesh(mesh))


# The decoder leaves a bf16 decode's step reads in bf16: the embedding
# rows (gathered), the bf16 energies' ba and va, the fused readout's output
# matrix (kernel 1b) and, with the fused step, kernel 7b's matrices (w_s
# and w_c are built from ua | gru2.uh and gru2.wi | readout.wc).
_EMBED = (("embed", "table"),)
_ENERGIES = (("attn", "ba"), ("attn", "va"))
_READOUT_MATRIX = (("readout", "w_out"),)
_DEC_STEP_MATRICES = (("gru1", "uh"), ("attn", "ua"), ("gru2", "uh"),
                      ("gru2", "wi"), ("readout", "wc"), ("readout", "ws"))


def decode_params(params: Params, cfg: ModelConfig, opts: DecodeOpts, *,
                  beam: bool, tables: bool) -> Params:
    """The params a bf16 decode's steps read: each bf16 decoder leaf that
    a step reads only in fp32 (through ``layers.mm``, or added to an fp32
    sum) widened to fp32 once, its bf16 values exactly, so every result is
    unchanged and no step casts it; the leaves a step reads in bf16 on
    this decode's path stay bf16. beam: a beam search (greedy's logits
    come from ``mm``); tables: the decode tables are on (the fused step
    needs them). fp32 params come back as they are."""
    fused = beam and opts.structure == "fused"
    fused_step = fused and opts.dec_step and tables
    keep = set(_EMBED)
    if fused:
        # a tied output matrix is the embedding table, kept already
        keep.update(_READOUT_MATRIX)
    if fused_step:
        keep.update(_DEC_STEP_MATRICES)
    elif opts.attn_bf16:
        keep.update(_ENERGIES)

    def widen(mod, name, x):
        if x.dtype == torch.bfloat16 and (mod, name) not in keep:
            return x.to(torch.float32)
        return x

    dec_p = {mod: {k: widen(mod, k, v) for k, v in leaves.items()}
             for mod, leaves in params["decoder"].items()}
    return {**params, "decoder": dec_p}


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: DeviceLike = None) -> Params:
    """Random parameters with the same tree, shapes and distributions as
    the JAX package's ``init_params`` (not the same numbers: the draws come
    from ``generator``). Drawn on the CPU under one intra-op thread, then
    moved to ``device``: torch's CPU QR (the orthogonal init) rounds apart
    with the thread count, so the draw is made at one count whatever the
    caller's, and one seed gives the same bits in every process (the
    replicas of a mesh start equal). The thread count is a setting of the
    whole process: torch work on another thread during the draw runs on
    one thread too, and a change of the count made there is undone when
    the draw ends, so do not call this alongside other torch work."""
    dev = resolve_device(device)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        p: Params = {
            "encoder": enc.init_encoder(generator, cfg),
            "decoder": dec.init_decoder(generator, cfg),
            "init": {
                "w_ctx": glorot_uniform(generator,
                                        (cfg.ctx_dim, cfg.dec_hidden_dim)),
                "b": torch.zeros((cfg.dec_hidden_dim,), dtype=torch.float32),
            },
        }
        if cfg.multimodal:
            p["vse"] = vse.init_vse(generator, cfg)
            p["init"]["w_vis"] = glorot_uniform(
                generator, (cfg.ctx_dim, cfg.dec_hidden_dim))
    finally:
        torch.set_num_threads(threads)
    return _tree_map(lambda x: x.to(dev), p)


def params_from_numpy(tree: Any, cfg: ModelConfig, *,
                      device: DeviceLike = None,
                      mesh: Optional[Mesh] = None) -> Params:
    """The weight bridge: the JAX parameter tree as nested dicts/lists of
    numpy arrays under JAX's own paths (e.g. ``jax.device_get(params)``,
    or a list as flax serializes it, a dict keyed "0", "1", ...) -> the
    port's parameters. Strict: a missing or extra path, a list of
    the wrong length or a shape that differs from what ``cfg`` implies
    raises; every leaf is used. mesh: with a model axis, this rank's
    vocab slices of the tree (``parallel.sharding.shard_tree``)."""
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
            if isinstance(node, dict) and set(node) == {
                    str(i) for i in range(len(node))}:
                # flax's state dicts write a list as {"0": .., "1": ..}
                node = [node[str(i)] for i in range(len(node))]
            if not isinstance(node, (list, tuple)) or len(node) != len(tmpl):
                raise ValueError(f"{path}: expected a list of {len(tmpl)}")
            return [conv(t, n, f"{path}[{i}]")
                    for i, (t, n) in enumerate(zip(tmpl, node))]
        arr = np.asarray(node)
        if arr.shape != tuple(tmpl.shape):
            raise ValueError(f"{path}: shape {arr.shape}, expected "
                             f"{tuple(tmpl.shape)}")
        return torch.tensor(arr, dtype=torch.float32, device=dev)

    return shard_tree(conv(template, tree, ""), mesh)


def _init_decoder_state(params: Params, cfg: ModelConfig, ctx: torch.Tensor,
                        src_mask: torch.Tensor,
                        t_vec: Optional[torch.Tensor]) -> torch.Tensor:
    pre = mm(masked_mean(ctx, src_mask), params["init"]["w_ctx"])
    if cfg.multimodal and t_vec is not None:
        pre = pre + mm(t_vec, params["init"]["w_vis"])
    return torch.tanh(pre + params["init"]["b"]).to(ctx.dtype)


def _encode_and_ground(params: Params, cfg: ModelConfig,
                       batch: Dict[str, torch.Tensor], *, train: bool,
                       generator: Optional[torch.Generator] = None,
                       impl: Optional[str] = None,
                       mesh: Optional[Mesh] = None):
    """Encoder, image embedding + grounding and decoder init on tensors
    already on the params' device. Returns (ctx, s0, img_emb, txt_emb).
    mesh: with a model axis the source embedding is a vocab slice."""
    src_mask = batch["src_mask"]
    ctx = enc.encode(params["encoder"], cfg, batch["src"].long(), src_mask,
                     impl=impl, train=train, generator=generator,
                     vocab=vocab_shard(mesh, cfg.src_vocab_size))
    img_emb = txt_emb = t_vec = None
    if cfg.multimodal:
        img_emb = vse.image_embedding(params["vse"], batch["img"].to(ctx.dtype))
        txt_emb, t_vec, _ = vse.ground(params["vse"], img_emb, ctx, src_mask)
    s0 = _init_decoder_state(params, cfg, ctx, src_mask, t_vec)
    return ctx, s0, img_emb, txt_emb


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            generator: Union[None, torch.Generator, RowDraws] = None, *,
            train: bool = True, shard: Optional[BatchShard] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Joint loss L = CE + vse_weight * VSE; returns (loss, aux) with aux
    keys ce, acc, ntokens, loss and, multimodal, vse (0-dim tensors on the
    params' device).

    batch (tensors on the params' device): src (B, T) int, src_mask (B, T),
    tgt_in (B, Tt) int starting with <sos>, tgt_out (B, Tt) ending with
    <eos>, tgt_mask (B, Tt); img (B, F) when cfg.multimodal; optional
    sample_mask (B,). Dropout (train=True) draws from ``generator``: the
    encoder's first, then the decoder's.

    shard (data parallelism): batch holds this rank's rows of a global
    batch. CE and accuracy are normalized by the global batch's token
    count, so ce, acc and loss are this rank's shares of the CE part: the
    sum over the ranks of ce or acc is the global value, and of the
    gradients the global gradient. The VSE loss takes its in-batch
    negatives over the global batch (``BatchShard.splice``): vse is the
    global value on every rank, its gradient this rank's part of the
    global one; ntokens is global.

    A shard whose mesh has a model axis (tensor parallelism): params hold
    this rank's vocab slices; the logits are the target slice's, CE comes
    from ``vocab_parallel_log_softmax_target`` and accuracy from
    ``vocab_parallel_argmax``. Every value of aux is then the same on the
    ranks of a model group, and the shares add up over the data axis."""
    tp = None if shard is None else tp_mesh(shard.mesh)
    tgt_v = vocab_shard(tp, cfg.tgt_vocab_size)
    ctx, s0, img_emb, txt_emb = _encode_and_ground(
        params, cfg, batch, train=train, generator=generator, mesh=tp)
    logits = dec.teacher_forced_logits(
        params["decoder"], cfg, batch["tgt_in"].long(), s0, ctx,
        batch["src_mask"], train=train, generator=generator, vocab=tgt_v)
    tgt_out = batch["tgt_out"].long()
    if tgt_v is None:
        logp = torch.log_softmax(logits, dim=-1)
        tgt_logp = torch.gather(logp, -1, tgt_out[..., None])[..., 0]
        pred = logits.argmax(-1)
    else:
        tgt_logp = vocab_parallel_log_softmax_target(logits, tgt_out, tgt_v)
        pred = vocab_parallel_argmax(logits.detach(), tgt_v)
    tmask = batch["tgt_mask"].to(torch.float32)
    ntokens = tmask.sum() if shard is None else shard.ntokens
    ntok = ntokens.clamp_min(1.0)
    ce = -(tgt_logp * tmask).sum() / ntok
    acc = ((pred == tgt_out) * tmask).sum() / ntok
    aux = {"ce": ce, "acc": acc, "ntokens": ntokens}
    total = ce
    if cfg.multimodal:
        sample_mask = batch.get("sample_mask")
        if shard is not None:
            img_emb, txt_emb = shard.splice(img_emb), shard.splice(txt_emb)
            sample_mask = shard.sample_mask
        vse_l = vse.max_margin_loss(img_emb, txt_emb, cfg.vse_margin,
                                    cfg.vse_hard_negatives,
                                    sample_mask=sample_mask)
        total = ce + cfg.vse_weight * vse_l
        aux["vse"] = vse_l
    aux["loss"] = total
    return total, aux


def embeddings_for_retrieval(params: Params, cfg: ModelConfig,
                             batch: Dict[str, Any], *,
                             device: DeviceLike = None,
                             impl: Optional[str] = None,
                             mesh: Optional[Mesh] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(img_emb, txt_emb) (B, D) in the shared space, for the R@K
    evaluation. batch: src (B, T) int, src_mask (B, T), img (B, F) (tensors
    or numpy arrays; moved to ``device``, None = the card). mesh: with a
    model axis, params hold vocab slices (the source gather is a
    collective: every rank of the model group calls this)."""
    if not cfg.multimodal:
        raise ValueError("retrieval requires a multimodal config")
    dev = resolve_device(device)
    same_device(dev, params["decoder"]["embed"]["table"], "params")
    b = {"src": torch.as_tensor(batch["src"], device=dev).long(),
         "src_mask": torch.as_tensor(batch["src_mask"],
                                     device=dev).to(torch.float32),
         "img": torch.as_tensor(batch["img"], device=dev)}
    with torch.no_grad():
        _, _, img_emb, txt_emb = _encode_and_ground(params, cfg, b,
                                                    train=False, impl=impl,
                                                    mesh=mesh)
    return img_emb, txt_emb


def prepare_decode(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
                   device: DeviceLike = None,
                   impl: Optional[str] = None,
                   mesh: Optional[Mesh] = None) -> DecodeState:
    """Encode once per batch: encoder, image embedding + grounding, decoder
    init and the attention's context projection. batch: src (B, T) int,
    src_mask (B, T) float, img (B, F) when cfg.multimodal (tensors or numpy
    arrays; moved to ``device``). impl: the encoder GRU scan's impl (None =
    cfg.gru_impl). mesh: with a model axis, params hold vocab slices."""
    dev = resolve_device(device)
    same_device(dev, params["decoder"]["embed"]["table"], "params")
    src_mask = torch.as_tensor(batch["src_mask"], device=dev).to(torch.float32)
    b = {"src": torch.as_tensor(batch["src"], device=dev).long(),
         "src_mask": src_mask}
    if cfg.multimodal:
        b["img"] = torch.as_tensor(batch["img"], device=dev)
    ctx, s0, _, _ = _encode_and_ground(params, cfg, b, train=False, impl=impl,
                                       mesh=mesh)
    return DecodeState(
        ctx=ctx,
        ctx_proj=precompute_ctx_proj(params["decoder"]["attn"], ctx),
        src_mask=src_mask,
        s0=s0,
    )


def decode_step(params: Params, cfg: ModelConfig, tok: torch.Tensor,
                s: torch.Tensor, state: DecodeState,
                tables: Optional[dec.Tables] = None,
                opts: Optional[DecodeOpts] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (s_new (B, K, H), fp32 logits (B, K, V)). opts: the
    decode's step choices (None: ``decode_opts`` at ctx's dtype); under
    tensor parallelism (``opts.tp``) the logits are this rank's vocab
    slice's, (B, K, v1 - v0)."""
    if opts is None:
        opts = decode_opts(state.ctx.dtype)
    s_new, logits, _ = dec.decode_step_beams(
        params["decoder"], cfg, tok, s, state.ctx, state.ctx_proj,
        state.src_mask, tables, attn_bf16=opts.attn_bf16,
        vocab=vocab_shard(opts.tp, cfg.tgt_vocab_size))
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
    defer_exact: bool = False,
    exact: bool = False,
    ban: Optional[torch.Tensor] = None,
    opts: Optional[DecodeOpts] = None,
) -> Tuple[torch.Tensor, ...]:
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

    defer_exact: append the "may be inexact" flag (a 0-dim bool tensor:
    a live row was flagged by the readout's watermark) in place of the
    per-step recovery; the beam loop ORs it over a chunk and reruns the
    chunk with exact=True when it fired. Always False on the unfused path,
    which is exact. exact: run the readout at slot depth K.

    ban: optional (B, K, M) banned ids for no-repeat n-gram blocking (id V
    is the "no ban" sentinel and is dropped). Banned mass is excluded from
    the softmax normalization on both paths.

    opts: the decode's step choices, resolved once a call (None:
    ``decode_opts`` at ctx's dtype): the structure (VAG_READOUT_TOPK), the
    fused step (VAG_DEC_STEP), the attention's energies and the readout
    GEMM's dtype. Under tensor parallelism (``opts.tp``) the fused
    structure runs the readout on this rank's vocab slice and merges the
    slices (``fused_readout_topk(vocab=)``); the unfused one gathers the
    logits' slices into whole rows, exactly, for the top-K kernels, which
    compute their own lse."""
    if opts is None:
        opts = decode_opts(state.ctx.dtype)
    vocab = vocab_shard(opts.tp, cfg.tgt_vocab_size)
    if impl in ("fused", "unfused"):
        structure, impl = impl, "auto"
    else:
        structure = opts.structure
    if structure == "unfused":
        s_new, logits = decode_step(params, cfg, tok, s, state, tables, opts)
        if vocab is not None:
            logits = gather_logits(logits, vocab)
        if ban is not None:
            Bk, Kk, Vk = logits.shape
            flat = logits.reshape(Bk * Kk, Vk)
            mask = ban_mask(ban.reshape(Bk * Kk, -1), Vk).bool()
            flat = torch.where(mask, flat.clamp_max(-1e9), flat)
            logits = flat.reshape(Bk, Kk, Vk)
        out = (s_new,) + beam_topk(logits, scores, finished, impl=impl)
        if defer_exact:
            out = out + (torch.zeros((), dtype=torch.bool, device=s.device),)
        return out
    s_new, t, w_out, b_out = dec.decode_step_beams_readout(
        params["decoder"], cfg, tok, s, state.ctx, state.ctx_proj,
        state.src_mask, tables, dec_step=opts.dec_step, impl=impl,
        attn_bf16=opts.attn_bf16, vocab=vocab)
    if opts.readout_bf16 and w_out.dtype == torch.float32:
        # VAG_FRT_GEMM_DTYPE=bf16 without decode tables (which carry W
        # cast once): W cast here, a step
        w_out = w_out.to(torch.bfloat16)
    K = scores.shape[1]
    return (s_new,) + fused_readout_topk(
        t, w_out, b_out, scores, finished,
        None if ban is None else ban.reshape(t.shape[0], -1), impl=impl,
        slots=K if exact else 0, defer_exact=defer_exact, vocab=vocab)
