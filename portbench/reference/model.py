"""The plain PyTorch reference of VAG-NMT (Zhou et al., EMNLP 2018,
arXiv:1808.08266), written from the model's equations and the port's
documented conventions, and importing nothing of the port or of JAX.

Model (weights in ``(in, out)`` layout, ``x @ W``; GRU gates as cuDNN's,
the reset gate after the hidden product)::

    encoder   ctx = [GRU_fwd(x); GRU_bwd(x)],  x = emb_src[src]; at a pad
              the state carries over unchanged
    vse       img = l2n(tanh(f @ W_i + b_i));  t_vec = attn_g(img, ctx)
              txt = l2n(tanh(t_vec @ W_t + b_t))
    init      s0 = tanh(mean(ctx) @ W_ctx + t_vec @ W_vis + b)
    step      s~ = GRU1(y @ Wi1 + bi1, s);   c = attn(s~ @ Ua, ctx)
              s' = GRU2(c @ Wi2 + bi2, s~)
              t  = tanh(y @ Wy + s' @ Ws + c @ Wc + b)
              logits = t @ W_out + b_out
    attn(q)   e = tanh(ctx @ Wa + q + ba); w = softmax_mask(e @ va)
              c = sum_t w_t ctx_t
    loss      CE over the target tokens (incl. <eos>) / their count
              + 0.25 * bidirectional max-margin (0.1) ranking of img/txt

Training adds inverted dropout (rate ``dropout``) to the source
embeddings, the target embeddings and the readout activations, drawn in
that order from one generator on the device per step, seeded as the
port's configuration states: ((train seed + 1) << 32) + step. The update
is global-norm clipping, then Adam, then ``p - lr * u``.

Beam search keeps K beams per sentence (beam 0 at 0, the others at -1e9 at
the start); a finished beam offers one candidate, <pad> at its own score;
rows freeze at their cap (``ceil(factor * len) + offset``); the best beam
is the highest ``score / length ** alpha`` (length counting <eos>), ties
to the lower beam.

``precision``: "float32" (TF32 off: the reference), or the control's
lower precisions: "tf32" (each product's operands rounded to TF32's 10-bit
mantissa) and "fp8" (each operand scaled per tensor into e4m3's range and
rounded to it); the gradient passes a rounding unchanged."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch

NEG_INF = -1e9
PAD, SOS, EOS = 0, 2, 3
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_products():
    """TF32 off for the block, on every backend that has it."""
    mm_flag = torch.backends.cuda.matmul.allow_tf32
    dnn_flag = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm_flag
        torch.backends.cudnn.allow_tf32 = dnn_flag


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Reference:
    """The model of ``m`` (a dict of widths) over the parameter tree
    ``params`` (fp32 tensors; read, never written), at ``precision``."""

    def __init__(self, params: Dict, m: Dict, precision: str = "float32"):
        if precision not in ("float32", "tf32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.p = params
        self.m = m
        self.precision = precision

    # -------------------------------------------------------- products
    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.precision == "float32":
            return x
        r = _round_tf32(x) if self.precision == "tf32" else _round_fp8(x)
        return x + (r - x).detach()

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(w)

    @staticmethod
    def _gates(xg, hg, h):
        H = h.shape[-1]
        r = torch.sigmoid(xg[..., :H] + hg[..., :H])
        z = torch.sigmoid(xg[..., H:2 * H] + hg[..., H:2 * H])
        n = torch.tanh(xg[..., 2 * H:] + r * hg[..., 2 * H:])
        return (1.0 - z) * n + z * h

    def _gru(self, p, x, mask, reverse):
        B, T, _ = x.shape
        H = p["uh"].shape[0]
        xg = self.mm(x, p["wi"]) + p["bi"]
        h = x.new_zeros((B, H))
        out = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            hn = self._gates(xg[:, t], self.mm(h, p["uh"]) + p["bh"], h)
            h = torch.where(mask[:, t, None] > 0, hn, h)
            out[t] = h
        return torch.stack(out, 1)

    def _attend(self, p, q, ctx, cp, mask):
        """q (B, K, A) projected queries; ctx (B, T, C); cp (B, T, A) =
        ctx @ wa; mask (B, T). Returns c (B, K, C)."""
        e = torch.tanh(cp[:, None] + q[:, :, None] + p["ba"])
        s = self.mm(e, p["va"][:, None])[..., 0]
        s = torch.where(mask[:, None] > 0, s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, -1)
        return self.mm(w, ctx)

    @staticmethod
    def _dropout(x, u, rate):
        keep = 1.0 - rate
        return torch.where(u < keep, x / keep, torch.zeros_like(x))

    @staticmethod
    def _l2n(x):
        return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)

    # ---------------------------------------------------------- encode
    def prepare(self, src, mask, img, gen=None, rate=0.0):
        """Encoder, grounding and decoder init for src (B, T) ids, mask
        (B, T), img (B, F): (ctx, ctx_proj, s0, img_emb, txt_emb); with
        ``gen`` the source embeddings' dropout is drawn from it."""
        p, m = self.p, self.m
        x = p["encoder"]["embed"]["table"][src]
        if gen is not None:
            x = self._dropout(x, torch.rand(x.shape, generator=gen,
                                            device=x.device), rate)
        for i, layer in enumerate(p["encoder"]["layers"]):
            x = torch.cat([self._gru(layer["fwd"], x, mask, False),
                           self._gru(layer["bwd"], x, mask, True)], -1)
            if gen is not None and i + 1 < len(p["encoder"]["layers"]):
                x = self._dropout(x, torch.rand(x.shape, generator=gen,
                                                device=x.device), rate)
        ctx = x
        v = p["vse"]
        img_emb = self._l2n(torch.tanh(self.mm(img, v["img_proj"]["w"])
                                       + v["img_proj"]["b"]))
        g = v["ground"]
        t_vec = self._attend(g, self.mm(img_emb, g["ua"])[:, None], ctx,
                             self.mm(ctx, g["wa"]), mask)[:, 0]
        txt_emb = self._l2n(torch.tanh(self.mm(t_vec, v["txt_proj"]["w"])
                                       + v["txt_proj"]["b"]))
        den = mask.sum(-1, keepdim=True).clamp_min(1.0)
        mean = (ctx * mask[..., None]).sum(1) / den
        i = p["init"]
        s0 = torch.tanh(self.mm(mean, i["w_ctx"]) + self.mm(t_vec, i["w_vis"])
                        + i["b"])
        cp = self.mm(ctx, p["decoder"]["attn"]["wa"])
        return ctx, cp, s0, img_emb, txt_emb

    # ------------------------------------------------------------ step
    def step(self, y, s, ctx, cp, mask, u_y=None, u_t=None, rate=0.0):
        """One decoder step of K rows a sentence: y (B, K) previous ids, s
        (B, K, D). Returns (s' (B, K, D), fp32 logits (B, K, V)); u_y,
        u_t: dropout draws of the target embedding and the readout."""
        d = self.p["decoder"]
        ye = d["embed"]["table"][y]
        if u_y is not None:
            ye = self._dropout(ye, u_y, rate)
        st = self._gates(self.mm(ye, d["gru1"]["wi"]) + d["gru1"]["bi"],
                         self.mm(s, d["gru1"]["uh"]) + d["gru1"]["bh"], s)
        c = self._attend(d["attn"], self.mm(st, d["attn"]["ua"]), ctx, cp,
                         mask)
        sn = self._gates(self.mm(c, d["gru2"]["wi"]) + d["gru2"]["bi"],
                         self.mm(st, d["gru2"]["uh"]) + d["gru2"]["bh"], st)
        r = d["readout"]
        t = torch.tanh(self.mm(ye, r["wy"]) + self.mm(sn, r["ws"])
                       + self.mm(c, r["wc"]) + r["b"])
        if u_t is not None:
            t = self._dropout(t, u_t, rate)
        return sn, self.mm(t, r["w_out"]) + r["b_out"]

    # ---------------------------------------------------------- decode
    @torch.no_grad()
    def beam_search(self, src, mask, img, caps, beams: int, alpha: float
                    ) -> Tuple[List[List[int]], torch.Tensor]:
        """Each sentence's best hypothesis (ids, <eos> included when it was
        produced) and its normalized score."""
        ctx, cp, s0, _, _ = self.prepare(src, mask, img)
        B, K, dev = src.shape[0], beams, src.device
        V = self.m["tgt_vocab_size"]
        L = int(caps.max())
        s = s0[:, None].expand(B, K, s0.shape[-1])
        y = torch.full((B, K), SOS, dtype=torch.long, device=dev)
        scores = torch.full((B, K), NEG_INF, device=dev)
        scores[:, 0] = 0.0
        toks = torch.zeros((B, K, L), dtype=torch.long, device=dev)
        fin = torch.zeros((B, K), dtype=torch.bool, device=dev)
        lens = torch.zeros((B, K), dtype=torch.long, device=dev)
        frozen_cand = torch.full((V,), NEG_INF, device=dev)
        frozen_cand[PAD] = 0.0
        for t in range(L):
            fin = fin | (t >= caps[:, None])
            if bool(fin.all()):
                break
            sn, logits = self.step(y, s, ctx, cp, mask)
            logp = torch.log_softmax(logits, -1)
            cand = scores[..., None] + torch.where(fin[..., None],
                                                   frozen_cand, logp)
            flat = cand.reshape(B, K * V)
            order = torch.sort(flat, dim=1, descending=True, stable=True)[1]
            idx = order[:, :K]
            scores = torch.gather(flat, 1, idx)
            beam, tok = idx // V, idx % V
            s = torch.gather(sn, 1, beam[..., None].expand_as(sn))
            toks = torch.gather(toks, 1, beam[..., None].expand_as(toks))
            f_sel = torch.gather(fin, 1, beam)
            toks[:, :, t] = torch.where(f_sel, torch.zeros_like(tok), tok)
            lens = torch.where(f_sel, torch.gather(lens, 1, beam),
                               torch.gather(lens, 1, beam) + 1)
            fin = f_sel | (tok == EOS)
            y = tok
        final = scores / lens.clamp_min(1).to(torch.float32) ** alpha
        best = torch.sort(final, dim=1, descending=True, stable=True)[1][:, 0]
        rows = torch.arange(B, device=dev)
        bt, bl = toks[rows, best].tolist(), lens[rows, best].tolist()
        return [bt[i][:bl[i]] for i in range(B)], final[rows, best]

    @torch.no_grad()
    def score(self, src, mask, img, hyps: Sequence[Sequence[int]],
              alpha: float) -> torch.Tensor:
        """Each hypothesis's normalized score, its log-probabilities summed
        over its tokens under teacher forcing, over length ** alpha."""
        ctx, cp, s0, _, _ = self.prepare(src, mask, img)
        B, dev = src.shape[0], src.device
        L = max(1, max(len(h) for h in hyps))
        tgt = torch.zeros((B, L), dtype=torch.long, device=dev)
        for i, h in enumerate(hyps):
            tgt[i, :len(h)] = torch.tensor(list(h), dtype=torch.long)
        n = torch.tensor([len(h) for h in hyps], device=dev)
        s, y = s0[:, None], torch.full((B, 1), SOS, dtype=torch.long,
                                       device=dev)
        total = torch.zeros(B, device=dev)
        for t in range(L):
            s, logits = self.step(y, s, ctx, cp, mask)
            lp = torch.log_softmax(logits[:, 0], -1)
            got = torch.gather(lp, 1, tgt[:, t:t + 1])[:, 0]
            total = total + torch.where(t < n, got, torch.zeros_like(got))
            y = tgt[:, t:t + 1]
        return total / n.clamp_min(1).to(torch.float32) ** alpha

    # ------------------------------------------------------------ train
    def loss(self, b: Dict[str, torch.Tensor], gen: torch.Generator,
             rate: float, margin: float, vse_weight: float
             ) -> torch.Tensor:
        """The joint loss of one batch (classic keys: src, src_mask,
        tgt_in, tgt_out, tgt_mask, sample_mask, img) with dropout from
        ``gen``."""
        ctx, cp, s0, img_emb, txt_emb = self.prepare(
            b["src"], b["src_mask"], b["img"], gen, rate)
        B, Tt = b["tgt_in"].shape
        dev = ctx.device
        E = self.m["emb_dim"]
        u_y = torch.rand((B, Tt, E), generator=gen, device=dev)
        u_t = torch.rand((B, Tt, E), generator=gen, device=dev)
        s, logits = s0[:, None], []
        for t in range(Tt):
            s, lg = self.step(b["tgt_in"][:, t:t + 1], s, ctx, cp,
                              b["src_mask"], u_y[:, t:t + 1], u_t[:, t:t + 1],
                              rate)
            logits.append(lg)
        logp = torch.log_softmax(torch.cat(logits, 1), -1)
        tl = torch.gather(logp, -1, b["tgt_out"][..., None])[..., 0]
        tm = b["tgt_mask"]
        ce = -(tl * tm).sum() / tm.sum().clamp_min(1.0)
        sim = self.mm(txt_emb, img_emb.T)
        pos = torch.diagonal(sim)
        sm = b["sample_mask"]
        valid = (1.0 - torch.eye(B, device=dev)) * sm[:, None] * sm[None, :]
        cs = torch.relu(margin + sim - pos[:, None]) * valid
        ci = torch.relu(margin + sim - pos[None, :]) * valid
        vse = (cs.sum(1) + ci.sum(0)).sum() / sm.sum().clamp_min(1.0)
        return ce + vse_weight * vse


def leaves(tree) -> List[torch.Tensor]:
    """The tree's tensors, dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, it) for v in tree]
    return next(it)


def train(params: Dict, m: Dict, batches: Sequence[Dict], gens:
          Sequence[torch.Generator], hp: Dict, precision: str = "float32"
          ) -> Dict:
    """Train steps from ``params`` over ``batches``, step k's dropout from
    ``gens[k]``: {"losses": [...], "grads": the first step's clipped
    gradient a leaf, "grad_raw": its unclipped one, "params": the leaves
    after the last step}. hp: dropout, vse_margin, vse_weight, lr, b1, b2,
    eps, clip."""
    ps = [x.detach().clone() for x in leaves(params)]
    mu = [torch.zeros_like(x) for x in ps]
    nu = [torch.zeros_like(x) for x in ps]
    out: Dict = {"losses": []}
    for k, (b, gen) in enumerate(zip(batches, gens)):
        req = [x.detach().requires_grad_(True) for x in ps]
        ref = Reference(rebuild(params, iter(req)), m, precision)
        loss = ref.loss(b, gen, hp["dropout"], hp["vse_margin"],
                        hp["vse_weight"])
        grads = torch.autograd.grad(loss, req, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(ps, grads)]
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.where(norm < hp["clip"], torch.ones_like(norm),
                                hp["clip"] / norm)
            grads = [g * scale for g in grads]
            if k == 0:
                out["grads"] = [g.clone() for g in grads]
            n = k + 1
            bc1 = torch.tensor(1.0 - math.pow(hp["b1"], n), dtype=torch.float32)
            bc2 = torch.tensor(1.0 - math.pow(hp["b2"], n), dtype=torch.float32)
            for i, g in enumerate(grads):
                mu[i] = (1.0 - hp["b1"]) * g + hp["b1"] * mu[i]
                nu[i] = (1.0 - hp["b2"]) * (g * g) + hp["b2"] * nu[i]
                u = (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + hp["eps"])
                ps[i] = ps[i] - hp["lr"] * u
    out["params"] = ps
    return out
