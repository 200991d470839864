"""Serving API: raw text in, translated text out (counterpart of the JAX
package's ``decode/serve.py``).

Host preprocessing replays the run's training data exactly: the data
dir's ``preprocess.json`` manifest (tokenizer, lowercasing, truecasing)
next to the BPE and vocab files picks the Moses tokenizer and truecaser or
the simple tokenizer, as the run was trained.

    tr = Translator.from_run("runs/m30k_ende_vag")     # train out-dir
    tr.translate(["a man rides a bicycle", ...])       # -> German lines
    tr.translate(lines, images=feats)                  # (N, 2048) pool5 rows
    tr.translate(lines, display=True)                  # detruecased +
                                                       #   Moses-detokenized

For a multimodal model without ``images``, zero features are fed. Runs on
the card unless ``device="cpu"`` is passed to ``from_run`` or the
constructor."""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from vag_nmt_tpu_torch.core.config import UNK_ID, Config
from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device
from vag_nmt_tpu_torch.data.batching import Example
from vag_nmt_tpu_torch.data.bpe import BPE
from vag_nmt_tpu_torch.data.moses import MosesTokenizer, Truecaser, moses_detokenize
from vag_nmt_tpu_torch.data.tokenizer import tokenize
from vag_nmt_tpu_torch.data.vocab import Vocab
from vag_nmt_tpu_torch.decode.translate import decode_config, translate_corpus
from vag_nmt_tpu_torch.models.layers import compute_dtype
from vag_nmt_tpu_torch.models.model import cast_floats
from vag_nmt_tpu_torch.train.checkpoint import load_checkpoint


class Translator:
    def __init__(self, cfg: Config, params, src_bpe: Optional[BPE],
                 src_vocab: Vocab, tgt_vocab: Vocab, lower: bool = True,
                 tokenizer: str = "simple",
                 truecaser: Optional[Truecaser] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        # a bf16 decode casts the params here, once a load; translate_corpus's
        # own cast then finds them bf16 already
        dtype = compute_dtype(decode_config(cfg).model)
        self.params = (cast_floats(params, dtype)
                       if dtype != torch.float32 else params)
        self.src_bpe = src_bpe
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab
        self.lower = lower
        self.tokenizer = tokenizer
        self.truecaser = truecaser
        self.device = resolve_device(device)
        self._moses_tok = (MosesTokenizer(cfg.data.src_lang)
                           if tokenizer == "moses" else None)
        self._stream_cfg = cfg.replace(decode=dict(streaming="on"))
        # translate_corpus's stats of each decode call of the last request
        self.last_stats: List[dict] = []

    @staticmethod
    def from_run(run_dir: str, data_dir: Optional[str] = None,
                 tag: str = "best", device: DeviceLike = None) -> "Translator":
        """Load config + the checkpoint from a train out-dir, the port's
        or the JAX package's (``train/checkpoint.load_checkpoint``).
        ``data_dir`` (vocab, BPE, preprocess manifest) defaults to the data
        dir recorded in the saved config. Without a preprocess.json the
        simple tokenizer and lowercasing apply. device: None = the card."""
        dev = resolve_device(device)
        with open(os.path.join(run_dir, "config.json")) as f:
            cfg = Config.from_json(f.read())
        d = data_dir or cfg.data.data_dir
        src_vocab = Vocab.load(
            os.path.join(d, f"vocab.{cfg.data.src_lang}.json"))
        tgt_vocab = Vocab.load(
            os.path.join(d, f"vocab.{cfg.data.tgt_lang}.json"))
        cfg = cfg.replace(model={"src_vocab_size": len(src_vocab),
                                 "tgt_vocab_size": len(tgt_vocab)})
        bpe_path = os.path.join(d, f"bpe.{cfg.data.src_lang}.json")
        src_bpe = BPE.load(bpe_path) if os.path.exists(bpe_path) else None

        tokenizer, lower, truecaser = "simple", True, None
        manifest = os.path.join(d, "preprocess.json")
        if os.path.exists(manifest):
            with open(manifest) as f:
                man = json.load(f)
            tokenizer = man.get("tokenizer", "simple")
            lower = bool(man.get("lower", True))
            if man.get("truecase"):
                tc_path = os.path.join(
                    d, f"truecase.{cfg.data.src_lang}.json")
                if not os.path.exists(tc_path):
                    # the model was trained on truecased text: serving
                    # without the truecase model would silently drift
                    raise FileNotFoundError(
                        f"preprocess manifest says truecase=true but "
                        f"{tc_path} is missing; copy the truecase model "
                        f"next to the vocab/bpe files")
                truecaser = Truecaser.load(tc_path)

        state, _ = load_checkpoint(
            os.path.join(run_dir, cfg.train.checkpoint_dir), tag, device=dev,
            cfg=cfg.model)
        return Translator(cfg, state.params, src_bpe, src_vocab, tgt_vocab,
                          lower=lower, tokenizer=tokenizer,
                          truecaser=truecaser, device=dev)

    def _batch_size(self, batch_size: Optional[int]) -> int:
        """The serving chunk size, shared by warmup() and translate()."""
        return (batch_size if batch_size is not None
                else self.cfg.decode.decode_batch_size)

    def _decode(self, cfg: Config, exs: List[Example],
                beam_size: Optional[int], bs: int) -> List[str]:
        hyps, stats = translate_corpus(self.params, cfg, exs, self.tgt_vocab,
                                       beam_size=beam_size, batch_size=bs,
                                       device=self.device)
        self.last_stats.append(stats)
        return hyps

    def warmup(self, batch_size: Optional[int] = None,
               beam_size: Optional[int] = None,
               streaming_chunks: Sequence[int] = ()) -> int:
        """Drive one request per source-length bucket at the serving batch
        size, and for each q in ``streaming_chunks`` one pooled request of
        q chunks per bucket. Returns the number of requests driven. On the
        card this warms the allocator, cuBLAS and the kernel builds before
        the first live request. It captures nothing that a later request
        reuses: a decode call's CUDA graphs (its chunks' loops, its pools'
        trips and refills) are captured within the call and freed with it
        (``decode/graphs.py``)."""
        m = self.cfg.model
        img = (np.zeros((m.img_feat_dim,), np.float32)
               if m.multimodal else None)
        bs = self._batch_size(batch_size)
        n = 0
        for b in self.cfg.data.length_buckets:
            src = [UNK_ID] * min(b, self.cfg.data.max_src_len)
            self._decode(self.cfg, [Example(src=src, img=img, index=0)],
                         beam_size, bs)
            n += 1
            for q in streaming_chunks:
                exs = [Example(src=src, img=img, index=i)
                       for i in range(q * bs)]
                self._decode(self._stream_cfg, exs, beam_size, bs)
                n += 1
        return n

    def _encode_line(self, line: str) -> List[int]:
        if self._moses_tok is not None:
            toks = self._moses_tok.tokenize(line)
            if self.lower:
                toks = [t.lower() for t in toks]
        else:
            toks = tokenize(line, lower=self.lower)
        if self.truecaser is not None:
            toks = self.truecaser.truecase(toks)
        if self.src_bpe is not None:
            toks = self.src_bpe.encode_line(" ".join(toks))
        return self.src_vocab.encode(toks)[: self.cfg.data.max_src_len]

    def translate(
        self,
        lines: Sequence[str],
        images: Optional[np.ndarray] = None,   # (N, img_feat_dim) pool5 rows
        beam_size: Optional[int] = None,
        display: bool = False,
        batch_size: Optional[int] = None,
        bulk: bool = False,
        streaming: Optional[bool] = None,
        pool_chunks: int = 8,
    ) -> List[str]:
        """Returns tokenized hypothesis lines (the scoring convention);
        display=True detruecases and Moses-detokenizes them for people.

        bulk=True decodes the whole request in one translate_corpus call.
        Otherwise a request longer than ``batch_size`` lines (default
        cfg.decode.decode_batch_size) decodes, with ``streaming`` on (None:
        on unless cfg.decode.streaming == "off"; beam search only), as
        streaming-refill pools of ``pool_chunks`` x batch_size rows, a tail
        of one chunk or less by the plain program; with it off, in chunks
        of batch_size lines. Every row's hypothesis is the same whichever
        way it is decoded. ``last_stats`` then holds translate_corpus's
        stats of each decode call."""
        m = self.cfg.model
        if images is not None and not m.multimodal:
            raise ValueError(
                "this run is text-only (model.multimodal=false); passing "
                "images would silently have no effect")
        if images is not None:
            images = np.asarray(images, np.float32)
            if images.ndim != 2 or images.shape[0] != len(lines) \
                    or images.shape[1] != m.img_feat_dim:
                raise ValueError(
                    f"images must be ({len(lines)}, {m.img_feat_dim}), one "
                    f"pool5 row per input line, got {images.shape}")
        exs = []
        for i, ln in enumerate(lines):
            img = None
            if m.multimodal:
                img = (images[i] if images is not None
                       else np.zeros((m.img_feat_dim,), np.float32))
            ids = self._encode_line(ln) or [UNK_ID]  # <unk> for empty input
            exs.append(Example(src=ids, img=img, index=i))
        bs = self._batch_size(batch_size)
        self.last_stats = []
        if streaming is None:
            streaming = self.cfg.decode.streaming != "off"
        k = beam_size if beam_size is not None else self.cfg.decode.beam_size
        if bulk or len(exs) <= bs:
            hyps = self._decode(self.cfg, exs, beam_size, bs)
        elif streaming and k > 1:
            pr = max(2, pool_chunks) * bs
            hyps = []
            for lo in range(0, len(exs), pr):
                sl = exs[lo:lo + pr]
                # a tail of <= one chunk cannot refill: the plain program
                cfg_sl = self._stream_cfg if len(sl) > bs else self.cfg
                hyps.extend(self._decode(cfg_sl, sl, beam_size, bs))
        else:
            hyps = []
            for lo in range(0, len(exs), bs):
                hyps.extend(self._decode(self.cfg, exs[lo:lo + bs],
                                         beam_size, bs))
        if display:
            out = []
            for h in hyps:
                toks = h.split()
                if self.truecaser is not None:
                    toks = Truecaser.detruecase(toks)
                out.append(moses_detokenize(toks, self.cfg.data.tgt_lang))
            return out
        return hyps
