"""Traffic kind "decode": corpus translation through the port's
``translate_corpus``, beam search with n-best 1, calls back to back.

Set-up makes the weights and a corpus of ``sentences`` (its image
features a table on the device) and warms up with one call. The window
calls ``translate_corpus`` on the corpus again and again until
``--seconds`` have passed; each call pays its own graph captures, as a
user's does, and ends with its hypotheses on the host. The rate is every
sentence of those calls over the time from the window's start to the last
call's end.

The check parses every served hypothesis (one that is missing, too long
for its cap or not ids of the vocabulary has failed), takes a sample of
the window's sentences drawn from the seed, the longest source among
them, and runs the plain reference over each: ``score_gap``, the widest
gap between the score the program reported for a hypothesis and the score
the reference gives the same tokens; ``best_gap_mean``, the mean over the
sample of how much better the reference's own beam search's hypothesis
scores than the served one (both scored by the reference; a served one
that scores better counts 0), so a search that keeps a wrong candidate but
reports its true score shows here. A mean, not the widest: a near-tie at
the beam's edge may send a sound search down another path on one
sentence, and that one sentence moves the mean little."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import gen, weights
from portbench.drivers.common import port_config

EOS = 3


class Cell:
    def __init__(self, conf: Dict, traffic: Dict, seed: int, device):
        from vag_nmt_tpu_torch.core.config import SPECIALS
        from vag_nmt_tpu_torch.data.batching import Example
        from vag_nmt_tpu_torch.data.vocab import Vocab

        self.conf, self.traffic, self.seed, self.dev = conf, traffic, seed, device
        self.m = conf["model"]
        self.cfg = port_config(conf, seed)
        self.dtype = self.cfg.decode.compute_dtype
        self.beams = self.cfg.decode.beam_size
        self.alpha = self.cfg.decode.length_norm_alpha
        self.params = weights.make(self.m, conf["weights"],
                                   gen.sub_seed(seed, "weights"), device)
        V = self.m["tgt_vocab_size"]
        self.vocab = Vocab(list(SPECIALS) + [str(i) for i in range(4, V)])
        self.ids, self.lens = gen.corpus(traffic, self.m, seed)
        self.img = gen.features(len(self.ids), self.m["img_feat_dim"],
                                conf["weights"]["feature_mean"],
                                gen.sub_seed(seed, "features"), device)
        self.exs = [Example(src=s, index=i) for i, s in enumerate(self.ids)]
        self.calls: List[Tuple[List, Dict]] = []
        self.window_s = 0.0

    def caps(self, lens: np.ndarray) -> np.ndarray:
        """Each row's step cap, as the configuration states it."""
        d = self.cfg.decode
        if d.max_len_factor <= 0:
            return np.full(lens.shape, d.max_len, np.int64)
        cap = np.ceil(d.max_len_factor * lens.astype(np.float32)).astype(
            np.int64) + d.max_len_offset
        return np.clip(cap, 1, d.max_len)

    def _call(self):
        from vag_nmt_tpu_torch.decode.translate import translate_corpus

        with torch.inference_mode():
            return translate_corpus(self.params, self.cfg, self.exs,
                                    self.vocab, de_bpe=False,
                                    img_table=self.img, nbest=1,
                                    device=self.dev)

    def warm(self) -> None:
        self._call()

    def window(self, seconds: float, span) -> Dict[str, float]:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n = 0
        while True:
            with span("portbench.translate_corpus"):
                hyps, stats = self._call()
            self.calls.append((hyps, stats))
            n += len(hyps)
            if time.perf_counter() >= deadline:
                break
        self.window_s = time.perf_counter() - t0
        return {"decode_sent_per_s": n / self.window_s}

    # --------------------------------------------------------- reading
    def sentences(self) -> List[Tuple[int, int]]:
        """(source length, decoded steps) of every sentence of the window:
        steps are its served hypothesis's tokens, <eos> included."""
        out = []
        caps = self.caps(self.lens)
        for hyps, _ in self.calls:
            for i, h in enumerate(hyps):
                toks = self.parse(h, caps[i])
                out.append((int(self.lens[i]), len(toks) if toks else 0))
        return out

    def parse(self, hyp, cap: int) -> Optional[List[int]]:
        """A served n-best entry as its token ids (<eos> appended where the
        hypothesis stopped before its cap: only <eos> ends a row early,
        and the weights keep <pad> and <sos> out of every hypothesis), or
        None where it is malformed."""
        try:
            (text, score), = hyp
            words = [1 if w == "<unk>" else int(w) for w in text.split()]
            float(score)
        except (TypeError, ValueError):
            return None
        V = self.m["tgt_vocab_size"]
        if len(words) > cap or any(w < 1 or w >= V for w in words):
            return None
        return words + [EOS] if len(words) < cap else words

    def reading(self, trace) -> Dict:
        """What the per-layer metrics read (the sentences only in a traced
        run, the only one that reads them)."""
        return {"kind": "decode", "m": self.m, "dtype": self.dtype,
                "beams": self.beams, "window_s": self.window_s,
                "trace": trace, "stats": [s for _, s in self.calls],
                "sentences": self.sentences() if trace is not None else []}

    def release(self) -> None:
        """Nothing to free: the program's graphs and buffers end with each
        ``translate_corpus`` call; the weights stay for the reference."""

    # ----------------------------------------------------------- check
    def check(self, sample: int, replace=None) -> Tuple[Dict, int, int]:
        """(numbers compared, attempted, failed). ``replace``: a function
        (cell, picks) -> [(tokens, score)] that stands in for the
        program's served answers of the picked sentences (the control)."""
        from portbench.reference.model import Reference, exact_products

        attempted = failed = 0
        caps = self.caps(self.lens)
        for hyps, _ in self.calls:
            attempted += len(self.lens)
            if len(hyps) != len(self.lens):
                failed += len(self.lens)
                continue
            for i, h in enumerate(hyps):
                toks = self.parse(h, caps[i])
                if toks is None:
                    failed += 1
        rng = np.random.default_rng(gen.sub_seed(self.seed, "sample"))
        picks = self._picks(rng, sample)
        if replace is not None:
            answers = replace(self, picks)
        else:
            answers = []
            for k, i in picks:
                hyps = self.calls[k][0]
                toks = self.parse(hyps[i], caps[i])
                answers.append((toks, float(hyps[i][0][1]) if toks else 0.0))
        src, mask, img, rcaps = self.batch(picks)
        ok = torch.tensor([a[0] is not None for a in answers])
        hyps_r = [a[0] if a[0] is not None else [] for a in answers]
        with exact_products():
            ref = Reference(self.params, self.m)
            tf = ref.score(src, mask, img, hyps_r, self.alpha).cpu()
            _, best = ref.beam_search(src, mask, img, rcaps, self.beams,
                                      self.alpha)
        prog = torch.tensor([a[1] for a in answers])
        inf = torch.full_like(prog, float("inf"))
        gap = torch.where(ok, (prog - tf).abs(), inf)
        lost = torch.where(ok, (best.cpu() - tf).clamp_min(0.0), inf)
        return ({"score_gap": float(gap.max()),
                 "best_gap_mean": float(lost.mean())}, attempted, failed)

    def _picks(self, rng, sample: int) -> List[Tuple[int, int]]:
        """``sample`` (call, sentence) pairs of the window drawn from the
        seed, each of another sentence, the first the longest source as
        the last call served it."""
        picks = [(len(self.calls) - 1, int(np.argmax(self.lens)))]
        seen = {picks[0][1]}
        while len(picks) < min(sample, len(self.lens)):
            k = int(rng.integers(len(self.calls)))
            i = int(rng.integers(len(self.lens)))
            if i not in seen:
                seen.add(i)
                picks.append((k, i))
        return picks

    def batch(self, picks):
        """The picked sentences' inputs for the reference, made from the
        benchmark's own corpus: (src, mask, img, caps) on the device."""
        rows = [i for _, i in picks]
        lens = self.lens[rows]
        T = int(lens.max())
        src = torch.zeros((len(rows), T), dtype=torch.long)
        for r, i in enumerate(rows):
            src[r, :lens[r]] = torch.tensor(self.ids[i])
        mask = (torch.arange(T)[None] < torch.tensor(lens)[:, None]).float()
        img = self.img[torch.tensor(rows, device=self.img.device)]
        caps = torch.tensor(self.caps(lens))
        dev = self.dev
        return src.to(dev), mask.to(dev), img.to(dev), caps.to(dev)


def control(precision: str):
    """The control: the reference at ``precision`` in the program's place,
    its own beam search's answers for the picked sentences."""
    def replace(cell: Cell, picks):
        from portbench.reference.model import Reference, exact_products

        src, mask, img, caps = cell.batch(picks)
        with exact_products():
            toks, scores = Reference(cell.params, cell.m, precision).beam_search(
                src, mask, img, caps, cell.beams, cell.alpha)
        return list(zip(toks, scores.cpu().tolist()))
    return replace
