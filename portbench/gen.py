"""The one traffic generator: a corpus and training pairs from a traffic
file's parameters and the run's seed.

Every seed gets the same multiset of lengths, drawn once from the traffic
file's distribution with the fixed ``LENGTH_SET_SEED``; the run's seed
draws the order, the token ids and the image features. So every seed asks
for the same work, and two seeds differ only in the values the work is
done on.

Lengths: ``{"dist": "normal", "mean", "sd", "min", "max"}`` (rounded,
clipped). A target length follows its source's:
``{"ratio", "sd", "min", "max"}``, the source length times ``ratio`` plus
normal noise of ``sd`` tokens, rounded and clipped. Token ids are uniform
over the vocabulary past the four special ids; image features are
non-negative, as pool5 features after a ReLU are (exponential, mean
``feature_mean``), made on the device."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

FIRST_ID = 4                # ids 0-3: <pad>, <unk>, <sos>, <eos>
LENGTH_SET_SEED = 0


def sub_seed(seed: int, stream: str, bits: int = 63) -> int:
    """A seed of ``bits`` bits for one named stream of the run's seed."""
    key = [int(b) for b in stream.encode()]
    state = np.random.SeedSequence(int(seed), spawn_key=key).generate_state(
        2, np.uint32)
    return int((int(state[0]) << 32 | int(state[1])) >> (64 - bits))


def length_set(spec: Dict, n: int) -> np.ndarray:
    """n lengths of distribution ``spec``, the same for every run."""
    if spec["dist"] != "normal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    rng = np.random.default_rng(LENGTH_SET_SEED)
    x = np.rint(rng.normal(spec["mean"], spec["sd"], n))
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def target_lengths(spec: Dict, src: np.ndarray) -> np.ndarray:
    """Each source length's target length, the same for every run."""
    rng = np.random.default_rng(LENGTH_SET_SEED + 1)
    x = np.rint(src * spec["ratio"] + rng.normal(0.0, spec["sd"], len(src)))
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def _tokens(rng: np.random.Generator, lens: np.ndarray, vocab: int
            ) -> List[List[int]]:
    flat = rng.integers(FIRST_ID, vocab, int(lens.sum()))
    cuts = np.cumsum(lens)[:-1]
    return [a.tolist() for a in np.split(flat, cuts)]


def features(n: int, dim: int, mean: float, seed: int, device) -> torch.Tensor:
    """(n, dim) fp32 image features on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand((n, dim), generator=gen, device=device)
    return u.clamp_min_(1e-12).log_().mul_(-mean)


def corpus(traffic: Dict, m: Dict, seed: int
           ) -> Tuple[List[List[int]], np.ndarray]:
    """The corpus of a decode traffic: (source id lists, lengths)."""
    lens = length_set(traffic["src_len"], traffic["sentences"])
    rng = np.random.default_rng(sub_seed(seed, "corpus"))
    lens = lens[rng.permutation(len(lens))]
    return _tokens(rng, lens, m["src_vocab_size"]), lens


def pairs(traffic: Dict, m: Dict, seed: int
          ) -> Tuple[List[List[int]], List[List[int]]]:
    """Training pairs of a train traffic: (source id lists, target id
    lists); the (source, target) length pairs are one fixed multiset."""
    n = traffic["pairs"]
    s = length_set(traffic["src_len"], n)
    t = target_lengths(traffic["tgt_len"], s)
    rng = np.random.default_rng(sub_seed(seed, "pairs"))
    order = rng.permutation(n)
    s, t = s[order], t[order]
    return (_tokens(rng, s, m["src_vocab_size"]),
            _tokens(rng, t, m["tgt_vocab_size"]))
