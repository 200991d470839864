"""PyTorch port, BPE's line split and application against the JAX package's
pure-Python path (its semantics oracle, ``BPE(merges, use_native=False)``),
on the CPU.

The port's ``encode_line(line)`` must equal the oracle's on every line,
including lines split by Unicode whitespace: the reference's native source
splits on ASCII whitespace only (known defect R6: "ein\\xa0haus" gives
['e@@', 'i@@', 'n@@', '\\xa0@@', 'haus'] there and ['e@@', 'i@@', 'n',
'haus'] in Python), while the port, which has no native path, splits where
``str.split()`` does. Equality is exact."""

import numpy as np
import pytest

from vag_nmt_tpu.data.bpe import BPE as JaxBPE

from vag_nmt_tpu_torch.data.bpe import BPE, learn_bpe_from_lines

ALPHABET = list("abcdefgh") + ["ü", "ß", "é"]

# Every character str.split() splits on beyond the ASCII whitespace
# " \t\n\r\v\f".
UNICODE_SPACES = ["\x1c", "\x1d", "\x1e", "\x1f", "\x85", "\xa0", "\u1680",
                  *(chr(c) for c in range(0x2000, 0x200b)), "\u2028",
                  "\u2029", "\u202f", "\u205f", "\u3000"]


@pytest.fixture(scope="module")
def corpus():
    """200 seeded lines over a-h, ü, ß, é and merges learned on them."""
    rng = np.random.RandomState(0)
    lines = [["".join(rng.choice(ALPHABET, rng.randint(1, 9)))
              for _ in range(rng.randint(1, 12))] for _ in range(200)]
    return lines, learn_bpe_from_lines(lines, 120)


def _whitespace_lines(lines, seed=1):
    """The corpus's tokens rejoined by random runs of whitespace (ASCII and
    Unicode), with leading and trailing runs."""
    rng = np.random.RandomState(seed)
    seps = [" ", "\t", "\n", "\r", "\v", "\f"] + UNICODE_SPACES
    out = []
    for toks in lines:
        def run():
            return "".join(rng.choice(seps, rng.randint(1, 4)))
        out.append(run() + run().join(toks) + run())
    return out


def test_every_unicode_space_is_a_python_whitespace():
    """The list above is the whole of what str.split() adds to ASCII's."""
    extra = [chr(c) for c in range(0x110000)
             if chr(c).isspace() and chr(c) not in " \t\n\r\v\f"]
    assert extra == UNICODE_SPACES


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_equals_the_jax_python_oracle(corpus, seed):
    lines, merges = corpus
    port, oracle = BPE(merges), JaxBPE(merges, use_native=False)
    assert oracle._nat is None
    for line in [" ".join(t) for t in lines] + _whitespace_lines(lines, seed):
        assert port.encode_line(line) == oracle.encode_line(line)
        assert port.encode_line(line) == port.encode_tokens(line.split())


@pytest.mark.parametrize("space", UNICODE_SPACES)
def test_r6_unicode_whitespace_splits_as_python_does(space):
    """R6: the reference's native tokenizer splits on ASCII whitespace only;
    the port splits where str.split() does, as the oracle."""
    merges = learn_bpe_from_lines([["haus", "hause", "katze"], ["ein", "haus"]],
                                  50)
    port, oracle = BPE(merges), JaxBPE(merges, use_native=False)
    line = f"ein{space}haus"
    assert port.encode_line(line) == oracle.encode_line(line) \
        == port.encode_tokens(["ein", "haus"]) == ["e@@", "i@@", "n", "haus"]


def test_edge_lines(corpus):
    _, merges = corpus
    port, oracle = BPE(merges), JaxBPE(merges, use_native=False)
    for line in ["", " ", " \t\n ", "\u3000\xa0", "a", "abc\x00def ab",
                 "\x00", "ab\ud800cd ef", "</w> a</w>b", "\xe9" * 40,
                 "a\u200bb"]:                  # U+200B is no space
        assert port.encode_line(line) == oracle.encode_line(line), repr(line)


def test_long_line(corpus):
    """A word of 12000 characters no merge joins, then ordinary words."""
    _, merges = corpus
    port, oracle = BPE(merges), JaxBPE(merges, use_native=False)
    line = "zyxw" * 3000 + " " + "abc " * 50
    out = port.encode_line(line)
    assert len(out) == 12000 + 50 * len(port.segment_word("abc"))
    assert out == oracle.encode_line(line)


def test_load_reads_the_jax_packages_file(corpus, tmp_path):
    lines, merges = corpus
    JaxBPE(merges, use_native=False).save(str(tmp_path / "b.json"))
    port = BPE.load(str(tmp_path / "b.json"))
    oracle = JaxBPE(merges, use_native=False)
    assert port.merges == [tuple(m) for m in merges]
    for line in _whitespace_lines(lines[:50], 3):
        assert port.encode_line(line) == oracle.encode_line(line)


def test_duplicate_merges_take_the_last_rank_as_python_does():
    merges = [("a", "b"), ("b", "c"), ("a", "b")]
    port, oracle = BPE(merges), JaxBPE(merges, use_native=False)
    assert port.ranks[("a", "b")] == 2
    for line in ["abc", "abcabc bcab", "cab"]:
        assert port.encode_line(line) == oracle.encode_line(line)
