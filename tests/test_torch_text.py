"""The PyTorch port's own copies of the host text pipeline (simple tokenizer,
Moses tokenizer, truecaser, Moses detokenizer, BPE) against the JAX
package's modules: the same input gives exactly the same output. The lines
include every case of tests/test_moses.py."""

import pytest

from vag_nmt_tpu.data import bpe as jbpe
from vag_nmt_tpu.data import moses as jmoses
from vag_nmt_tpu.data import tokenizer as jtok

from vag_nmt_tpu_torch.data import bpe as tbpe
from vag_nmt_tpu_torch.data import moses as tmoses
from vag_nmt_tpu_torch.data import tokenizer as ttok

# (lang, line, MosesTokenizer options)
MOSES_LINES = [
    ("en", "Hello, world!", {}),
    ("en", "A man (with a dog) runs.", {}),
    ("en", "don't", {}),
    ("en", "John's dog", {}),
    ("en", "the dogs' toys", {}),
    ("en", "'quoted'", {}),
    ("en", "1990's music", {}),
    ("en", "1,000,000 items", {}),
    ("en", "one, two, three", {}),
    ("en", "Mr. Smith arrived.", {}),
    ("en", "Dr. Brown met Gen. Lee.", {}),
    ("en", "He lives in the U.S.A.", {}),
    ("en", "etc. and so on", {}),
    ("en", "The dog runs.", {}),
    ("en", "No. 5 is here", {}),
    ("en", "Wait... what?", {}),
    ("en", "state-of-the-art model", {}),
    ("en", "a_b", {}),
    ("en", "  a \t b\x01c  ", {}),
    ("en", "John's dog doesn't run.", {}),
    ("en", 'She said "stop" -- twice; then: 3.5% off [sic] {x}.', {}),
    ("en", "state-of-the-art", {"aggressive_hyphen": True}),
    ("en", "a & b", {"escape": True}),
    ("en", "x | y < z > w", {"escape": True}),
    ("fr", "l'homme", {}),
    ("fr", "J'ai vu l'école", {}),
    ("fr", "aujourd'hui", {}),
    ("fr", "C'est, n'est-ce pas?", {}),
    ("fr", "M. Dupont arrive à 8 h.", {}),
    ("de", "Peter's Haus", {}),
    ("de", "Dr. Müller kommt.", {}),
    ("de", "z. B. dieses Haus", {}),
    ("de", "Ein Mann fährt.", {}),
    ("de", "Straße überqueren!", {}),
    ("de", "Zwei Hunde spielen im Schnee, nicht wahr?", {}),
]


@pytest.mark.parametrize("lang,line,kw", MOSES_LINES)
def test_moses_tokenizer_matches_jax(lang, line, kw):
    want = jmoses.MosesTokenizer(lang, **kw).tokenize(line)
    got = tmoses.MosesTokenizer(lang, **kw).tokenize(line)
    assert got == want
    assert (tmoses.MosesTokenizer(lang, **kw).tokenize(line, return_str=True)
            == " ".join(want))
    for detok_lang in ("en", "de", "fr"):
        assert (tmoses.moses_detokenize(got, detok_lang)
                == jmoses.moses_detokenize(want, detok_lang))


DETOK_TOKENS = [
    ("en", "Hello , world !"),
    ("en", "don 't stop"),
    ("en", "John 's dog ."),
    ("en", "a man ( with a dog )"),
    ("fr", "l' homme est là ."),
    ("en", '" quoted text "'),
    ("en", "100 % sure"),
    ("de", "ein Mann , der « läuft » ."),
    ("de", "„ Hallo “ , sagte er ."),
]


@pytest.mark.parametrize("lang,toks", DETOK_TOKENS)
def test_moses_detokenize_matches_jax(lang, toks):
    assert (tmoses.moses_detokenize(toks.split(), lang)
            == jmoses.moses_detokenize(toks.split(), lang))


SIMPLE_LINES = [
    "A man rides a bicycle.",
    "Don't stop -- it's the well-known U.S. rule!",
    "Zwei Männer, größer als 1,80 m, spielen (Fußball).",
    "  tabs\tand  spaces ",
    "",
]


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("line", SIMPLE_LINES)
def test_simple_tokenizer_matches_jax(line, lower):
    toks = ttok.tokenize(line, lower=lower)
    assert toks == jtok.tokenize(line, lower=lower)
    assert ttok.detokenize(toks) == jtok.detokenize(toks)


TRUECASE_TRAIN = [
    "The man walks in Paris .",
    "A dog saw the man .",
    "Paris is large .",
    "In Paris , the man sleeps .",
    "5 Hunde laufen .",
    "wir sehen Hunde .",
    '" Heute laufen wir . "',
]
TRUECASE_LINES = [
    "The man walks .",
    "he saw Paris .",
    "he saw PARIS .",
    "Zurich is far .",
    "The man walks . The dog too .",
    '" The man walks . "',
    "5 Hunde laufen .",
    '" Wir laufen .',
]


@pytest.mark.parametrize("line", TRUECASE_LINES)
def test_truecaser_matches_jax(line, tmp_path):
    lines = [ln.split() for ln in TRUECASE_TRAIN]
    jtc = jmoses.Truecaser.train(lines)
    ttc = tmoses.Truecaser.train(lines)
    assert (ttc.best, ttc.known) == (jtc.best, jtc.known)
    path = str(tmp_path / "tc.json")
    jtc.save(path)
    loaded = tmoses.Truecaser.load(path)
    toks = line.split()
    want = jtc.truecase(toks)
    assert ttc.truecase(toks) == want
    assert loaded.truecase(toks) == want
    assert (tmoses.Truecaser.detruecase(want)
            == jmoses.Truecaser.detruecase(want))


def test_prefix_file_matches_jax(tmp_path):
    p = tmp_path / "nonbreaking_prefix.xx"
    p.write_text("# comment\nAbc\nNum #NUMERIC_ONLY#\n\n")
    assert tmoses.load_prefix_file(str(p)) == jmoses.load_prefix_file(str(p))
    for line in ("Abc. Smith", "Num. 5", "Num. Smith"):
        assert (tmoses.MosesTokenizer("en", prefix_file=str(p)).tokenize(line)
                == jmoses.MosesTokenizer("en", prefix_file=str(p)).tokenize(line))


BPE_CORPUS = [
    "a man rides a bicycle down the street",
    "two men ride bicycles along the road",
    "a woman is riding a horse on the beach",
    "the riders wear helmets while riding",
    "lower lowest newer newest wider widest",
]
BPE_LINES = BPE_CORPUS + [
    "unseen words like zebra and xylophone",
    "riding riders rides ridden",
    "a",
    "",
]


@pytest.mark.parametrize("line", BPE_LINES)
def test_bpe_encode_line_matches_jax(line, tmp_path):
    merges = jbpe.learn_bpe_from_lines([ln.split() for ln in BPE_CORPUS], 40)
    path = str(tmp_path / "bpe.json")
    jbpe.BPE(merges, use_native=False).save(path)
    want = jbpe.BPE(merges, use_native=False).encode_line(line)
    assert tbpe.BPE(merges).encode_line(line) == want
    assert tbpe.BPE.load(path).encode_line(line) == want
    assert tbpe.remove_bpe(want) == jbpe.remove_bpe(want)
