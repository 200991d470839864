"""Moses-parity tokenizer, truecaser, and detokenizer (own copy of the JAX
package's ``data/moses.py``, en/de/fr prefix tables included).

The Moses Perl scripts (``tokenizer.perl``,
``train-truecaser.perl``/``truecase.perl``, ``detokenizer.perl``) are
reimplemented in Python, rule for rule in the same order the Perl applies
them:

tokenizer.perl:
  1. whitespace squash + ASCII control-char strip
  2. pad every char that is not alnum/space/``.'`,-`` with spaces
  3. optional aggressive hyphen splitting (``@-@`` placeholder)
  4. multi-dot protection (DOTMULTI placeholder loop)
  5. commas split unless between digits
  6. language-specific apostrophe rules (en: split LEFT of the quote and
     keep it attached to the suffix, ``don't -> don 't``; fr: split RIGHT,
     ``l'homme -> l' homme``; de and others: isolate all apostrophes)
  7. word-final periods split unless the word is a known nonbreaking prefix,
     contains an internal dot+letter (``U.S.A.``), is followed by a
     lowercase word, or is a NUMERIC_ONLY prefix followed by a digit
  8. optional Moses HTML-entity escaping (off by default here; pass
     ``escape=True`` for pipelines that used Moses' default)

The embedded nonbreaking-prefix lists follow Moses'
``share/nonbreaking_prefixes/nonbreaking_prefix.{en,de,fr}``. Those are DATA
files; the lists here cover the common entries and a real file can be
supplied via ``prefix_file`` for exact parity.

truecase.perl / train-truecaser.perl: the truecaser learns each word's most
frequent casing from non-sentence-initial positions; at apply time
sentence-initial words are re-cased to the learned form, other words keep
their observed casing unless that exact form was never seen in training.

tests/test_torch_text.py holds this copy against the JAX package's, whose
golden pairs (tests/test_moses.py) follow the Moses scripts' documented
behavior.
"""

from __future__ import annotations

import json
import re
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional

# ---------------------------------------------------------------------------
# Nonbreaking prefixes. Value 1 = always nonbreaking before a word;
# 2 = NUMERIC_ONLY (nonbreaking only when followed by a digit).

_EN_PREFIXES = (
    [chr(c) for c in range(ord("A"), ord("Z") + 1)]
    + """Adj Adm Adv Asst Bart Bldg Brig Bros Capt Cmdr Col Comdr Con Corp
    Cpl DR Dr Drs Ens Gen Gov Hon Hr Hosp Insp Lt MM MR MRS MS Maj Messrs
    Mlle Mme Mr Mrs Ms Msgr Op Ord Pfc Ph Prof Pvt Rep Reps Res Rev Rt Sen
    Sens Sfc Sgt Sr St Supt Surg v vs i.e rev e.g""".split())
_EN_NUMERIC = "No Nos Art Nr pp".split()

_DE_PREFIXES = (
    [chr(c) for c in range(ord("A"), ord("Z") + 1)]
    + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    + """Adj Adm Adv Art Asst Bart Bldg Brig Bros Capt Cmdr Col Comdr Con
    Corp Cpl DR Dr Ens Gen Gov Hon Hosp Insp Lt MM MR MRS MS Maj Messrs
    Mlle Mme Mr Mrs Ms Msgr Op Ord Pfc Ph Prof Pvt Rep Reps Res Rev Rt Sen
    Sens Sfc Sgt Sr St Supt Surg
    Abb Abk Abs Abt Ausg Bd Bsp Bspw Dez Dipl Dr Fa Fam Feb Fr Frl Hbf Hr
    Hrn Ing Jan Jh Jhd Jr Jul Jun Mag Mär Mio Mrd Mrz Nov Nr Okt Prof Sep
    Sept St Str Tel Univ usw bzw bzgl ca dgl ebd eigtl etc evtl geb gegr
    ggf ggfs hrsg inkl insb o s u v vgl vllt vlt z zb zzgl
    Apr Aug Bhf Bf Di Do Mi Mo Sa So Fre Frau Herrn Hrsg Dez Jän
    Mill Min Max Nov Sekt Wwe a d e f g h i j k l m n p q r t w x y
    al betr bspw bzw ca dh dgl dt ev evtl frz geb gem ggf hins hrsg
    incl jew kath lt luth max min mind mtl natürl od orth östr pp prot
    rd röm s schles schwäb schweiz sog sogen spez srb süd tägl usf va
    verh verw vorm wiss zB zT zit zzt""".split())
_DE_NUMERIC = "Nr Nos Art pp ca".split()

_FR_PREFIXES = (
    [chr(c) for c in range(ord("A"), ord("Z") + 1)]
    + """Adj Adm Adv Art Asst Bart Bldg Brig Bros Capt Cmdr Col Comdr Con
    Corp Cpl DR Dr Ens Gen Gov Hon Hosp Insp Lt MM MR MRS MS Maj Messrs
    Mlle Mme Mr Mrs Ms Msgr Op Ord Pfc Ph Prof Pvt Rep Reps Res Rev Rt Sen
    Sens Sfc Sgt Sr St Supt Surg
    M Mlles Mmes Mgr Me Pr étals doct""".split())
_FR_NUMERIC = "No Nos Art Nr pp".split()

_PREFIX_TABLES: Dict[str, Dict[str, int]] = {}
for _lang, _plain, _num in (("en", _EN_PREFIXES, _EN_NUMERIC),
                            ("de", _DE_PREFIXES, _DE_NUMERIC),
                            ("fr", _FR_PREFIXES, _FR_NUMERIC)):
    t: Dict[str, int] = {p: 1 for p in _plain}
    t.update({p: 2 for p in _num})
    _PREFIX_TABLES[_lang] = t


def load_prefix_file(path: str) -> Dict[str, int]:
    """Parse a Moses nonbreaking_prefix.<lang> file (# comments,
    ``#NUMERIC_ONLY#`` markers)."""
    table: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            if "#NUMERIC_ONLY#" in ln:
                table[ln.split("#")[0].strip()] = 2
            else:
                table[ln] = 1
    return table


# Unicode classes mirroring Perl's \p{IsAlpha}/\p{IsN}/\p{IsAlnum}.
_ALPHA = r"[^\W\d_]"
_ALNUM = r"[^\W_]"
_NOT_ALPHA = r"[\W\d_]"

_JUNK_RE = re.compile(r"[\x00-\x1f]")
_SPECIALS_RE = re.compile(r"([^\w\s.'`,\-]|_)", re.UNICODE)
_MULTIDOT_RE = re.compile(r"\.([.]+)")

_ESCAPES = (("&", "&amp;"), ("|", "&#124;"), ("<", "&lt;"), (">", "&gt;"),
            ("'", "&apos;"), ('"', "&quot;"), ("[", "&#91;"), ("]", "&#93;"))


class MosesTokenizer:
    """tokenizer.perl behavior for en/de/fr (other langs: generic rules)."""

    def __init__(self, lang: str = "en", *, aggressive_hyphen: bool = False,
                 escape: bool = False, prefix_file: Optional[str] = None):
        self.lang = lang
        self.aggressive_hyphen = aggressive_hyphen
        self.escape = escape
        self.prefixes = (load_prefix_file(prefix_file) if prefix_file
                         else _PREFIX_TABLES.get(lang, _PREFIX_TABLES["en"]))

    # -- apostrophe rule sets ------------------------------------------------
    _EN_APOS = [
        (re.compile(rf"({_NOT_ALPHA})'({_NOT_ALPHA})"), r"\1 ' \2"),
        (re.compile(rf"([\W_])'({_ALPHA})"), r"\1 ' \2"),
        (re.compile(rf"({_ALPHA})'({_NOT_ALPHA})"), r"\1 ' \2"),
        (re.compile(rf"({_ALPHA})'({_ALPHA})"), r"\1 '\2"),
        (re.compile(r"(\d)'(s)"), r"\1 '\2"),
    ]
    _FR_APOS = [
        (re.compile(rf"({_NOT_ALPHA})'({_NOT_ALPHA})"), r"\1 ' \2"),
        (re.compile(rf"({_NOT_ALPHA})'({_ALPHA})"), r"\1 ' \2"),
        (re.compile(rf"({_ALPHA})'({_NOT_ALPHA})"), r"\1 ' \2"),
        (re.compile(rf"({_ALPHA})'({_ALPHA})"), r"\1' \2"),
    ]

    def tokenize(self, line: str, return_str: bool = False):
        text = " " + line + " "
        text = _JUNK_RE.sub("", text)
        text = re.sub(r"\s+", " ", text)

        # separate every special character (incl. '_', which Python's \w
        # includes but Perl's IsAlnum does not)
        text = _SPECIALS_RE.sub(r" \1 ", text)

        if self.aggressive_hyphen:
            text = re.sub(rf"({_ALNUM})-(?={_ALNUM})", r"\1 @-@ ", text)

        # multi-dot protection
        text = _MULTIDOT_RE.sub(lambda m: " DOTMULTI" + m.group(1), text)
        while "DOTMULTI." in text:
            text = re.sub(r"DOTMULTI\.([^.])", r"DOTDOTMULTI \1", text)
            text = text.replace("DOTMULTI.", "DOTDOTMULTI")

        # commas: split unless between digits
        text = re.sub(r"([^\d]),", r"\1 , ", text)
        text = re.sub(r",([^\d])", r" , \1", text)

        if self.lang == "en":
            for pat, rep in self._EN_APOS:
                text = pat.sub(rep, text)
        elif self.lang in ("fr", "it", "ga", "ca"):
            for pat, rep in self._FR_APOS:
                text = pat.sub(rep, text)
        else:
            text = text.replace("'", " ' ")
        text = text.replace("`", " ` ")

        # word-final periods vs nonbreaking prefixes
        words = text.split()
        out_words: List[str] = []
        for i, w in enumerate(words):
            m = re.match(r"^(\S+)\.$", w)
            if m:
                pre = m.group(1)
                nxt = words[i + 1] if i + 1 < len(words) else ""
                keep = False
                if "." in pre and re.search(_ALPHA, pre):
                    keep = True                      # U.S.A. / i.e.
                elif self.prefixes.get(pre) == 1:
                    keep = True                      # Mr. / z. (de)
                elif nxt and re.match(r"^[a-zà-öø-ÿ]", nxt):
                    keep = True                      # followed by lowercase
                elif self.prefixes.get(pre) == 2 and re.match(r"^[0-9]", nxt):
                    keep = True                      # No. 5
                if not keep:
                    w = pre + " ."
            out_words.append(w)
        text = " ".join(out_words)

        # restore protected dots
        while "DOTDOTMULTI" in text:
            text = text.replace("DOTDOTMULTI", "DOTMULTI.")
        text = text.replace("DOTMULTI", ".")

        if self.escape:
            for ch, ent in _ESCAPES:
                text = text.replace(ch, ent)

        text = re.sub(r"\s+", " ", text).strip()
        return text if return_str else text.split()


# ---------------------------------------------------------------------------
# Truecaser


class Truecaser:
    """train-truecaser.perl / truecase.perl semantics (see module docstring)."""

    def __init__(self, best: Optional[Dict[str, str]] = None,
                 known: Optional[set] = None):
        self.best: Dict[str, str] = best or {}
        self.known: set = known or set()

    _DELAYED = re.compile(r"^[\"'({\[¿¡«]+$")      # don't consume sentence start
    _SENT_END = {".", ":", "?", "!"}

    @classmethod
    def train(cls, token_lines: Iterable[List[str]]) -> "Truecaser":
        counts: Dict[str, Counter] = defaultdict(Counter)
        for toks in token_lines:
            start = True
            for w in toks:
                if cls._DELAYED.match(w):
                    continue  # quotes/brackets delay the sentence start
                if re.search(_ALPHA, w) and not start:
                    counts[w.lower()][w] += 1
                # train-truecaser.perl clears the sentence start on ANY
                # non-delayed token (a leading number/symbol consumes it,
                # so the word after "5" is NOT sentence-initial) and
                # re-arms it on sentence-ending punctuation.
                start = w in cls._SENT_END
        best = {}
        known = set()
        for lc, c in counts.items():
            best[lc] = c.most_common(1)[0][0]
            known.update(c)
        return cls(best, known)

    def truecase(self, toks: List[str]) -> List[str]:
        out = []
        start = True
        for w in toks:
            if self._DELAYED.match(w):
                out.append(w)
                continue
            lw = w.lower()
            if re.search(_ALPHA, w):
                if start and lw in self.best:
                    w = self.best[lw]
                elif w in self.known:
                    pass                               # seen this exact form
                elif lw in self.best:
                    w = self.best[lw]                  # unseen casing -> best
            # truecase.perl: ANY non-delayed token consumes the sentence
            # start; sentence-ending punctuation re-arms it (see train()).
            start = w in self._SENT_END
            out.append(w)
        return out

    @staticmethod
    def detruecase(toks: List[str]) -> List[str]:
        """detruecase.perl: uppercase the first alphabetic token's initial."""
        out = list(toks)
        for i, w in enumerate(out):
            if re.search(_ALPHA, w):
                out[i] = w[0].upper() + w[1:]
                break
        return out

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"best": self.best, "known": sorted(self.known)}, f,
                      ensure_ascii=False)

    @classmethod
    def load(cls, path: str) -> "Truecaser":
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        return cls(d["best"], set(d["known"]))


# ---------------------------------------------------------------------------
# Detokenizer (detokenizer.perl core rules)

_LEFT_ATTACH = set(".,;:!?%)]}»…")       # attach to the preceding token
_RIGHT_ATTACH = set("([{«¿¡$")           # attach to the following token


def moses_detokenize(tokens: List[str], lang: str = "en") -> str:
    out = ""
    # paired-quote state for straight DOUBLE quotes only — Moses
    # detokenizer.perl treats bare single quotes with its generic
    # right-attach rules (apostrophes are handled by the contraction
    # branch), so there is deliberately no single-quote pairing state
    quote_open = {'"': False}
    prepend_next = False
    for tok in tokens:
        if tok and all(c in _LEFT_ATTACH for c in tok):
            out += tok
        elif tok and all(c in _RIGHT_ATTACH for c in tok):
            out += ("" if prepend_next or not out else " ") + tok
            prepend_next = True
            continue
        elif tok == '"':
            if quote_open['"']:
                out += tok               # closing: attach left
            else:
                out += ("" if prepend_next or not out else " ") + tok
                prepend_next = True
                quote_open['"'] = not quote_open['"']
                continue
            quote_open['"'] = not quote_open['"']
        elif (lang == "en" and tok.startswith("'") and out
              and re.search(rf"{_ALPHA}$", out)):
            out += tok                   # don 't -> don't ; John 's -> John's
        elif (lang == "fr" and out.endswith("'")
              and re.search(_ALPHA, tok)):
            out += tok                   # l' homme -> l'homme
        elif prepend_next or not out:
            out += tok
        else:
            out += " " + tok
        prepend_next = False
    return out
