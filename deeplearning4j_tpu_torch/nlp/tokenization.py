"""Tokenization / corpus pipeline (counterpart of
deeplearning4j_tpu/nlp/tokenization.py; host code, kept as a copy).

Parity: deeplearning4j-nlp text/tokenization/ (TokenizerFactory ->
Tokenizer -> TokenPreProcess), text/sentenceiterator/ and
text/documentiterator/ (SURVEY.md §2.6). The pipeline shape is identical:
SentenceIterator -> TokenizerFactory.create(sentence) -> tokens ->
preprocessor per token. All host-side (CPU) code — tokenization never
touches the device.
"""

from __future__ import annotations

import re
from typing import Callable, Iterable, List, Optional


# ---------------------------------------------------------------------------
# Token preprocessors (text/tokenization/tokenizer/preprocessor/ parity)
# ---------------------------------------------------------------------------

class CommonPreprocessor:
    """Lowercase + strip punctuation (CommonPreprocessor.java parity)."""

    _PUNCT = re.compile(r"[\d.:,\"'()\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class LowCasePreprocessor:
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor:
    """Crude stemmer (EndingPreProcessor.java parity: strips s/ed/ing/ly)."""

    def pre_process(self, token: str) -> str:
        for suffix in ("ing", "ed", "ly", "s"):
            if token.endswith(suffix) and len(token) > len(suffix) + 2:
                return token[: -len(suffix)]
        return token


class StemmerPreProcessor:
    """Porter stemmer as a token pre-process — the StemmerAnnotator tier
    (deeplearning4j-nlp-uima/.../annotator/StemmerAnnotator.java wraps the
    Snowball English stemmer as a UIMA pipeline stage; here the stemmer IS
    the pre-process, pluggable into any TokenizerFactory via
    set_token_pre_processor). Implements the classic Porter algorithm
    (steps 1a-5b) rather than EndingPreProcessor's four-suffix strip."""

    _VOWELS = set("aeiou")

    def _cons(self, w: str, i: int) -> bool:
        c = w[i]
        if c in self._VOWELS:
            return False
        if c == "y":
            return i == 0 or not self._cons(w, i - 1)
        return True

    def _measure(self, stem: str) -> int:
        """Number of VC sequences (the m in Porter's [C](VC)^m[V])."""
        m, prev_v = 0, False
        for i in range(len(stem)):
            v = not self._cons(stem, i)
            if prev_v and not v:
                m += 1
            prev_v = v
        return m

    def _has_vowel(self, stem: str) -> bool:
        return any(not self._cons(stem, i) for i in range(len(stem)))

    def _cvc(self, stem: str) -> bool:
        if len(stem) < 3:
            return False
        return (self._cons(stem, -1 + len(stem)) and
                not self._cons(stem, len(stem) - 2) and
                self._cons(stem, len(stem) - 3) and
                stem[-1] not in "wxy")

    def _repl(self, w, rules, cond=None):
        """First matching (suffix, repl) rule whose stem passes ``cond``."""
        for suf, repl in rules:
            if w.endswith(suf):
                stem = w[: len(w) - len(suf)]
                if cond is None or cond(stem):
                    return stem + repl
                return w
        return w

    def pre_process(self, token: str) -> str:
        w = token.lower()
        if len(w) <= 2:
            return w
        # step 1a
        w = self._repl(w, (("sses", "ss"), ("ies", "i"), ("ss", "ss"),
                           ("s", "")))
        # step 1b
        if w.endswith("eed"):
            stem = w[:-3]
            if self._measure(stem) > 0:
                w = w[:-1]
        else:
            for suf in ("ed", "ing"):
                if w.endswith(suf) and self._has_vowel(w[: -len(suf)]):
                    w = w[: -len(suf)]
                    if w.endswith(("at", "bl", "iz")):
                        w += "e"
                    elif (len(w) > 1 and w[-1] == w[-2]
                          and self._cons(w, len(w) - 1)
                          and w[-1] not in "lsz"):
                        w = w[:-1]
                    elif self._measure(w) == 1 and self._cvc(w):
                        w += "e"
                    break
        # step 1c
        if w.endswith("y") and self._has_vowel(w[:-1]):
            w = w[:-1] + "i"
        # step 2
        w = self._repl(w, (
            ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
            ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
            ("alli", "al"), ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
            ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
            ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
            ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
            ("biliti", "ble")), lambda s: self._measure(s) > 0)
        # step 3
        w = self._repl(w, (
            ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
            ("ical", "ic"), ("ful", ""), ("ness", "")),
            lambda s: self._measure(s) > 0)
        # step 4
        w = self._repl(w, (
            ("al", ""), ("ance", ""), ("ence", ""), ("er", ""), ("ic", ""),
            ("able", ""), ("ible", ""), ("ant", ""), ("ement", ""),
            ("ment", ""), ("ent", ""), ("ou", ""), ("ism", ""), ("ate", ""),
            ("iti", ""), ("ous", ""), ("ive", ""), ("ize", "")),
            lambda s: self._measure(s) > 1)
        if w.endswith(("sion", "tion")) and self._measure(w[:-3]) > 1:
            w = w[:-3]
        # step 5a
        if w.endswith("e"):
            stem = w[:-1]
            m = self._measure(stem)
            if m > 1 or (m == 1 and not self._cvc(stem)):
                w = stem
        # step 5b
        if (len(w) > 1 and w[-1] == "l" and w[-2] == "l"
                and self._measure(w) > 1):
            w = w[:-1]
        return w


# ---------------------------------------------------------------------------
# Tokenizers (text/tokenization/tokenizerfactory/ parity)
# ---------------------------------------------------------------------------

class DefaultTokenizer:
    """Whitespace tokenizer (DefaultTokenizer.java parity)."""

    def __init__(self, text: str, preprocessor=None):
        self._tokens = text.split()
        self._pre = preprocessor

    def get_tokens(self) -> List[str]:
        out = []
        for t in self._tokens:
            if self._pre is not None:
                t = self._pre.pre_process(t)
            if t:
                out.append(t)
        return out


class DefaultTokenizerFactory:
    def __init__(self):
        self._pre = None

    def set_token_pre_processor(self, pre):
        self._pre = pre
        return self

    def create(self, text: str) -> DefaultTokenizer:
        return DefaultTokenizer(text, self._pre)


class NGramTokenizerFactory(DefaultTokenizerFactory):
    """Emits n-grams joined by '_' (NGramTokenizerFactory.java parity)."""

    def __init__(self, n_min: int = 1, n_max: int = 2):
        super().__init__()
        self.n_min, self.n_max = n_min, n_max

    def create(self, text: str):
        base = DefaultTokenizer(text, self._pre).get_tokens()
        grams = []
        for n in range(self.n_min, self.n_max + 1):
            for i in range(len(base) - n + 1):
                grams.append("_".join(base[i:i + n]))

        class _T:
            def get_tokens(self_inner):
                return grams
        return _T()


# ---------------------------------------------------------------------------
# Sentence iterators (text/sentenceiterator/ parity)
# ---------------------------------------------------------------------------

def split_sentences(text: str) -> List[str]:
    """Split raw text into sentences — the SentenceAnnotator tier
    (deeplearning4j-nlp-uima/.../annotator/SentenceAnnotator.java wraps
    the UIMA sentence detector; here a rule-based splitter covering
    Latin terminators, CJK 。！？, and blank-line paragraph breaks).
    Abbreviation-safe for single-letter initials ("J. Smith")."""
    text = text.replace("\r\n", "\n").replace("\r", "\n")
    out: List[str] = []
    buf: List[str] = []
    quote_split = False  # terminator seen, closing quote still pending

    def flush():
        s = "".join(buf).strip()
        if s:
            out.append(s)
        buf.clear()

    for i, ch in enumerate(text):
        if ch == "\n":
            # blank line = hard break; single newline = soft space
            prev = text[i - 1] if i >= 1 else None
            nxt = text[i + 1] if i + 1 < len(text) else None
            quote_split = False
            if prev == "\n" or nxt == "\n":
                flush()
            elif buf and buf[-1] != " ":
                buf.append(" ")
            continue
        buf.append(ch)
        if quote_split:
            quote_split = False
            if ch == '"':  # keep the closing quote with its sentence
                flush()
                continue
        if ch in "。！？":
            flush()
        elif ch in ".!?":
            nxt = text[i + 1] if i + 1 < len(text) else None
            # "J. Smith": a period after a single capital is an initial
            initial = (ch == "." and i >= 1 and text[i - 1].isupper()
                       and (i < 2 or not text[i - 2].isalpha()))
            if initial:
                continue
            if nxt is None or nxt in (" ", "\t", "\n"):
                flush()
            elif nxt == '"':
                quote_split = True
    flush()
    return out


class DocumentSentenceIterator:
    """SentenceIterator over raw DOCUMENTS: each document is segmented by
    ``split_sentences`` (UimaSentenceIterator.java parity — the reference
    feeds documents through the UIMA sentence detector to get the
    sentence stream Word2Vec consumes)."""

    def __init__(self, documents: Iterable[str], splitter=split_sentences):
        self._docs = list(documents)
        self._splitter = splitter
        self._pre: Optional[Callable[[str], str]] = None

    def set_pre_processor(self, fn: Callable[[str], str]):
        self._pre = fn
        return self

    def __iter__(self):
        for doc in self._docs:
            for s in self._splitter(doc):
                yield self._pre(s) if self._pre is not None else s

    def reset(self):
        return self


class CollectionSentenceIterator:
    """Iterate over an in-memory list of sentences
    (CollectionSentenceIterator.java parity)."""

    def __init__(self, sentences: Iterable[str]):
        self._sentences = list(sentences)
        self._pre: Optional[Callable[[str], str]] = None

    def set_pre_processor(self, fn: Callable[[str], str]):
        self._pre = fn
        return self

    def __iter__(self):
        for s in self._sentences:
            yield self._pre(s) if self._pre else s

    def reset(self):
        pass


class BasicLineIterator:
    """One sentence per line from a file (BasicLineIterator.java parity)."""

    def __init__(self, path: str):
        self.path = path
        self._pre = None

    def set_pre_processor(self, fn):
        self._pre = fn
        return self

    def __iter__(self):
        with open(self.path, "r", encoding="utf-8", errors="ignore") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield self._pre(line) if self._pre else line

    def reset(self):
        pass


class LabelAwareIterator:
    """(label, text) document pairs for ParagraphVectors
    (text/documentiterator/LabelAwareIterator.java parity)."""

    def __init__(self, documents: Iterable):
        """documents: iterable of (label, text) or dict {label: text}."""
        if isinstance(documents, dict):
            documents = list(documents.items())
        self._docs = list(documents)

    def __iter__(self):
        return iter(self._docs)

    def labels(self):
        return [l for l, _ in self._docs]

    def reset(self):
        pass


class CJKCharTokenizerFactory(DefaultTokenizerFactory):
    """CJK-aware tokenizer: Han/Kana/Hangul runs are emitted as character
    bigrams (plus single chars for length-1 runs); other runs tokenize as
    whitespace/word tokens.

    Substitution note (SURVEY.md §2.0/§2.6): the reference vendors the
    Kuromoji Japanese morphological analyzer (deeplearning4j-nlp-japanese,
    ~6.8k LoC) and UIMA/Korean annotator plug-ins — host-side text
    plumbing with no TPU relevance. Character n-gram segmentation is the
    standard analyzer-free baseline for CJK embedding training; a real
    analyzer can be plugged in through this same TokenizerFactory seam
    (the reference's own extension point)."""

    _CJK = (
        (0x3040, 0x30FF),   # hiragana + katakana
        (0x4E00, 0x9FFF),   # CJK unified ideographs
        (0x3400, 0x4DBF),   # CJK extension A
        (0xAC00, 0xD7AF),   # hangul syllables
        (0xF900, 0xFAFF),   # CJK compatibility ideographs
    )

    @classmethod
    def _is_cjk(cls, ch: str) -> bool:
        cp = ord(ch)
        return any(lo <= cp <= hi for lo, hi in cls._CJK)

    def create(self, text: str):
        tokens: List[str] = []
        run = []

        def flush_run():
            if not run:
                return
            s = "".join(run)
            if len(s) == 1:
                tokens.append(s)
            else:
                tokens.extend(s[i:i + 2] for i in range(len(s) - 1))
            run.clear()

        word = []

        def flush_word():
            if word:
                tokens.append("".join(word))
                word.clear()

        for ch in text:
            if self._is_cjk(ch):
                flush_word()
                run.append(ch)
            elif ch.isspace() or not (ch.isalnum() or ch in "'-_"):
                flush_run()
                flush_word()
            else:
                flush_run()
                word.append(ch)
        flush_run()
        flush_word()
        tok = DefaultTokenizer("", self._pre)
        tok._tokens = tokens
        return tok
