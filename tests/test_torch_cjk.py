"""The port's CJK analyzers (deeplearning4j_tpu_torch/nlp/cjk.py, a copy of
the JAX package's host code) against the JAX package's: every input of
tests/test_cjk.py gives the same tokens and morphs in both packages."""

import sys
import types

import pytest

from deeplearning4j_tpu.nlp import cjk as jcjk
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.nlp import vectorizers as jvec
from deeplearning4j_tpu_torch.nlp import cjk as tcjk
from deeplearning4j_tpu_torch.nlp import tokenization as ttok
from deeplearning4j_tpu_torch.nlp import vectorizers as tvec

SUMOMO = [("すもも", "noun"), ("もも", "noun"), ("もの", "noun"),
          ("うち", "noun"), ("も", "particle"), ("の", "particle")]


def _morphs(toks):
    return [(t.surface, t.pos, t.known) for t in toks]


def _lattice(c, entries=None):
    return c.LatticeSegmenter() if entries is None else \
        c.LatticeSegmenter(entries=list(entries))


# (case id, fn(cjk module, tokenization module) -> comparable result)
CASES = [
    ("dict_known_words", lambda c, t: c.DictionarySegmenter().segment(
        "私は猫が好き")),
    ("dict_multichar", lambda c, t: c.DictionarySegmenter().segment(
        "日本の学校")),
    ("dict_unknown_runs", lambda c, t: [
        c.DictionarySegmenter(words=["東京"]).segment(s)
        for s in ("東京圏", "圏域")]),
    ("dict_longest_match", lambda c, t: c.DictionarySegmenter().segment(
        "電車で行く")),
    ("dict_empty", lambda c, t: c.DictionarySegmenter().segment("")),
    ("dict_unigram_on_sumomo", lambda c, t: c.DictionarySegmenter(
        words=["すもも", "もも", "もの", "うち"]).segment(
            "すもももももももものうち")),
    ("factory_mixed_text", lambda c, t: c.DictionaryTokenizerFactory()
     .create("私は TPU で学習する。毎日！").get_tokens()),
    ("factory_preprocessor", lambda c, t: c.DictionaryTokenizerFactory()
     .set_token_pre_processor(t.LowCasePreprocessor())
     .create("GPU と 猫").get_tokens()),
    ("factory_corpora", lambda c, t: [
        c.DictionaryTokenizerFactory().create(s).get_tokens()
        for s in ("私は猫が好き", "彼は犬が好き", "彼は猫が好き",
                  "私は犬が好き", "彼女は犬が好き", "猫が好き")]),
    ("lattice_sumomo", lambda c, t: (
        _lattice(c, SUMOMO).segment("すもももももももものうち"),
        _morphs(_lattice(c, SUMOMO).tokenize("すもももももももものうち")))),
    ("lattice_unknown_kanji_and_katakana", lambda c, t: [
        _morphs(_lattice(c).tokenize(s))
        for s in ("東京圏", "コンピュータの音楽")]),
    ("lattice_word_inside_unknown_run", lambda c, t: _morphs(
        _lattice(c, [("メラ", "noun")]).tokenize("カメラ"))),
    ("lattice_factory_sumomo_corpus", lambda c, t: [
        c.DictionaryTokenizerFactory(segmenter=_lattice(c, SUMOMO))
        .create(s).get_tokens()
        for s in ("すもももももももものうち", "ももの話", "うちの話")]),
    ("keep_pos_content_words", lambda c, t: [
        c.DictionaryTokenizerFactory(
            segmenter=c.LatticeSegmenter(),
            keep_pos={"noun", "verb", "adj"}).create(s).get_tokens()
        for s in ("私は猫が好き", "私は TPU が好き")]),
    ("keep_pos_nouns_adjs", lambda c, t: [
        c.DictionaryTokenizerFactory(
            segmenter=c.LatticeSegmenter(),
            keep_pos={"noun", "adj"}).create(s).get_tokens()
        for s in ("私は猫が好き", "彼は犬が好き")]),
    ("porter_stems", lambda c, t: [
        t.StemmerPreProcessor().pre_process(w)
        for w in ("caresses", "ponies", "hopping", "filing", "relational",
                  "sized", "generalization", "happy", "oscillators",
                  "agreed")]),
    ("stemmer_factory", lambda c, t: [
        t.DefaultTokenizerFactory().set_token_pre_processor(
            t.StemmerPreProcessor()).create(s).get_tokens()
        for s in ("cats running fast", "cat runs faster",
                  "dogs running slowly")]),
    ("korean_josa", lambda c, t: [
        c.KoreanTokenizerFactory().create(s).get_tokens()
        for s in ("고양이는 우유를 마신다", "학교에서 공부한다",
                  "강아지는 물을 마신다", "고양이 귀엽다", "고양이가 논다",
                  "우유를 마신다.", "회의실에서 공부한다")]),
    ("korean_drop_josa", lambda c, t: [
        c.KoreanTokenizerFactory(emit_josa=False).create(s).get_tokens()
        for s in ("고양이는 물을 마신다", "나 는 간다", "고양이 우유 바나나")]),
    ("korean_add_noun", lambda c, t: c.KoreanTokenizerFactory()
     .add_noun("판다").create("판다가 잔다").get_tokens()),
]


@pytest.mark.parametrize("fn", [f for _, f in CASES],
                         ids=[n for n, _ in CASES])
def test_same_tokens_and_morphs(fn):
    want = fn(jcjk, jtok)
    assert fn(tcjk, ttok) == want


@pytest.mark.parametrize("kind", ["dictionary", "lattice"])
def test_loaded_dictionaries_segment_alike(tmp_path, kind):
    p = tmp_path / "lex.tsv"
    if kind == "dictionary":
        p.write_text("深層学習\t1.0\n学習\n", encoding="utf-8")
        got = [c.DictionarySegmenter(words=[]).load_dictionary(str(p))
               .segment("深層学習") for c in (jcjk, tcjk)]
    else:
        p.write_text("深層学習\t1.0\tnoun\nを\t\tparticle\n",
                     encoding="utf-8")
        got = [_morphs(c.LatticeSegmenter(entries=[])
                       .load_dictionary(str(p)).tokenize("深層学習を"))
               for c in (jcjk, tcjk)]
    assert got[1] == got[0]


def test_keep_pos_refusal_matches():
    for c in (jcjk, tcjk):
        with pytest.raises(ValueError, match="POS-aware"):
            c.DictionaryTokenizerFactory(
                segmenter=c.DictionarySegmenter(), keep_pos={"noun"})


def test_mecab_wrapper_raises_and_plugs_in_alike(monkeypatch):
    for c in (jcjk, tcjk):
        with pytest.raises(ImportError, match="MeCab binding"):
            c.mecab_tokenizer_factory()

    class _Word:
        def __init__(self, surface):
            self.surface = surface

    class _Tagger:
        def __call__(self, text):
            return [_Word(t) for t in text.split("|")]

    stub = types.ModuleType("fugashi")
    stub.Tagger = _Tagger
    monkeypatch.setitem(sys.modules, "fugashi", stub)
    got = [c.mecab_tokenizer_factory().create("猫|が|好き").get_tokens()
           for c in (jcjk, tcjk)]
    assert got[1] == got[0] == ["猫", "が", "好き"]


def test_tfidf_through_the_lattice_seam_matches():
    """The lattice parse through the vectorizer seam gives the same vocab
    and weights in both packages."""
    docs = ["すもももももももものうち", "ももの話", "うちの話"]
    rows = []
    for c, v in ((jcjk, jvec), (tcjk, tvec)):
        vec = v.TfidfVectorizer(tokenizer_factory=c.DictionaryTokenizerFactory(
            segmenter=_lattice(c, SUMOMO)))
        vec.fit(docs)
        rows.append(([w.word for w in vec.vocab.vocab_words],
                     vec.transform(docs[0]).tolist()))
    assert rows[1] == rows[0]
