"""The port's bag-of-words and TF-IDF vectorizers
(deeplearning4j_tpu_torch/nlp/vectorizers.py) against the JAX package's on
tests/test_vectorizers.py's corpora: the same vocab, matrices bit-equal,
and ``vectorize`` gives the port's DataSet with the same arrays."""

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.nlp import vectorizers as jvec
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nlp import tokenization as ttok
from deeplearning4j_tpu_torch.nlp import vectorizers as tvec

CORPUS = [
    "the cat sat on the mat",
    "the dog sat on the log",
    "cats and dogs",
]
APPLES = ["apple banana", "apple cherry", "apple date"]

# (id, class name, constructor kwargs, fit corpus, documents to transform)
CASES = [
    ("bow_counts", "BagOfWordsVectorizer", {}, CORPUS, CORPUS),
    ("bow_corpus_frequency", "BagOfWordsVectorizer",
     {"corpus_frequency": True}, CORPUS, CORPUS),
    ("bow_min_frequency_stop_words", "BagOfWordsVectorizer",
     {"min_word_frequency": 2, "stop_words": ["the", "on"]}, CORPUS,
     ["sat sat unknown"] + CORPUS),
    ("tfidf_known_values", "TfidfVectorizer", {}, CORPUS, CORPUS),
    ("tfidf_unseen_document", "TfidfVectorizer", {}, CORPUS,
     ["cat cat zebra"]),
    ("tfidf_idf_all_docs", "TfidfVectorizer", {}, APPLES,
     ["apple apple"] + APPLES),
    ("tfidf_preprocessed", "TfidfVectorizer", {"common_preprocessor": True},
     ["The CAT, sat!", "a dog."], ["the cat sat", "A DOG!"]),
]


def _fitted(vec_mod, tok_mod, cls, kw, corpus):
    kw = dict(kw)
    if kw.pop("common_preprocessor", False):
        kw["tokenizer_factory"] = tok_mod.DefaultTokenizerFactory() \
            .set_token_pre_processor(tok_mod.CommonPreprocessor())
    return getattr(vec_mod, cls)(**kw).fit(list(corpus))


@pytest.mark.parametrize("cls,kw,corpus,docs",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_matrices_equal_the_jax_package(cls, kw, corpus, docs):
    j = _fitted(jvec, jtok, cls, kw, corpus)
    t = _fitted(tvec, ttok, cls, kw, corpus)
    assert [w.word for w in t.vocab.vocab_words] == \
        [w.word for w in j.vocab.vocab_words]
    assert [w.count for w in t.vocab.vocab_words] == \
        [w.count for w in j.vocab.vocab_words]
    jm, tm = j.transform(docs), t.transform(docs)
    assert tm.dtype == jm.dtype == np.float32
    np.testing.assert_array_equal(tm, jm)
    for d in docs:
        np.testing.assert_array_equal(t.transform(d), j.transform(d))
    if cls == "TfidfVectorizer":
        assert [t.idf(w) for w in ("apple", "cat", "zebra", "sat")] == \
            [j.idf(w) for w in ("apple", "cat", "zebra", "sat")]


def test_fit_transform_equals_the_jax_package():
    for cls in ("BagOfWordsVectorizer", "TfidfVectorizer"):
        np.testing.assert_array_equal(
            getattr(tvec, cls)().fit_transform(CORPUS),
            getattr(jvec, cls)().fit_transform(CORPUS))


def test_vectorize_gives_the_ports_dataset():
    out = []
    for vec_mod in (jvec, tvec):
        v = vec_mod.TfidfVectorizer()
        v.fit(CORPUS, labels=["pets", "pets", "animals"])
        ds = v.vectorize("the cat", "animals")
        ds2 = v.vectorize("dogs and cats", "birds")
        out.append((v.labels_source.labels, ds, ds2))
    (jl, jd, jd2), (tl, td, td2) = out
    assert isinstance(td, DataSet)
    assert tl == jl == ["pets", "animals", "birds"]
    for a, b in ((td, jd), (td2, jd2)):
        np.testing.assert_array_equal(a.features, np.asarray(b.features))
        np.testing.assert_array_equal(a.labels, np.asarray(b.labels))
    np.testing.assert_array_equal(td.labels, [[0.0, 1.0]])
