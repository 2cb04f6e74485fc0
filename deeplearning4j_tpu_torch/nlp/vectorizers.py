"""Text vectorizers: bag-of-words counts and TF-IDF document vectors
(counterpart of deeplearning4j_tpu/nlp/vectorizers.py; host code).

Parity: deeplearning4j-nlp bagofwords/vectorizer/ —
``BaseTextVectorizer.java`` (corpus scan -> vocab via TokenizerFactory +
min word frequency + stop words, ``buildVocab`` :40), ``TfidfVectorizer
.java:35`` (``transform`` :105: per-document term counts -> tf-idf with
tf = count/docLength and idf = log10(totalDocs/docFreq), MathUtils
.java:258,271,283) and ``BagOfWordsVectorizer.java:32``.

Semantics notes (pinned by tests/test_vectorizers.py):
- tf-idf of a word absent from the document (or pruned from the vocab)
  is 0; idf uses log10 (the reference's MathUtils.idf), so a word
  appearing in ALL documents gets weight 0.
- ``BagOfWordsVectorizer.transform`` in the reference writes the
  corpus-wide ``wordFrequency`` at each present token's column
  (BagOfWordsVectorizer.java:81), NOT the in-document count. The default
  here is the in-document count (the standard bag-of-words feature a
  downstream classifier needs); pass ``corpus_frequency=True`` for the
  reference's exact behavior.

All host-side code: vectorization is input-pipeline work; the resulting
dense [n_docs, vocab] matrices are host arrays in the port's DataSet,
which ``fit`` moves to the card as it moves any batch.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class LabelsSource:
    """Ordered label registry (documentiterator/LabelsSource.java parity):
    labels get stable indices in first-seen order."""

    def __init__(self, labels: Optional[Iterable[str]] = None):
        self._labels: List[str] = []
        self._index = {}
        for l in labels or ():
            self.add(l)

    def add(self, label: str) -> int:
        if label not in self._index:
            self._index[label] = len(self._labels)
            self._labels.append(label)
        return self._index[label]

    def index_of(self, label: str) -> int:
        return self._index.get(label, -1)

    @property
    def labels(self) -> List[str]:
        return list(self._labels)

    def __len__(self):
        return len(self._labels)


class BaseTextVectorizer:
    """Corpus scan -> vocab + document frequencies (BaseTextVectorizer
    .java:40 buildVocab). Subclasses define the per-document weighting."""

    def __init__(self, tokenizer_factory=None, min_word_frequency: int = 1,
                 stop_words: Sequence[str] = ()):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.stop_words = set(stop_words)
        self.vocab = VocabCache()
        self.doc_freq: Counter = Counter()   # word -> #docs containing it
        self.n_docs = 0
        self.labels_source = LabelsSource()

    # ------------------------------------------------------------------ fit
    def _tokens(self, text: str) -> List[str]:
        toks = self.tokenizer_factory.create(text).get_tokens()
        return [t for t in toks if t and t not in self.stop_words]

    def fit(self, documents: Iterable[str],
            labels: Optional[Iterable[str]] = None):
        """Scan the corpus: token counts, document frequencies, vocab
        pruning by ``min_word_frequency``, label registry."""
        counts = Counter()
        docs = 0
        for i, text in enumerate(documents):
            toks = self._tokens(text)
            counts.update(toks)
            self.doc_freq.update(set(toks))
            docs += 1
        self.n_docs = docs
        for word, c in counts.items():
            if c >= self.min_word_frequency:
                self.vocab.add(word, c)
        self.vocab.finalize_indices()
        if labels is not None:
            for l in labels:
                self.labels_source.add(l)
        return self

    # ------------------------------------------------------------ transform
    def _weight(self, word: str, doc_count: int, doc_len: int) -> float:
        raise NotImplementedError

    def transform_tokens(self, tokens: List[str]) -> np.ndarray:
        """[vocab]-sized weight row for one tokenized document
        (TfidfVectorizer.java:105 transform(List<String>))."""
        out = np.zeros((len(self.vocab),), np.float32)
        counts = Counter(tokens)
        for word, c in counts.items():
            idx = self.vocab.index_of(word)
            if idx >= 0:
                out[idx] = self._weight(word, c, len(tokens))
        return out

    def transform(self, documents) -> np.ndarray:
        """One doc (str) -> [vocab]; list of docs -> [n_docs, vocab]."""
        if isinstance(documents, str):
            return self.transform_tokens(self._tokens(documents))
        return np.stack([self.transform_tokens(self._tokens(d))
                         for d in documents])

    def fit_transform(self, documents: Sequence[str],
                      labels: Optional[Iterable[str]] = None) -> np.ndarray:
        docs = list(documents)
        self.fit(docs, labels)
        return self.transform(docs)

    def vectorize(self, text: str, label: str) -> DataSet:
        """One (document, label) -> DataSet(weights row, one-hot label)
        (TfidfVectorizer.java:66 vectorize)."""
        self.labels_source.add(label)
        x = self.transform(text)[None, :]
        y = np.zeros((1, len(self.labels_source)), np.float32)
        y[0, self.labels_source.index_of(label)] = 1.0
        return DataSet(x, y)


class BagOfWordsVectorizer(BaseTextVectorizer):
    """Count vectorizer (BagOfWordsVectorizer.java:32). Default weight is
    the in-document count; ``corpus_frequency=True`` reproduces the
    reference's transform exactly (global wordFrequency at each present
    column, BagOfWordsVectorizer.java:81)."""

    def __init__(self, tokenizer_factory=None, min_word_frequency: int = 1,
                 stop_words: Sequence[str] = (),
                 corpus_frequency: bool = False):
        super().__init__(tokenizer_factory, min_word_frequency, stop_words)
        self.corpus_frequency = corpus_frequency

    def _weight(self, word, doc_count, doc_len):
        if self.corpus_frequency:
            return float(self.vocab.words[word].count)
        return float(doc_count)


class TfidfVectorizer(BaseTextVectorizer):
    """TF-IDF vectorizer (TfidfVectorizer.java:35): weight =
    (count/docLength) * log10(totalDocs/docFreq)."""

    def idf(self, word: str) -> float:
        """MathUtils.idf parity: log10(totalDocs / docsContainingWord);
        0 when the corpus is empty or the word was never seen."""
        df = self.doc_freq.get(word, 0)
        if self.n_docs == 0 or df == 0:
            return 0.0
        return math.log10(self.n_docs / df)

    def _weight(self, word, doc_count, doc_len):
        tf = doc_count / doc_len if doc_len else 0.0
        return float(tf * self.idf(word))
