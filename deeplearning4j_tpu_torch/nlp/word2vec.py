"""Word2Vec — user-facing API over SequenceVectors (counterpart of
deeplearning4j_tpu/nlp/word2vec.py).

Parity: models/word2vec/Word2Vec.java (606 LoC): builder-configured,
consumes a SentenceIterator + TokenizerFactory, exposes similarity /
wordsNearest / getWordVector (SURVEY.md §2.6, baseline #4).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nlp.sequence_vectors import (
    SequenceVectors,
    SequenceVectorsConfig,
)
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory


class Word2Vec(SequenceVectors):
    """word2vec over sentences; the tables live on ``device`` (None: the
    card).

    >>> w2v = Word2Vec(vector_size=50, window=5, negative=5)
    >>> w2v.fit_sentences(sentence_iterator, DefaultTokenizerFactory())
    >>> w2v.words_nearest("day")
    """

    def __init__(self, config: SequenceVectorsConfig | None = None,
                 device=None, **kw):
        super().__init__(config, device=device, **kw)
        self._tokenized = None

    def _tokenize_all(self, sentence_iterator, tokenizer_factory):
        tf = tokenizer_factory or DefaultTokenizerFactory()
        out = []
        for sentence in sentence_iterator:
            tokens = tf.create(sentence).get_tokens()
            if tokens:
                out.append(tokens)
        sentence_iterator.reset()
        return out

    def fit_sentences(self, sentence_iterator, tokenizer_factory=None):
        """buildVocab + fit over a SentenceIterator (Word2Vec.fit parity)."""
        self._tokenized = self._tokenize_all(sentence_iterator,
                                             tokenizer_factory)
        self.build_vocab(self._tokenized)
        return self.fit(self._tokenized)
