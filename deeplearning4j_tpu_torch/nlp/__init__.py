"""NLP stack (counterpart of deeplearning4j_tpu/nlp; parity:
deeplearning4j-nlp-parent, SURVEY.md §2.6): tokenization pipeline, vocab
+ Huffman, batched SkipGram/CBOW/PV-DM/PV-DBOW/GloVe steps on the tables'
device (the card by default), word-vector serializers, the multi-process
trainer and the CJK analyzers."""

from deeplearning4j_tpu_torch.nlp.sequence_vectors import (
    SequenceVectors,
    SequenceVectorsConfig,
)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.vectorizers import (
    BagOfWordsVectorizer,
    TfidfVectorizer,
)
from deeplearning4j_tpu_torch.nlp.distributed import (
    MultiProcessSequenceVectors,
)
from deeplearning4j_tpu_torch.nlp.cjk import (
    DictionarySegmenter,
    DictionaryTokenizerFactory,
    KoreanTokenizerFactory,
    LatticeSegmenter,
    MorphToken,
)
