"""Word-vector serialization: word2vec text + Google binary formats
(counterpart of deeplearning4j_tpu/nlp/serializers.py; the files are the
JAX package's byte for byte, so tables cross between the packages).

Parity: models/embeddings/loader/WordVectorSerializer.java — writeWordVectors
(text: "word v1 v2 ..."), readWord2VecModel, and the Google word2vec binary
format (header "V D\n" then per word: "word " + D float32 little-endian).
The readers put the table on ``device`` (None: the card).
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_huffman


def _syn0(lookup: InMemoryLookupTable) -> np.ndarray:
    return lookup.syn0.detach().cpu().numpy().astype(np.float32, copy=False)


def _lookup(cache: VocabCache, vecs: np.ndarray, device):
    cache.finalize_indices()
    build_huffman(cache)
    lookup = InMemoryLookupTable(cache, vecs.shape[1], use_hs=False,
                                 negative=0, device=device)
    lookup.syn0 = lookup._table(vecs)
    return lookup


def write_word_vectors(lookup: InMemoryLookupTable, path: str):
    """Text format (WordVectorSerializer.writeWordVectors parity)."""
    syn0 = _syn0(lookup)
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{syn0.shape[0]} {syn0.shape[1]}\n")
        for i in range(syn0.shape[0]):
            word = lookup.cache.word_for_index(i)
            vec = " ".join(f"{v:.6f}" for v in syn0[i])
            f.write(f"{word} {vec}\n")


def read_word_vectors(path: str, device=None) -> InMemoryLookupTable:
    """Read the text format back (loadTxtVectors parity)."""
    with open(path, "r", encoding="utf-8") as f:
        header = f.readline().split()
        v, d = int(header[0]), int(header[1])
        cache = VocabCache()
        vecs = np.empty((v, d), np.float32)
        for i in range(v):
            parts = f.readline().rstrip("\n").split(" ")
            word = parts[0]
            vecs[i] = [float(x) for x in parts[1:d + 1]]
            cache.add(word, count=v - i)  # preserve index order
    return _lookup(cache, vecs, device)


def write_word2vec_binary(lookup: InMemoryLookupTable, path: str):
    """Google word2vec .bin format (writeWordVectors binary parity)."""
    syn0 = _syn0(lookup)
    with open(path, "wb") as f:
        f.write(f"{syn0.shape[0]} {syn0.shape[1]}\n".encode("utf-8"))
        for i in range(syn0.shape[0]):
            word = lookup.cache.word_for_index(i)
            f.write(word.encode("utf-8") + b" ")
            f.write(syn0[i].tobytes())
            f.write(b"\n")


def read_word2vec_binary(path: str, device=None) -> InMemoryLookupTable:
    """Read Google word2vec .bin (readBinaryModel parity)."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").split()
        v, d = int(header[0]), int(header[1])
        cache = VocabCache()
        vecs = np.empty((v, d), np.float32)
        for i in range(v):
            word = bytearray()
            while True:
                ch = f.read(1)
                if ch == b"":
                    raise ValueError(
                        f"Truncated word2vec binary file: header promised "
                        f"{v} words, hit EOF at word {i}")
                if ch == b" ":
                    break
                if ch != b"\n":
                    word.extend(ch)
            vecs[i] = np.frombuffer(f.read(4 * d), dtype=np.float32)
            nl = f.read(1)
            if nl not in (b"\n", b""):
                f.seek(-1, 1)
            cache.add(word.decode("utf-8"), count=v - i)
    return _lookup(cache, vecs, device)
