"""Token pipeline stages (counterpart of
deeplearning4j_tpu/datapipe/tokens.py): tokenize → window →
``bucket_batch``.

A language-model pipeline is text records in, next-token training pairs
out: ``TokenizeStage`` maps text to int token ids, ``WindowStage`` slices
each token stream into (possibly overlapping) windows and emits
``(x_onehot [t, V], y_onehot [t, V])`` next-token records whose variable
tail lengths are exactly what ``BucketBatchStage``'s padded-length ladder
exists for. Both stages follow the datapipe core contract — iteration
state in instance attributes, O(window) checkpoint state — so a
``resilient_fit`` over a token pipeline resumes mid-epoch bit-identically
like every other source.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datapipe.core import (Stage, decode_state_value,
                                              encode_state_value)

__all__ = ["CharTokenizer", "TokenizeStage", "WindowStage"]


class CharTokenizer:
    """Character-level tokenizer: vocabulary = sorted distinct characters
    of the fitted corpus. Stateless after construction; ``state_dict``
    round-trips through JSON so a pipeline checkpoint can pin the exact
    id mapping it trained with."""

    def __init__(self, vocab: str):
        self.vocab = "".join(sorted(set(vocab)))
        self._stoi = {c: i for i, c in enumerate(self.vocab)}

    @classmethod
    def fit(cls, text: str) -> "CharTokenizer":
        return cls(text)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str) -> np.ndarray:
        """Unknown characters map to id 0 (the reference's UNK-to-first
        convention for its word-vector lookup tables)."""
        stoi = self._stoi
        return np.asarray([stoi.get(c, 0) for c in text], np.int32)

    def decode(self, ids) -> str:
        v = self.vocab
        return "".join(v[int(i) % len(v)] for i in np.asarray(ids).ravel())

    def one_hot(self, ids) -> np.ndarray:
        out = np.zeros((len(ids), self.vocab_size), np.float32)
        out[np.arange(len(ids)), np.asarray(ids, np.int64)] = 1.0
        return out

    def state_dict(self) -> dict:
        return {"vocab": self.vocab}

    @classmethod
    def from_state_dict(cls, state: dict) -> "CharTokenizer":
        return cls(state["vocab"])


class TokenizeStage(Stage):
    """Map text records ``(str, ...)`` to token-id records
    ``([t] int32, ...)``. Stateless beyond the upstream cursor (the map
    is deterministic)."""

    name = "tokenize"

    def __init__(self, upstream: Stage, tokenizer: CharTokenizer):
        super().__init__(upstream)
        self.tokenizer = tokenizer

    def __iter__(self):
        for rec in self.upstream:
            ids = self.tokenizer.encode(rec[0])
            self.records_out += 1
            yield (ids,) + tuple(rec[1:])


class WindowStage(Stage):
    """Slice token-stream records into next-token training windows.

    Each upstream record's field 0 is a token-id array; every ``stride``
    tokens a window of ``size + 1`` ids is cut and emitted as
    ``(one_hot(w[:-1]), one_hot(w[1:]))`` — ``[t, V]`` features and
    per-timestep labels, ``t <= size``. The final partial window of each
    document is kept when it holds >= 2 tokens, so real corpora emit the
    variable lengths the bucket ladder pads. With ``vocab_size=None`` the
    raw id windows pass through as ``(w,)`` records.

    Checkpoint state: the in-progress document and the window cursor —
    bounded by the longest document, the same O(window) promise as
    ``ShuffleStage``.
    """

    name = "window"

    def __init__(self, upstream: Stage, size: int,
                 stride: Optional[int] = None,
                 vocab_size: Optional[int] = None):
        super().__init__(upstream)
        if size < 1:
            raise ValueError("window size must be >= 1")
        self.size = int(size)
        self.stride = int(stride or size)
        self.vocab_size = None if vocab_size is None else int(vocab_size)
        self._doc: Optional[np.ndarray] = None
        self._off = 0

    def _emit(self, w: np.ndarray) -> tuple:
        if self.vocab_size is None:
            return (w,)
        v = self.vocab_size
        x = np.zeros((len(w) - 1, v), np.float32)
        x[np.arange(len(w) - 1), w[:-1].astype(np.int64)] = 1.0
        y = np.zeros((len(w) - 1, v), np.float32)
        y[np.arange(len(w) - 1), w[1:].astype(np.int64)] = 1.0
        return (x, y)

    def __iter__(self):
        up = iter(self.upstream)
        while True:
            if self._doc is None:
                rec = next(up, None)
                if rec is None:
                    return
                doc = np.asarray(rec[0], np.int32).ravel()
                if doc.shape[0] < 2:
                    continue
                self._doc, self._off = doc, 0
            doc = self._doc
            while self._off + 1 < doc.shape[0]:
                w = doc[self._off:self._off + self.size + 1]
                # advance BEFORE yielding so a checkpoint taken after the
                # consumer takes this record resumes at the next window
                self._off += self.stride
                self.records_out += 1
                yield self._emit(w)
            self._doc, self._off = None, 0

    def on_epoch(self, epoch: int):
        super().on_epoch(epoch)
        self._doc, self._off = None, 0

    def _state(self):
        return {"doc": encode_state_value(self._doc), "off": self._off}

    def _load_state(self, state):
        doc = decode_state_value(state["doc"])
        self._doc = None if doc is None else np.asarray(doc, np.int32)
        self._off = int(state["off"])
