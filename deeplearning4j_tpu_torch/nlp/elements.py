"""Batched embedding-update steps: SkipGram / CBOW with hierarchical
softmax and negative sampling, and the paragraph-vector steps
(counterpart of deeplearning4j_tpu/nlp/elements.py).

Parity: models/embeddings/learning/impl/elements/{SkipGram, CBOW}.java
and sequence/{DM, DBOW}.java — word2vec.c's update formulas, one batch of
(center, target) pairs a call: gathers, batched dot products and row
updates as tensor ops on the tables' device. No Pallas kernel stands
behind these steps in the JAX package either (XLA's gathers and
scatters), so there is no hand-written kernel here.

The steps are word2vec's raw SGD: no autograd, no optimizer state. Each
updates its tables IN PLACE (the JAX package donates them) and returns
them, in the JAX functions' order.

Duplicate rows: a batch hits hot rows (Huffman roots, frequent words)
many times, all computed at the same stale parameters, so the updates
combine as a per-row MEAN over the batch (``_scatter_mean``), as in the
JAX package.

Determinism: the JAX docstring promises steps that are "deterministic and
race-free", and every row update here sums a row's duplicates through
``_row_sums``, which takes on each device an accumulating add that
PyTorch keeps in a fixed order: ``index_put_(accumulate=True)`` on the
card (sorted by row, then each row's entries summed in order;
``index_add_`` and ``scatter_add_`` add with atomics there) and
``index_add_`` on the CPU (serial; the CPU's
``index_put_(accumulate=True)`` adds floats with parallel atomics). No
process-wide deterministic switch is turned on. A row's entries are one
sequential chain on the card, so a step's time grows with its hottest
row (every hierarchical-softmax row holds the Huffman root); a mean's
counts ride in the same call as its sums, one chain for both.

Tables: syn0 [V, D] input vectors; syn1 [V, D] HS inner-node vectors;
syn1neg [V, D] negative-sampling output vectors; doc_vecs [N, D].
"""

from __future__ import annotations

import torch


def _row_sums(n: int, idx: torch.Tensor, values: torch.Tensor):
    """[n, ...]: entry i of ``values`` added into row idx[i], duplicates
    summed in a fixed order on either device (module docstring)."""
    out = values.new_zeros((n,) + values.shape[1:])
    if values.device.type == "cuda":
        return out.index_put_((idx,), values, accumulate=True)
    return out.index_add_(0, idx, values)


def _scatter_mean(table, idx, updates, weights):
    """table[i] += mean over batch entries with idx==i of updates, in
    place.

    idx [N], updates [N, D], weights [N] (0 excludes an entry)."""
    sums = _row_sums(table.shape[0], idx,
                     torch.cat([updates * weights[:, None], weights[:, None]],
                               dim=1))
    return table.add_(sums[:, :-1] / torch.clamp_min(sums[:, -1:], 1.0))


def _ones(idx, like):
    return torch.ones(idx.shape[0], dtype=like.dtype, device=like.device)


def _hs_core(h, syn1, points, codes, code_mask, lr):
    """(g, neu1e, v): word2vec.c's g = (1 - code - sigma(h.v)) * lr over
    a batch's Huffman rows, and the error it sends back to h."""
    v = syn1[points]                                    # [B, L, D]
    f = torch.sigmoid(torch.einsum("bd,bld->bl", h, v))
    g = (1.0 - codes - f) * code_mask * lr              # [B, L]
    return g, torch.einsum("bl,bld->bd", g, v)


def _update_syn1(syn1, points, code_mask, g, h):
    dsyn1 = (g[..., None] * h[:, None, :]).reshape(-1, h.shape[-1])
    _scatter_mean(syn1, points.reshape(-1), dsyn1, code_mask.reshape(-1))


def _ns_core(h, syn1neg, targets, labels, lr):
    v = syn1neg[targets]
    f = torch.sigmoid(torch.einsum("bd,bkd->bk", h, v))
    g = (labels - f) * lr
    return g, torch.einsum("bk,bkd->bd", g, v)


def _update_syn1neg(syn1neg, targets, g, h):
    dneg = (g[..., None] * h[:, None, :]).reshape(-1, h.shape[-1])
    _scatter_mean(syn1neg, targets.reshape(-1), dneg,
                  torch.ones(dneg.shape[0], dtype=syn1neg.dtype,
                             device=syn1neg.device))


@torch.no_grad()
def skipgram_hs_step(syn0, syn1, centers, points, codes, code_mask, lr):
    """Hierarchical-softmax skipgram batch.

    centers [B]; points/codes/code_mask [B, L] (Huffman rows, 0/1 codes,
    validity mask). Update per word2vec.c: g = (1 - code - sigma(h.v)) * lr.
    """
    h = syn0[centers]                                   # [B, D]
    g, neu1e = _hs_core(h, syn1, points, codes, code_mask, lr)
    _update_syn1(syn1, points, code_mask, g, h)
    _scatter_mean(syn0, centers, neu1e, _ones(centers, syn0))
    return syn0, syn1


@torch.no_grad()
def skipgram_ns_step(syn0, syn1neg, centers, targets, labels, lr):
    """Negative-sampling skipgram batch.

    targets [B, 1+K] = positive context + K negatives; labels [B, 1+K] =
    [1, 0, ..., 0]. g = (label - sigma(h.v)) * lr.
    """
    h = syn0[centers]
    g, neu1e = _ns_core(h, syn1neg, targets, labels, lr)
    _update_syn1neg(syn1neg, targets, g, h)
    _scatter_mean(syn0, centers, neu1e, _ones(centers, syn0))
    return syn0, syn1neg


def _cbow_hidden(syn0, context, ctx_mask, extra=None):
    ctx_vecs = syn0[context] * ctx_mask[..., None]      # [B, W, D]
    denom = ctx_mask.sum(dim=1, keepdim=True)
    if extra is not None:
        denom = denom + 1.0
        return (ctx_vecs.sum(dim=1) + extra) / torch.clamp_min(denom, 1.0)
    return ctx_vecs.sum(dim=1) / torch.clamp_min(denom, 1.0)


def _spread_to_context(syn0, context, ctx_mask, neu1e):
    """Add each row's error to all its (unmasked) context words, averaged
    per table row over the batch."""
    B, W = context.shape
    D = neu1e.shape[-1]
    upd = neu1e[:, None, :].expand(B, W, D).reshape(-1, D)
    return _scatter_mean(syn0, context.reshape(-1), upd, ctx_mask.reshape(-1))


@torch.no_grad()
def cbow_hs_step(syn0, syn1, context, ctx_mask, points, codes, code_mask, lr):
    """CBOW with hierarchical softmax: h = mean of context vectors
    (CBOW.java / word2vec.c cbow with mean), the error adds back to every
    context word."""
    h = _cbow_hidden(syn0, context, ctx_mask)
    g, neu1e = _hs_core(h, syn1, points, codes, code_mask, lr)
    _update_syn1(syn1, points, code_mask, g, h)
    _spread_to_context(syn0, context, ctx_mask, neu1e)
    return syn0, syn1


@torch.no_grad()
def cbow_ns_step(syn0, syn1neg, context, ctx_mask, targets, labels, lr):
    h = _cbow_hidden(syn0, context, ctx_mask)
    g, neu1e = _ns_core(h, syn1neg, targets, labels, lr)
    _update_syn1neg(syn1neg, targets, g, h)
    _spread_to_context(syn0, context, ctx_mask, neu1e)
    return syn0, syn1neg


# ---- paragraph-vector variants (DM.java / DBOW.java parity) ---------------

@torch.no_grad()
def dm_hs_step(syn0, syn1, doc_vecs, docs, context, ctx_mask, points, codes,
               code_mask, lr):
    """PV-DM: h = mean(context word vectors + the doc vector); both the
    words and the doc vector receive the error (DM.java parity)."""
    d = doc_vecs[docs]                                   # [B, D]
    h = _cbow_hidden(syn0, context, ctx_mask, extra=d)
    g, neu1e = _hs_core(h, syn1, points, codes, code_mask, lr)
    _update_syn1(syn1, points, code_mask, g, h)
    _spread_to_context(syn0, context, ctx_mask, neu1e)
    _scatter_mean(doc_vecs, docs, neu1e, _ones(docs, syn0))
    return syn0, syn1, doc_vecs


@torch.no_grad()
def dbow_hs_step(syn1, doc_vecs, docs, points, codes, code_mask, lr):
    """PV-DBOW: the doc vector predicts each word (DBOW.java parity) —
    skipgram with the doc vector as the center; word syn0 is untouched."""
    h = doc_vecs[docs]
    g, neu1e = _hs_core(h, syn1, points, codes, code_mask, lr)
    _update_syn1(syn1, points, code_mask, g, h)
    _scatter_mean(doc_vecs, docs, neu1e, _ones(docs, doc_vecs))
    return syn1, doc_vecs


@torch.no_grad()
def dbow_hs_step_frozen(syn1, doc_vecs, docs, points, codes, code_mask, lr):
    """DBOW inference variant: syn1 frozen, only doc vectors update
    (ParagraphVectors.inferVector parity)."""
    h = doc_vecs[docs]
    _, neu1e = _hs_core(h, syn1, points, codes, code_mask, lr)
    return _scatter_mean(doc_vecs, docs, neu1e, _ones(docs, doc_vecs))


@torch.no_grad()
def dm_hs_step_frozen(syn0, syn1, doc_vecs, docs, context, ctx_mask, points,
                      codes, code_mask, lr):
    """DM inference variant: word tables frozen, only doc vectors update."""
    d = doc_vecs[docs]
    h = _cbow_hidden(syn0, context, ctx_mask, extra=d)
    _, neu1e = _hs_core(h, syn1, points, codes, code_mask, lr)
    return _scatter_mean(doc_vecs, docs, neu1e, _ones(docs, doc_vecs))
