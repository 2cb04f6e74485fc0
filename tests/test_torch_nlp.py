"""The port's NLP stack (deeplearning4j_tpu_torch/nlp) against the JAX
package's (deeplearning4j_tpu/nlp) on the CPU.

- Host parts are equal: tokens, vocab, Huffman codes and points (tie order
  included), the negative table, the subsample probabilities.
- Each update step (the eight of elements.py and GloVe's) on the same
  seeded inputs with heavy duplicates (one row in every batch row) is
  within 1e-6 of the table's largest entry of the JAX step; two runs are
  bit-equal; the frozen steps leave the word tables bit-unchanged.
- Whole fits with one seed in both packages (Word2Vec skipgram/CBOW with
  hierarchical softmax and negative sampling, subsampling, PV-DBOW, PV-DM
  with infer_vector, GloVe) end within 1e-4 of the largest entry after a
  few hundred steps, and ``words_nearest`` ranks alike wherever the
  similarity gap is above 1e-4.
- The serializers carry tables across the packages bit for bit, both
  ways.

Tables are f32 in both packages (tests/conftest.py turns on JAX's x64,
and the JAX package sets f32 itself). Each module's JAX reference fits run
once, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.nlp import elements as jel
from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp import serializers as jser
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu.nlp.glove import Glove as JGlove
from deeplearning4j_tpu.nlp.paragraph_vectors import \
    ParagraphVectors as JParagraphVectors
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JWord2Vec
from deeplearning4j_tpu_torch.nlp import elements as tel
from deeplearning4j_tpu_torch.nlp import glove as tglove
from deeplearning4j_tpu_torch.nlp import serializers as tser
from deeplearning4j_tpu_torch.nlp import tokenization as ttok
from deeplearning4j_tpu_torch.nlp import vocab as tvocab
from deeplearning4j_tpu_torch.nlp.glove import Glove as TGlove
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import \
    ParagraphVectors as TParagraphVectors
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec as TWord2Vec

STEP_TOL = 1e-6     # of the table's largest entry, one step
FIT_TOL = 1e-4      # of the table's largest entry, a few hundred steps
GAP = 1e-4          # similarity gap above which rankings must agree

TOPICS = [["cat", "dog", "pet", "fur", "paw", "tail", "meow", "bark"],
          ["car", "road", "wheel", "engine", "drive", "fuel", "brake",
           "gear"]]


def topic_corpus(n_sentences=300, seed=0):
    """tests/test_nlp.py's two-topic corpus."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(TOPICS[rng.integers(0, 2)], size=6,
                                replace=True))
            for _ in range(n_sentences)]


def topic_documents(n_docs=60, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"doc_{i % 2}_{i}",
             " ".join(rng.choice(TOPICS[i % 2], size=20, replace=True)))
            for i in range(n_docs)]


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------ host parts
def test_tokenizers_equal():
    texts = ["Hello, World! 123", "a b c", "The CAT (sat) on: the MAT.",
             "深層学習 deep learning です", "한국어 x", "短 one", "ABC 語"]
    for mk in (lambda t: t.DefaultTokenizerFactory(),
               lambda t: t.DefaultTokenizerFactory()
               .set_token_pre_processor(t.CommonPreprocessor()),
               lambda t: t.DefaultTokenizerFactory()
               .set_token_pre_processor(t.EndingPreProcessor()),
               lambda t: t.NGramTokenizerFactory(1, 2),
               lambda t: t.CJKCharTokenizerFactory(),
               lambda t: t.CJKCharTokenizerFactory()
               .set_token_pre_processor(t.LowCasePreprocessor())):
        for text in texts:
            assert mk(ttok).create(text).get_tokens() == \
                mk(jtok).create(text).get_tokens()


def test_sentence_splitting_and_iterators_equal(tmp_path):
    texts = ["Hello there. How are you? Fine!",
             "私は猫が好き。彼は犬が好き！そうですか？",
             "J. Smith wrote it. It is 3.14 long.",
             "line one\nline two\n\nnew paragraph",
             "line one\r\nline two", 'He said "Stop!" Then he left.']
    for text in texts:
        assert ttok.split_sentences(text) == jtok.split_sentences(text)
    docs = ["the cat sat here. the dog ran fast."] * 3
    assert list(ttok.DocumentSentenceIterator(docs)) == \
        list(jtok.DocumentSentenceIterator(docs))
    p = tmp_path / "lines.txt"
    p.write_text("one line\n\n  two  \nthree\n", encoding="utf-8")
    assert list(ttok.BasicLineIterator(str(p))) == \
        list(jtok.BasicLineIterator(str(p)))
    pairs = {"a": "x y", "b": "z"}
    assert list(ttok.LabelAwareIterator(pairs)) == \
        list(jtok.LabelAwareIterator(pairs))


def _zipf_sequences(seed=0, n_words=300, n_tokens=6000):
    """A corpus whose counts tie often (many words seen once or twice),
    so the Huffman tree's tie order matters."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_words + 1)
    ids = rng.choice(n_words, size=n_tokens, p=p / p.sum())
    return [[f"w{i}" for i in ids[s:s + 20]] for s in range(0, n_tokens, 20)]


def _huffman(vocab_mod, seqs, min_freq=1):
    cache = vocab_mod.VocabConstructor(min_word_frequency=min_freq).build(seqs)
    return cache, [(w.word, w.count, w.index, w.code, w.points)
                   for w in cache.vocab_words]


@pytest.mark.parametrize("seqs", [
    [["the"] * 50 + ["cat"] * 10 + ["rare"] * 2],
    [["a", "a", "a", "b"]],
    [["common"] * 75 + ["rare"] * 1],
    [s.split() for s in topic_corpus()],
    _zipf_sequences(),
], ids=["test_nlp_huffman", "min_freq_corpus", "negative_table_corpus",
        "topic_corpus", "zipf_ties"])
@pytest.mark.parametrize("min_freq", [1, 2])
def test_vocab_huffman_negative_table_and_subsampling_equal(seqs, min_freq):
    jc, jw = _huffman(jvocab, seqs, min_freq)
    tc, tw = _huffman(tvocab, seqs, min_freq)
    assert tw == jw
    if len(tc) == 0:
        return
    np.testing.assert_array_equal(
        tvocab.make_negative_table(tc, table_size=10_000),
        jvocab.make_negative_table(jc, table_size=10_000))
    for sample in (0.0, 1e-3, 1e-1):
        a = tvocab.make_subsample_keep_probs(tc, sample)
        b = jvocab.make_subsample_keep_probs(jc, sample)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- the steps
V, D, B, L, W, K, NDOC = 60, 16, 96, 7, 6, 5, 12


def _step_inputs(seed):
    """Seeded inputs for every step, with heavy duplicates: row 0 of
    syn1 (a Huffman root) and of syn1neg, and doc 0, sit in every batch
    row; centers and contexts are drawn from a few rows."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def table(n, d=D, scale=0.5):
        return (rng.standard_normal((n, d)) * scale).astype(f32)
    lengths = rng.integers(2, L + 1, B)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(f32)
    points = rng.integers(0, V, (B, L)).astype(np.int32)
    points[:, 0] = 0
    ctx_len = rng.integers(1, W + 1, B)
    targets = rng.integers(0, V, (B, 1 + K)).astype(np.int32)
    targets[:, 1] = 3
    labels = np.zeros((B, 1 + K), f32)
    labels[:, 0] = 1.0
    docs = rng.integers(0, NDOC, B).astype(np.int32)
    docs[::2] = 0
    return {
        "syn0": table(V), "syn1": table(V), "syn1neg": table(V),
        "doc_vecs": table(NDOC),
        "centers": rng.integers(0, 8, B).astype(np.int32),
        "points": points,
        "codes": rng.integers(0, 2, (B, L)).astype(f32) * mask,
        "code_mask": mask,
        "context": rng.integers(0, 10, (B, W)).astype(np.int32),
        "ctx_mask": (np.arange(W)[None, :] < ctx_len[:, None]).astype(f32),
        "targets": targets, "labels": labels, "docs": docs,
        # GloVe
        "w": table(V, scale=0.1), "wc": table(V, scale=0.1),
        "b": (rng.standard_normal(V) * 0.1).astype(f32),
        "bc": (rng.standard_normal(V) * 0.1).astype(f32),
        "hw": rng.uniform(1.0, 2.0, (V, D)).astype(f32),
        "hwc": rng.uniform(1.0, 2.0, (V, D)).astype(f32),
        "hb": rng.uniform(1.0, 2.0, V).astype(f32),
        "hbc": rng.uniform(1.0, 2.0, V).astype(f32),
        "rows": np.where(np.arange(B) % 3 == 0, 1,
                         rng.integers(0, V, B)).astype(np.int32),
        "cols": np.where(np.arange(B) % 2 == 0, 2,
                         rng.integers(0, V, B)).astype(np.int32),
        "logx": np.log(rng.uniform(1.0, 50.0, B)).astype(f32),
        "fx": rng.uniform(0.1, 1.0, B).astype(f32),
    }


HS = ["points", "codes", "code_mask"]
NS = ["targets", "labels"]
CTX = ["context", "ctx_mask"]
GLOVE_TABLES = ["w", "wc", "b", "bc", "hw", "hwc", "hb", "hbc"]
# name -> (module attribute, argument names, the tables it returns,
#          the tables it must leave bit-unchanged)
STEPS = {
    "skipgram_hs_step": (["syn0", "syn1", "centers"] + HS,
                         ["syn0", "syn1"], []),
    "skipgram_ns_step": (["syn0", "syn1neg", "centers"] + NS,
                         ["syn0", "syn1neg"], []),
    "cbow_hs_step": (["syn0", "syn1"] + CTX + HS, ["syn0", "syn1"], []),
    "cbow_ns_step": (["syn0", "syn1neg"] + CTX + NS,
                     ["syn0", "syn1neg"], []),
    "dm_hs_step": (["syn0", "syn1", "doc_vecs", "docs"] + CTX + HS,
                   ["syn0", "syn1", "doc_vecs"], []),
    "dbow_hs_step": (["syn1", "doc_vecs", "docs"] + HS,
                     ["syn1", "doc_vecs"], []),
    "dbow_hs_step_frozen": (["syn1", "doc_vecs", "docs"] + HS,
                            ["doc_vecs"], ["syn1"]),
    "dm_hs_step_frozen": (["syn0", "syn1", "doc_vecs", "docs"] + CTX + HS,
                          ["doc_vecs"], ["syn0", "syn1"]),
    "_glove_step": (GLOVE_TABLES + ["rows", "cols", "logx", "fx"],
                    GLOVE_TABLES, []),
}
INDEX_ARGS = {"centers", "points", "context", "targets", "docs", "rows",
              "cols"}


def _fn(pkg, name):
    if name == "_glove_step":
        return (jglove if pkg == "jax" else tglove)._glove_step
    return getattr(jel if pkg == "jax" else tel, name)


def _run_jax(name, inp, lr):
    args, outs, _ = STEPS[name]
    res = _fn("jax", name)(*[jnp.asarray(inp[a]) for a in args], lr)
    res = res if isinstance(res, tuple) else (res,)
    return {o: np.asarray(r) for o, r in zip(outs, res)}


def _run_port(name, inp, lr):
    """The port's step on CPU tensors of ``inp``: (returned tables as
    numpy, the argument tensors after the call)."""
    args, outs, _ = STEPS[name]
    ts = {a: torch.tensor(inp[a], dtype=torch.int64) if a in INDEX_ARGS
          else torch.tensor(inp[a]) for a in args}
    res = _fn("port", name)(*[ts[a] for a in args], lr)
    res = res if isinstance(res, tuple) else (res,)
    for o, r in zip(outs, res):
        assert r is ts[o], f"{name} did not update {o} in place"
    return {o: r.numpy().copy() for o, r in zip(outs, res)}, ts


@pytest.mark.parametrize("name", list(STEPS))
def test_step_matches_the_jax_step(name):
    inp = _step_inputs(7)
    lr = 0.05 if name == "_glove_step" else 0.3
    want = _run_jax(name, inp, lr)
    got, after = _run_port(name, inp, lr)
    for t in want:
        assert got[t].dtype == np.float32
        assert rel_err(got[t], want[t]) <= STEP_TOL, t
        # the step moved the table (the comparison is not of copies)
        assert not np.array_equal(got[t], inp[t]), t
    for t in STEPS[name][2]:
        assert np.array_equal(after[t].numpy(), inp[t]), \
            f"{name} changed the frozen table {t}"


@pytest.mark.parametrize("name", list(STEPS))
def test_step_is_deterministic(name):
    inp = _step_inputs(8)
    a, _ = _run_port(name, inp, 0.3)
    b, _ = _run_port(name, inp, 0.3)
    for t in a:
        assert a[t].tobytes() == b[t].tobytes(), t


def test_row_sums_keep_one_order_on_the_cpu():
    """Duplicates summed in a fixed order: 20,000 entries into 5 of 50
    rows, bit-equal over repeats (the CPU's index_put_(accumulate=True)
    adds with parallel atomics and is not)."""
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 5, (20_000,), generator=g)
    vals = torch.randn(20_000, 64, generator=g)
    ref = tel._row_sums(50, idx, vals)
    for _ in range(5):
        assert torch.equal(tel._row_sums(50, idx, vals), ref)
    want = np.zeros((50, 64))
    np.add.at(want, idx.numpy(), vals.double().numpy())  # the sums in f64
    np.testing.assert_allclose(ref.numpy(), want, rtol=0, atol=1e-3)


# ------------------------------------------------------------ whole fits
W2V_CASES = {
    "skipgram_hs": dict(vector_size=16, window=4, negative=0, epochs=3,
                        learning_rate=0.05, batch_size=64, seed=1),
    "skipgram_ns": dict(vector_size=16, window=4, negative=5, epochs=3,
                        learning_rate=0.1, batch_size=64, seed=2),
    "cbow_hs": dict(vector_size=16, window=4, negative=0, epochs=4,
                    learning_rate=0.1, algorithm="cbow", batch_size=32,
                    seed=4),
    "cbow_ns_sampled": dict(vector_size=16, window=4, negative=5, epochs=8,
                            learning_rate=0.1, algorithm="cbow",
                            batch_size=32, sample=1e-2, seed=5),
}
PV_CASES = {"dbow": dict(vector_size=16, window=4, epochs=6,
                         learning_rate=0.05, seed=1),
            "dm": dict(vector_size=16, window=4, epochs=6,
                       learning_rate=0.05, seed=1)}
GLOVE_KW = dict(vector_size=12, window=4, epochs=30, learning_rate=0.05,
                batch_size=16, seed=1)
INFER_TEXT = "cat dog pet fur meow paw dog cat pet fur"
QUERIES = ["cat", "car", "fur", "engine"]


class StepCount:
    """Counts the calls of one package's step functions during a fit."""

    def __init__(self, monkeypatch, mod, names):
        self.n = 0
        for name in names:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn):
                self.n += 1
                return _fn(*a)
            monkeypatch.setattr(mod, name, counted)


def _tables(model):
    lk = model.lookup
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in (("syn0", lk.syn0), ("syn1", lk.syn1),
                         ("syn1neg", lk.syn1neg)) if v is not None}


def _ranked(model, word, k=6):
    return model.words_nearest(word, top_n=k)


@pytest.fixture(scope="module")
def jax_fits():
    """The JAX package's fits, once for the module: tables, ranked
    neighbours, step counts, doc vectors and the inferred vector."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, kw in W2V_CASES.items():
            steps = StepCount(mp, jel, list(STEPS)[:4])
            m = JWord2Vec(**kw)
            m.fit_sentences(jtok.CollectionSentenceIterator(
                topic_corpus(seed=3)))
            out[name] = dict(tables=_tables(m), steps=steps.n,
                             nearest={q: _ranked(m, q) for q in QUERIES})
            mp.undo()
        for algo, kw in PV_CASES.items():
            steps = StepCount(mp, jel, ["dbow_hs_step", "dm_hs_step"])
            m = JParagraphVectors(sequence_algorithm=algo, **kw)
            m.fit_documents(topic_documents())
            out["pv_" + algo] = dict(
                tables=dict(_tables(m), doc_vecs=np.asarray(m.doc_vecs)),
                steps=steps.n, infer=m.infer_vector(INFER_TEXT,
                                                    iterations=20),
                nearest_labels=m.nearest_labels("doc_0_0", top_n=6))
            mp.undo()
        steps = StepCount(mp, jglove, ["_glove_step"])
        tf = jtok.DefaultTokenizerFactory()
        m = JGlove(**GLOVE_KW).fit(
            [tf.create(s).get_tokens() for s in topic_corpus(seed=7)])
        out["glove"] = dict(tables={"syn0": np.asarray(m.lookup.syn0)},
                            steps=steps.n,
                            nearest={q: _ranked(m, q) for q in QUERIES})
    finally:
        mp.undo()
    return out


def _assert_rankings_agree(got, want):
    """Equal top-k sets wherever the JAX similarity gap after rank k is
    above GAP (k = 1..5), and similarities within FIT_TOL."""
    gw = [w for w, _ in got]
    ww = [w for w, _ in want]
    sims = [s for _, s in want]
    checked = 0
    for k in range(1, 6):
        if sims[k - 1] - sims[k] > GAP:
            assert set(gw[:k]) == set(ww[:k]), (k, got, want)
            checked += 1
    assert checked, want
    for (w, s) in got:
        if w in ww:
            assert abs(s - dict(want)[w]) <= FIT_TOL


def _assert_tables_close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        assert rel_err(got[k], want[k]) <= FIT_TOL, k


@pytest.mark.parametrize("name", list(W2V_CASES))
def test_word2vec_fit_matches_the_jax_package(name, jax_fits, monkeypatch):
    ref = jax_fits[name]
    steps = StepCount(monkeypatch, tel, list(STEPS)[:4])
    m = TWord2Vec(device="cpu", **W2V_CASES[name])
    m.fit_sentences(ttok.CollectionSentenceIterator(topic_corpus(seed=3)))
    assert steps.n == ref["steps"] >= 200
    _assert_tables_close(_tables(m), ref["tables"])
    for q in QUERIES:
        _assert_rankings_agree(_ranked(m, q), ref["nearest"][q])


@pytest.mark.parametrize("algo", list(PV_CASES))
def test_paragraph_vectors_fit_and_infer_match(algo, jax_fits, monkeypatch):
    ref = jax_fits["pv_" + algo]
    steps = StepCount(monkeypatch, tel, ["dbow_hs_step", "dm_hs_step"])
    m = TParagraphVectors(sequence_algorithm=algo, device="cpu",
                          **PV_CASES[algo])
    m.fit_documents(topic_documents())
    assert steps.n == ref["steps"] >= 200
    _assert_tables_close(dict(_tables(m), doc_vecs=m.doc_vecs.numpy()),
                         ref["tables"])
    syn0, syn1 = m.lookup.syn0.clone(), m.lookup.syn1.clone()
    vec = m.infer_vector(INFER_TEXT, iterations=20)
    assert torch.equal(m.lookup.syn0, syn0) and torch.equal(m.lookup.syn1,
                                                            syn1)
    assert rel_err(vec, ref["infer"]) <= FIT_TOL
    got = m.nearest_labels("doc_0_0", top_n=6)
    assert [l for l, _ in got][:3] == [l for l, _ in ref["nearest_labels"]][:3]


def test_glove_fit_matches_the_jax_package(jax_fits, monkeypatch):
    ref = jax_fits["glove"]
    steps = StepCount(monkeypatch, tglove, ["_glove_step"])
    tf = ttok.DefaultTokenizerFactory()
    m = TGlove(device="cpu", **GLOVE_KW).fit(
        [tf.create(s).get_tokens() for s in topic_corpus(seed=7)])
    assert steps.n == ref["steps"] >= 200
    _assert_tables_close({"syn0": m.lookup.syn0.numpy()}, ref["tables"])
    for q in QUERIES:
        _assert_rankings_agree(_ranked(m, q), ref["nearest"][q])


def test_cooccurrences_equal_the_jax_counting():
    tf = ttok.DefaultTokenizerFactory()
    seqs = [tf.create(s).get_tokens() for s in topic_corpus(seed=7)]
    cache = tvocab.VocabConstructor(1).build(seqs)
    rows, cols, xs = tglove._cooccurrences(cache, seqs, 4, True)
    jm = JGlove(**dict(GLOVE_KW, epochs=0))
    jm.fit(seqs)   # builds the same vocab; the counts are recomputed here
    want = {}
    for tokens in seqs:
        idxs = [jm.vocab.index_of(t) for t in tokens]
        for pos, wi in enumerate(idxs):
            for off in range(1, 5):
                if pos + off >= len(idxs):
                    break
                for key in ((wi, idxs[pos + off]), (idxs[pos + off], wi)):
                    want[key] = want.get(key, 0.0) + 1.0 / off
    assert list(zip(rows.tolist(), cols.tolist())) == list(want)
    np.testing.assert_array_equal(xs, np.asarray(list(want.values()),
                                                 np.float32))


def test_lookup_init_and_queries_match():
    seqs = [s.split() for s in topic_corpus()]
    jc = jvocab.VocabConstructor(1).build(seqs)
    tc = tvocab.VocabConstructor(1).build(seqs)
    from deeplearning4j_tpu.nlp.lookup import InMemoryLookupTable as JL
    from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable as TL
    j = JL(jc, 24, seed=5, negative=3, negative_table_size=1000)
    t = TL(tc, 24, seed=5, negative=3, negative_table_size=1000,
           device="cpu")
    assert np.asarray(j.syn0).tobytes() == t.syn0.numpy().tobytes()
    assert not t.syn1.any() and not t.syn1neg.any()
    np.testing.assert_array_equal(t.neg_table, j.neg_table)
    assert abs(t.similarity("cat", "car") - j.similarity("cat", "car")) \
        <= 1e-6
    _assert_rankings_agree(t.words_nearest_sum(["cat", "car"], ["dog"]),
                           j.words_nearest_sum(["cat", "car"], ["dog"]))
    _assert_rankings_agree(t.words_nearest(t.vector("fur")),
                           j.words_nearest(j.vector("fur")))


# ------------------------------------------------------------ serializers
@pytest.fixture(scope="module")
def trained_pair():
    """A small port Word2Vec and its tables in a JAX lookup."""
    from deeplearning4j_tpu.nlp.lookup import InMemoryLookupTable as JL
    m = TWord2Vec(vector_size=8, window=3, negative=0, epochs=2, seed=1,
                  device="cpu")
    m.fit_sentences(ttok.CollectionSentenceIterator(topic_corpus()[:40]))
    jc = jvocab.VocabConstructor(1).build(
        [s.split() for s in topic_corpus()[:40]])
    j = JL(jc, 8, seed=1)
    j.syn0 = jnp.asarray(m.lookup.syn0.numpy())
    return m.lookup, j


@pytest.mark.parametrize("fmt", ["text", "binary"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serializers_cross_the_packages_bit_equal(tmp_path, trained_pair,
                                                  fmt, writer):
    port_lk, jax_lk = trained_pair
    w, r = (("write_word_vectors", "read_word_vectors") if fmt == "text"
            else ("write_word2vec_binary", "read_word2vec_binary"))
    pj, pt = str(tmp_path / "jax.out"), str(tmp_path / "port.out")
    getattr(jser, w)(jax_lk, pj)
    getattr(tser, w)(port_lk, pt)
    # both packages write the same bytes for the same table
    assert open(pj, "rb").read() == open(pt, "rb").read()
    src = pj if writer == "jax" else pt
    jread = getattr(jser, r)(src)
    tread = getattr(tser, r)(src, device="cpu")
    assert tread.syn0.numpy().tobytes() == np.asarray(jread.syn0).tobytes()
    assert [w.word for w in tread.cache.vocab_words] == \
        [w.word for w in jread.cache.vocab_words]
    if fmt == "binary":
        assert tread.syn0.numpy().tobytes() == port_lk.syn0.numpy().tobytes()
    else:
        assert rel_err(tread.syn0.numpy(), port_lk.syn0.numpy()) <= 1e-5


@pytest.mark.parametrize("corpus", ["generator", "document_sentences"])
def test_fit_inputs_match_the_jax_package(corpus):
    """A one-shot generator (fit materializes it for its two passes) and
    the sentence splitter's stream train the same tables in both
    packages."""
    from deeplearning4j_tpu.nlp.sequence_vectors import SequenceVectors as J
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import \
        SequenceVectors as T
    out = []
    for pkg, cls, tok in (("jax", J, jtok), ("port", T, ttok)):
        kw = dict(vector_size=8, window=2, negative=0, epochs=2,
                  min_word_frequency=1, batch_size=32, seed=3)
        m = cls(**kw) if pkg == "jax" else cls(device="cpu", **kw)
        if corpus == "generator":
            seqs = [["alpha", "beta", "gamma", "delta"] * 5,
                    ["alpha", "gamma", "beta", "delta"] * 5] * 10
            m.fit(s for s in seqs)
        else:
            it = tok.DocumentSentenceIterator(
                ["the cat sat here. the dog ran fast."] * 15)
            m.fit([tok.DefaultTokenizerFactory().create(s).get_tokens()
                   for s in it])
        out.append(_tables(m))
    _assert_tables_close(out[1], out[0])
