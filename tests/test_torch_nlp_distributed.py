"""The port's multi-process embedding trainer
(deeplearning4j_tpu_torch/nlp/distributed.py) on two gloo ranks on the CPU
(tests/_torch_fleet.py): the ranks end bit-identical (``sync_check``);
after one epoch each rank's tables are the float64 mean of two
single-process port runs, one on each rank's shard, bit for bit, and
within FIT_TOL of the largest entry of the same mean of two JAX-package
runs (the JAX trainer's ``_average_across_processes``); after
tests/_multihost_worker.py's eight epochs the topic structure holds, as
tests/test_multihost.py asks of the JAX trainer. Every wait is bounded
and every rank process is killed in ``finally`` (run_fleets)."""

import numpy as np

from _torch_fleet import run_fleets

from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JWord2Vec
from deeplearning4j_tpu_torch.nlp import Word2Vec

TIMEOUT_S = 240
FIT_TOL = 1e-4      # of the table's largest entry, as tests/test_torch_nlp.py

# tests/_multihost_worker.py's corpus and model
CORPUS_SRC = r'''
def w2v_corpus(n=240):
    rng = np.random.default_rng(7)
    topics = [["apple", "banana", "fruit", "juice", "sweet", "ripe"],
              ["car", "road", "wheel", "engine", "drive", "fast"]]
    corpus = []
    for i in range(n):
        pool = topics[rng.integers(0, 2)]
        corpus.append([pool[j] for j in rng.integers(0, len(pool), 8)])
    return corpus

W2V_KW = dict(vector_size=24, window=3, negative=0, learning_rate=0.05,
              batch_size=256, seed=11)
'''
exec(CORPUS_SRC)

# one intra-op thread a rank: two ranks of tiny ops with a full thread
# pool each spin against each other for ~20 s on an 8-core host
BODY = CORPUS_SRC + r'''
torch.set_num_threads(1)
from deeplearning4j_tpu_torch.nlp import MultiProcessSequenceVectors, Word2Vec
res, arrays = {}, {}
for epochs in (1, 8):
    w2v = Word2Vec(epochs=epochs, device="cpu", **W2V_KW)
    trainer = MultiProcessSequenceVectors(w2v)
    trainer.fit(w2v_corpus())
    lk = w2v.lookup
    res[f"e{epochs}"] = {
        "sync": D.sync_check({"syn0": lk.syn0, "syn1": lk.syn1}),
        "index": trainer.process_index, "count": trainer.process_count,
        "phases": [e.phase for e in trainer.stats.events],
        "epochs_after": w2v.config.epochs,
        "sims": [w2v.similarity("apple", "banana"),
                 w2v.similarity("car", "road"),
                 w2v.similarity("apple", "car")]}
    arrays[f"e{epochs}_syn0"] = lk.syn0.numpy()
    arrays[f"e{epochs}_syn1"] = lk.syn1.numpy()
save(res, **arrays)
D.shutdown()
'''


def _shard_mean(make):
    """The float64 mean, rounded to f32, of two single-process runs of
    ``make()``'s model, each on one rank's strided shard with the full
    corpus's vocab and the one-epoch schedule."""
    corpus = w2v_corpus()
    tables = []
    for rank in range(2):
        m = make()
        m.build_vocab(corpus)
        m.fit(corpus[rank::2], lr_range=(W2V_KW["learning_rate"], 0.0))
        tables.append([np.asarray(t).astype(np.float64)
                       for t in (m.lookup.syn0, m.lookup.syn1)])
    return [((a + b) / 2).astype(np.float32)
            for a, b in zip(tables[0], tables[1])]


def _shard_reference():
    """(the port's shard mean, the JAX package's)."""
    return (_shard_mean(lambda: Word2Vec(epochs=1, device="cpu", **W2V_KW)),
            _shard_mean(lambda: JWord2Vec(epochs=1, **W2V_KW)))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_two_ranks_average_their_shards_and_stay_in_sync(tmp_path):
    out, ((ref0, ref1), (jref0, jref1)) = run_fleets([("w2v", BODY, 2, str(tmp_path))],
                                   _shard_reference, TIMEOUT_S)
    (r0, a0), (r1, a1) = out["w2v"]
    for res in (r0, r1):
        assert res["e1"]["count"] == 2 and res["e8"]["count"] == 2
        assert res["e1"]["sync"] is True and res["e8"]["sync"] is True
        assert res["e1"]["phases"] == ["vocab", "fit", "average"]
        assert res["e8"]["phases"] == ["vocab"] + ["fit", "average"] * 8
        assert res["e1"]["epochs_after"] == 1 and \
            res["e8"]["epochs_after"] == 8
    assert [r0["e1"]["index"], r1["e1"]["index"]] == [0, 1]
    for a in (a0, a1):
        assert a["e1_syn0"].tobytes() == ref0.tobytes()
        assert a["e1_syn1"].tobytes() == ref1.tobytes()
        assert rel_err(a["e1_syn0"], jref0) <= FIT_TOL
        assert rel_err(a["e1_syn1"], jref1) <= FIT_TOL
    assert a0["e8_syn0"].tobytes() == a1["e8_syn0"].tobytes()
    in_a, in_b, cross = r0["e8"]["sims"]
    assert in_a > cross + 0.2 and in_b > cross + 0.2, (in_a, in_b, cross)
