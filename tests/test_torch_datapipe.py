"""The port's input pipeline (deeplearning4j_tpu_torch/datapipe) against
the JAX package's, on the CPU.

The same chain built in both packages over the same numpy records gives
bit-equal batches (features, labels and both masks) for two epochs, and
equal ``state_dict()`` JSON at several cut points; a state cut in one
package loads into the other's pipeline and continues with the same
batches, both ways. A hypothesis sweep holds the modulo shard disjoint
and covering, equal to the JAX package's. Last, the fit loops' epoch
repair: ``fit(pipe, epochs=3)`` on both network kinds trains on three
distinct epoch orders, the JAX package's.

Everything here is exact: the stages move and collate host arrays and
draw from numpy generators seeded alike, so no tolerance applies.
"""

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deeplearning4j_tpu import datapipe as jpipe
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Sgd as JSgd
from deeplearning4j_tpu_torch import datapipe as tpipe
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy as TDtypePolicy
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TInputType
from deeplearning4j_tpu_torch.nn.conf.layers import Dense as TDense
from deeplearning4j_tpu_torch.nn.conf.layers import Output as TOutput
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.nn.updater import Sgd as TSgd

N, F, K = 41, 5, 3
ALPHABET = "abcdefghij"


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, F)).astype(np.float32)
    x[:, 0] = np.arange(N)            # column 0: the record's id
    y = np.eye(K, dtype=np.float32)[rng.integers(0, K, N)]
    return x, y


def _sequences(seed=1):
    """Variable-length [t, F] records with per-step one-hot labels."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(23):
        t = int(rng.integers(1, 12))
        out.append((rng.normal(size=(t, F)).astype(np.float32),
                    np.eye(K, dtype=np.float32)[rng.integers(0, K, t)]))
    return out


def _docs(seed=2):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(ALPHABET), int(n)))
            for n in rng.integers(2, 40, 9)]


def _double(rec):
    return (rec[0] * 2.0,) + tuple(rec[1:])


def _keep(rec):
    return rec[0][1] > -0.8


def _csv(tmp_path):
    x, y = _arrays()
    path = tmp_path / "data.csv"
    rows = np.concatenate([y.argmax(1)[:, None].astype(np.float32), x], 1)
    path.write_text("\n".join(",".join(f"{v:.6g}" for v in r)
                              for r in rows) + "\n")
    return str(path)


def _lines(tmp_path):
    x, _ = _arrays()
    path = tmp_path / "data.txt"
    path.write_text("# header\n" + "\n".join(
        " ".join(f"{v:.6g}" for v in r) for r in x) + "\n")
    return str(path)


def _parse(line):
    return np.asarray([float(v) for v in line.split()], np.float32)


# each chain once per package: name -> fn(package, tmp_path) -> Pipeline
CHAINS = {
    "map_workers": lambda m, d: m.from_arrays(*_arrays()).map(
        _double, workers=3).batch(5),
    "filter": lambda m, d: m.from_arrays(*_arrays()).filter(_keep).batch(5),
    "normalize": lambda m, d: m.from_arrays(*_arrays()).normalize().batch(6),
    "shuffle": lambda m, d: m.from_arrays(*_arrays()).shuffle(
        window=7, seed=3).batch(5),
    "shard": lambda m, d: m.from_arrays(*_arrays()).shard(3, 1).batch(4),
    "batch_drop_last": lambda m, d: m.from_arrays(*_arrays()).batch(
        6, drop_last=True),
    "bucket_batch": lambda m, d: m.from_records(_sequences()).shuffle(
        window=5, seed=4).bucket_batch(3),
    "tokenize_window": lambda m, d: m.from_text(_docs()).tokenize(
        m.CharTokenizer.fit(ALPHABET)).window(
            8, stride=5, vocab_size=len(ALPHABET)).bucket_batch(4),
    "prefetch": lambda m, d: m.from_arrays(*_arrays()).shuffle(
        window=9, seed=5).batch(5).prefetch(2),
    "csv": lambda m, d: m.from_csv(_csv(d), label_index=0,
                                   num_classes=K).batch(7),
    "lines": lambda m, d: m.from_lines(_lines(d), parse=_parse,
                                       skip_lines=1).batch(6),
}


def _fields(ds):
    return (ds.features, ds.labels, ds.features_mask, ds.labels_mask)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for f, (a, b) in enumerate(zip(_fields(g), _fields(w))):
            if b is None:
                assert a is None, (i, f)
                continue
            assert isinstance(a, np.ndarray), (i, f, type(a))
            assert a.dtype == b.dtype and a.shape == b.shape, (i, f)
            np.testing.assert_array_equal(a, b, err_msg=f"batch {i} field {f}")


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_batches_bit_equal_over_two_epochs(chain, tmp_path):
    jp, tp = CHAINS[chain](jpipe, tmp_path), CHAINS[chain](tpipe, tmp_path)
    assert tp.auto_epochs is True
    for epoch in range(2):
        want, got = list(jp), list(tp)
        assert want, chain
        _assert_batches_equal(got, want)
        assert tp.epoch == jp.epoch == epoch + 1
    jp.close()
    tp.close()


def _state_json(pipe):
    return json.dumps(pipe.state_dict(), sort_keys=True)


# the prefetch chain's buffer holds whatever the worker pulled by then,
# so its state is timing-dependent: it crosses packages below instead
STATE_CHAINS = sorted(c for c in CHAINS if c != "prefetch")


@pytest.mark.parametrize("cut", [0, 1, 3])
@pytest.mark.parametrize("chain", STATE_CHAINS)
def test_state_dict_json_equal_at_cut_points(chain, cut, tmp_path):
    jp, tp = CHAINS[chain](jpipe, tmp_path), CHAINS[chain](tpipe, tmp_path)
    ji, ti = iter(jp), iter(tp)
    for _ in range(cut):
        next(ji)
        next(ti)
    assert _state_json(tp) == _state_json(jp)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("chain", ["map_workers", "shuffle", "bucket_batch",
                                   "tokenize_window", "prefetch"])
def test_state_crosses_packages_and_continues(chain, direction, tmp_path):
    src_mod, dst_mod = ((jpipe, tpipe) if direction == "jax_to_port"
                        else (tpipe, jpipe))
    src = CHAINS[chain](src_mod, tmp_path)
    it = iter(src)
    first = [next(it) for _ in range(2)]
    state = json.loads(json.dumps(src.state_dict()))
    rest = list(it) + list(src)             # this epoch's tail, the next
    dst = CHAINS[chain](dst_mod, tmp_path)
    dst.load_state_dict(state)
    got = list(dst) + list(dst)
    _assert_batches_equal(got, rest)
    assert first and dst.epoch == src.epoch == 2
    src.close()
    dst.close()


def test_state_refuses_a_card_tensor_and_takes_a_host_one():
    import torch
    from deeplearning4j_tpu_torch.datapipe.core import encode_state_value
    host = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert encode_state_value(host) == encode_state_value(host.numpy())

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    with pytest.raises(TypeError, match="host copies"):
        encode_state_value(host.as_subclass(OnCard))


def _ids(pipe):
    return sorted(int(i) for ds in pipe for i in ds.features[:, 0])


@settings(max_examples=25, deadline=None)
@given(n=st.integers(0, 60), shards=st.integers(1, 6),
       shuffled=st.booleans())
def test_shards_disjoint_and_covering(n, shards, shuffled):
    ids = np.arange(n, dtype=np.float32)[:, None]
    seen = []
    for i in range(shards):
        def build(m):
            p = m.from_arrays(ids)
            if shuffled:
                p = p.shuffle(window=4, seed=11)
            return p.shard(shards, i).batch(3)
        mine = _ids(build(tpipe))
        assert mine == _ids(build(jpipe))
        assert len(mine) in (n // shards, -(-n // shards))
        seen += mine
    assert sorted(seen) == list(range(n))


def test_shard_defaults_to_one_process():
    stage = tpipe.from_arrays(np.zeros((4, 1))).shard().tail
    assert (stage.num_shards, stage.index) == (1, 0)


# ---------------------------------------------------------------------------
# fit(pipe, epochs=k) trains on k distinct epoch orders (auto_epochs)
# ---------------------------------------------------------------------------

def _recording_pipe(mod, seen):
    def record(rec):
        seen.append(int(rec[0][0]))
        return rec
    x, y = _arrays()
    return mod.from_arrays(x, y).shuffle(window=8, seed=21).map(
        record).batch(8, drop_last=True).prefetch(2)


def _net(pkg, kind):
    jax_side = pkg == "jax"
    nnc = JNNC if jax_side else TNNC
    pol = (JDtypePolicy if jax_side else TDtypePolicy)(
        param_dtype="float32", compute_dtype="float32")
    dense, out = (JDense, JOutput) if jax_side else (TDense, TOutput)
    b = nnc.builder().seed(4).updater((JSgd if jax_side else TSgd)(0.1)
                                      ).dtype(pol)
    if kind == "mln":
        conf = (b.list().layer(dense(n_in=F, n_out=4, activation="tanh"))
                .layer(out(n_out=K, activation="softmax", loss="mcxent"))
                .build())
        if jax_side:
            return JMLN(conf).init()
        return TMLN(conf, device="cpu").init()
    it = JInputType if jax_side else TInputType
    conf = (b.graph_builder().add_inputs("in")
            .add_layer("d", dense(n_out=4, activation="tanh"), "in")
            .add_layer("out", out(n_out=K, activation="softmax",
                                  loss="mcxent"), "d")
            .set_outputs("out").set_input_types(it.feed_forward(F)).build())
    if jax_side:
        return JGraph(conf).init()
    return TGraph(conf, device="cpu").init()


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_fit_trains_on_distinct_epoch_orders(kind):
    per_epoch = (N // 8) * 8
    orders = {}
    for pkg, mod in (("jax", jpipe), ("port", tpipe)):
        seen = []
        pipe = _recording_pipe(mod, seen)
        net = _net(pkg, kind)
        net.fit(pipe, epochs=3)
        assert net.iteration == 3 * (N // 8)
        assert pipe.epoch == 3
        orders[pkg] = [seen[e * N:(e + 1) * N] for e in range(3)]
        assert len(seen) == 3 * N
    assert orders["port"] == orders["jax"]
    epochs = orders["port"]
    assert len({tuple(e[:per_epoch]) for e in epochs}) == 3
    for e in epochs:
        assert sorted(e) == list(range(N))


def test_fit_still_resets_a_plain_iterator():
    """An iterator without ``auto_epochs`` is rewound after each epoch,
    as before: every epoch sees its batches again."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    x, y = _arrays()
    batches = [DataSet(x[i:i + 8], y[i:i + 8]) for i in range(0, 40, 8)]

    class Counting(ListDataSetIterator):
        resets = 0

        def reset(self):
            Counting.resets += 1

    net = _net("port", "mln")
    net.fit(Counting(batches), epochs=3, async_prefetch=False)
    assert Counting.resets == 3 and net.iteration == 15
