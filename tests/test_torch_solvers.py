"""The port's full-batch solvers (deeplearning4j_tpu_torch/optimize/
solvers.py) on the CPU.

Against the JAX package (deeplearning4j_tpu/optimize/solvers.py) on a
zip-transplanted net (5 -> 16 tanh -> 3 softmax, 64 examples of three
Gaussian blobs):

- F32: each solver's first iteration, the line search's step exactly and
  its f_new to 1e-6 relative (the same f32 loss in another order), from
  the JAX package's own ``_flat_problem`` and ``backtrack_line_search``;
- F64: after 15 iterations of each solver, the final score to 1e-9
  relative, and the iteration count and convergence flag exactly (the
  same f64 arithmetic in another order; the Armijo decisions agree).

On the port alone, the counterparts of tests/test_earlystopping_solvers.py's
solver tests (each solver halves the loss in 30 iterations, L-BFGS beats
30 SGD steps, dispatch and its refusal), the line search's swap to -g,
the flat vector's leaf order and write-back in place, a dropout net's
fixed mask per ``optimize`` (the net's generator left as it was), and a
ComputationGraph.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.core import DtypePolicy as JDtypePolicy
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import Output as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.optimize import solvers as jsol
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.core import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, Output
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam, Sgd, _leaves
from deeplearning4j_tpu_torch.optimize import solvers as tsol
from deeplearning4j_tpu_torch.utils import serialization as tser

ALGOS = ["line_gradient_descent", "conjugate_gradient", "lbfgs"]
TORCH_DT = {"float32": torch.float32, "float64": torch.float64}


def make_problem(seed=0, n=64, dtype="float32"):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 2, (3, 5))
    idx = rng.integers(0, 3, n)
    x = (centers[idx] + rng.normal(0, 0.6, (n, 5))).astype(dtype)
    y = np.eye(3, dtype=dtype)[idx]
    return x, y


def port_net(dtype="float32", updater=None, dropout=None):
    policy = DtypePolicy(param_dtype=dtype, compute_dtype=dtype)
    b = (NeuralNetConfiguration.builder().seed(7)
         .updater(updater or Adam(1e-2)).dtype(policy))
    if dropout:
        b = b.dropout(dropout)
    conf = (b.list()
            .layer(Dense(n_in=5, n_out=16, activation="tanh"))
            .layer(Output(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def jax_and_port(tmp_path, dtype):
    policy = JDtypePolicy(param_dtype=dtype, compute_dtype=dtype)
    conf = (JNNC.builder().seed(7).updater(JAdam(1e-2)).dtype(policy).list()
            .layer(JDense(n_in=5, n_out=16, activation="tanh"))
            .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
            .build())
    jnet = JMLN(conf).init()
    path = str(tmp_path / "net.zip")
    jser.write_model(jnet, path)
    return jnet, tser.restore_multi_layer_network(path, device="cpu")


@pytest.mark.parametrize("algo", ALGOS)
def test_first_iteration_matches_the_jax_package_f32(tmp_path, algo):
    jnet, tnet = jax_and_port(tmp_path, "float32")
    x, y = make_problem()
    flat0, _, jloss, jvg = jsol._flat_problem(jnet, JDataSet(x, y))
    fx, g = jvg(flat0)
    # every solver's first direction is -g (no history yet)
    ja, jfnew, _ = jsol.backtrack_line_search(jloss, flat0, float(fx), g,
                                              -g)
    solver = tsol.Solver.ALGOS[algo](tnet, max_iterations=1)
    solver.optimize(DataSet(x, y))
    ta, tfnew = solver.first_step
    assert ta == ja
    assert abs(tfnew - jfnew) <= 1e-6 * abs(jfnew), (tfnew, jfnew)


@pytest.mark.parametrize("algo", ALGOS)
def test_f64_final_score_matches_the_jax_package(tmp_path, algo):
    jnet, tnet = jax_and_port(tmp_path, "float64")
    x, y = make_problem(dtype="float64")
    jres = jsol.Solver(jnet).optimize(JDataSet(x, y), algo=algo,
                                      max_iterations=15)
    tres = tsol.Solver(tnet).optimize(DataSet(x, y), algo=algo,
                                      max_iterations=15)
    assert (tres.iterations, tres.converged) == (jres.iterations,
                                                 jres.converged)
    assert abs(tres.score - jres.score) <= 1e-9 * abs(jres.score), (
        tres.score, jres.score)
    for n, sub in jnet.params.items():
        for k, v in sub.items():
            np.testing.assert_allclose(tnet.params[n][k].numpy(),
                                       np.asarray(v), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("algo", ALGOS)
def test_solver_reduces_loss(algo):
    x, y = make_problem(n=256)
    ds = DataSet(x, y)
    net = port_net()
    s0 = net.score(ds, train=True)
    res = tsol.Solver.ALGOS[algo](net, max_iterations=30).optimize(ds)
    assert res.score < s0 * 0.5, (s0, res.score)
    # the result was written into the net's own tensors
    assert net.score(ds, train=True) == pytest.approx(res.score, rel=1e-6)
    assert net.score_value == res.score


def test_lbfgs_beats_sgd_per_iteration():
    x, y = make_problem(n=256)
    ds = DataSet(x, y)
    net_sgd = port_net(updater=Sgd(0.1))
    for _ in range(30):
        net_sgd.fit_batch(ds)
    sgd_score = net_sgd.score(ds, train=True)
    res = tsol.LBFGS(port_net(), max_iterations=30).optimize(ds)
    assert res.score < sgd_score, (res.score, sgd_score)


def test_solver_dispatch():
    x, y = make_problem()
    ds = DataSet(x, y)
    net = port_net()
    res = tsol.Solver(net).optimize(ds, algo="conjugate_gradient",
                                    max_iterations=10)
    assert res.iterations <= 10
    with pytest.raises(ValueError, match="Unknown optimization"):
        tsol.Solver(net).optimize(ds, algo="newton")
    a, b = port_net(), port_net()
    res = tsol.Solver(a).optimize(ds, algo="sgd")
    score = b.fit_batch(ds)
    assert res.iterations == 1 and res.score == float(score)
    for n in a.params:
        for k in a.params[n]:
            assert torch.equal(a.params[n][k], b.params[n][k])


def test_line_search_swaps_a_non_descent_direction_for_minus_g():
    def loss(v):
        return (v * v).sum()

    x = torch.tensor([1.0, -2.0], dtype=torch.float64)
    g = 2 * x
    a, fnew, d = tsol.backtrack_line_search(loss, x, float(loss(x)), g, g)
    assert torch.equal(d, -g) and a == 0.5 and fnew == 0.0
    # a direction nothing decreases along gives no step
    a, fnew, d = tsol.backtrack_line_search(lambda v: torch.tensor(1.0), x,
                                            1.0, g, -g)
    assert a == 0.0 and fnew == 1.0


def test_flat_problem_order_and_write_back_in_place():
    net = port_net()
    x, y = make_problem()
    prob = tsol._FlatProblem(net, DataSet(x, y))
    want = torch.cat([t.reshape(-1) for t in _leaves(net.params)])
    assert torch.equal(prob.flat0, want)
    tree = prob.unflatten(prob.flat0 * 2)
    assert torch.equal(tree["layer_0"]["W"], 2 * net.params["layer_0"]["W"])
    ids = [id(t) for t in _leaves(net.params)]
    prob.write_back(prob.flat0 * 3)
    assert [id(t) for t in _leaves(net.params)] == ids
    assert torch.equal(net.params["layer_1"]["b"],
                       3 * prob.unflatten(prob.flat0)["layer_1"]["b"])


def test_dropout_net_optimizes_one_fixed_mask():
    x, y = make_problem()
    net = port_net(dropout=0.3)
    prob = tsol._FlatProblem(net, DataSet(x, y))
    before = net._gen.get_state()
    a, b = float(prob.loss(prob.flat0)), float(prob.loss(prob.flat0))
    assert a == b
    assert torch.equal(net._gen.get_state(), before)
    res = tsol.LBFGS(net, max_iterations=10).optimize(DataSet(x, y))
    assert np.isfinite(res.score)
    assert torch.equal(net._gen.get_state(), before)


def test_solvers_on_a_computation_graph():
    g = (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-2))
         .graph_builder().add_inputs("in")
         .add_layer("d", Dense(n_in=5, n_out=8, activation="tanh"), "in")
         .add_layer("out", Output(n_out=3, activation="softmax",
                                  loss="mcxent"), "d")
         .set_outputs("out").build())
    net = ComputationGraph(g, device="cpu").init()
    x, y = make_problem(n=128)
    mds = MultiDataSet([x], [y])
    s0 = net.score(mds, train=True)
    solver = tsol.LBFGS(net, max_iterations=20)
    res = solver.optimize(mds)
    assert res.score < 0.5 * s0
    assert solver.probes >= res.iterations
