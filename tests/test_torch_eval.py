"""The port's evaluation classes (deeplearning4j_tpu_torch/eval) against the
JAX package's on the same arrays, on the CPU: Evaluation and its
confusion matrix (2-D and [b, t, c] labels, masks, class-index labels, a
single-output binary head, merge, prediction metadata),
RegressionEvaluation, ROC, ROCBinary, ROCMultiClass (AUC) and
EvaluationBinary.

Both sides count and sum in numpy (f64 where they sum), so every number
and string must be equal exactly. The port also takes tensors: f32 and
bf16 tensors (bf16 widened to f32 on the host) give what the same values
as a numpy array give.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import eval as jev
from deeplearning4j_tpu_torch import eval as tev

C = 5


def _probs(rng, shape):
    z = rng.normal(size=shape)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _cases():
    rng = np.random.default_rng(0)
    y2 = np.eye(C, dtype=np.float32)[rng.integers(0, C, 40)]
    y3 = np.eye(C, dtype=np.float32)[rng.integers(0, C, (6, 7))]
    m3 = (rng.uniform(size=(6, 7)) > 0.3).astype(np.float32)
    m3[2] = 0.0  # an all-masked row
    m2 = (rng.uniform(size=40) > 0.2).astype(np.float32)
    return {
        "2d": (y2, _probs(rng, (40, C)), None),
        "2d_masked": (y2, _probs(rng, (40, C)), m2),
        "3d": (y3, _probs(rng, (6, 7, C)), None),
        "3d_masked": (y3, _probs(rng, (6, 7, C)), m3),
        "indices": (rng.integers(0, C, 40), _probs(rng, (40, C)), None),
        "binary_head": (rng.integers(0, 2, (30, 1)).astype(np.float32),
                        rng.uniform(size=(30, 1)).astype(np.float32), None),
    }


CASES = _cases()


def _metrics(ev):
    n = ev.num_classes
    out = {"matrix": ev.confusion.matrix.tolist(), "acc": ev.accuracy(),
           "p": ev.precision(), "r": ev.recall(), "f1": ev.f1(),
           "stats": ev.stats(), "n": n}
    for c in range(n):
        out[c] = (ev.precision(c), ev.recall(c), ev.f1(c),
                  ev.false_positive_rate(c), ev.matthews_correlation(c),
                  ev.confusion.actual_total(c),
                  ev.confusion.predicted_total(c))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_evaluation_matches_jax(case):
    y, p, m = CASES[case]
    j, t = jev.Evaluation(), tev.Evaluation()
    j.eval(y, p, mask=m)
    t.eval(y, p, mask=m)
    assert _metrics(t) == _metrics(j)
    # the same values as tensors
    tt = tev.Evaluation()
    tt.eval(torch.from_numpy(np.asarray(y)), torch.from_numpy(p),
            mask=None if m is None else torch.from_numpy(m))
    assert _metrics(tt) == _metrics(j)


def test_evaluation_takes_bf16_as_f32():
    y, p, _ = CASES["2d"]
    pb = torch.from_numpy(p).to(torch.bfloat16)
    t = tev.Evaluation()
    t.eval(torch.from_numpy(y), pb)
    j = jev.Evaluation()
    j.eval(y, pb.float().numpy())
    assert _metrics(t) == _metrics(j)
    assert tev.to_host(pb).dtype == np.float32
    assert tev.to_host(torch.zeros(2, dtype=torch.float64)).dtype == \
        np.float64


def test_evaluation_merge_and_meta_match_jax():
    (y, p, _), (y3, p3, m3) = CASES["2d"], CASES["3d_masked"]
    meta = [f"rec{i}" for i in range(len(y))]
    meta3 = [f"seq{i}" for i in range(len(y3))]
    out = []
    for pkg in (jev, tev):
        a, b = pkg.Evaluation(), pkg.Evaluation()
        a.eval(y, p, meta=meta)
        b.eval(y3, p3, mask=m3, meta=meta3)
        a.merge(b)
        empty = pkg.Evaluation().merge(a)
        errs = [(e.actual_class, e.predicted_class, e.record_meta_data)
                for e in a.get_prediction_errors()]
        by = [[(e.actual_class, e.predicted_class, e.record_meta_data)
               for e in f(c)] for c in range(C)
              for f in (a.get_predictions_by_actual_class,
                        a.get_predictions_by_predicted_class)]
        out.append((_metrics(a), _metrics(empty), errs, by,
                    str(a.predictions[0])))
    assert out[1] == out[0]
    with pytest.raises(ValueError, match="meta has"):
        tev.Evaluation().eval(y, p, meta=meta[:3])


def test_evaluation_with_names_and_fixed_classes():
    y, p, _ = CASES["2d"]
    for kw in (dict(num_classes=C), dict(labels=list("abcde"))):
        j, t = jev.Evaluation(**kw), tev.Evaluation(**kw)
        j.eval(y, p)
        t.eval(y, p)
        assert _metrics(t) == _metrics(j) and t.class_names == j.class_names


@pytest.mark.parametrize("case", ["2d", "2d_masked", "3d", "3d_masked"])
def test_regression_evaluation_matches_jax(case):
    rng = np.random.default_rng(1)
    y, _, m = CASES[case]
    labels = rng.normal(size=y.shape).astype(np.float32)
    preds = (labels + rng.normal(scale=0.3, size=y.shape)).astype(np.float32)
    j = jev.RegressionEvaluation(column_names=list("vwxyz"))
    t = tev.RegressionEvaluation(column_names=list("vwxyz"))
    for part in (slice(0, 3), slice(3, None)):
        mm = None if m is None else m[part]
        j.eval(labels[part], preds[part], mask=mm)
        t.eval(torch.from_numpy(labels[part]), preds[part], mask=mm)
    assert t.num_columns() == j.num_columns() == C
    for c in range(C):
        for f in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "relative_squared_error",
                  "correlation_r2"):
            assert getattr(t, f)(c) == getattr(j, f)(c), (f, c)
    assert t.average_mean_squared_error() == j.average_mean_squared_error()
    assert t.average_mean_absolute_error() == \
        j.average_mean_absolute_error()
    assert t.stats() == j.stats()


def _roc_inputs(two_col):
    rng = np.random.default_rng(2)
    y = rng.integers(0, 2, 60)
    score = np.clip(0.35 * y + rng.uniform(size=60) * 0.65, 0, 1)
    if two_col:
        return (np.eye(2, dtype=np.float32)[y],
                np.stack([1 - score, score], -1).astype(np.float32))
    return y[:, None].astype(np.float32), score[:, None].astype(np.float32)


@pytest.mark.parametrize("two_col", [False, True], ids=["one", "two"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_roc_matches_jax(two_col, masked):
    y, p = _roc_inputs(two_col)
    m = (np.arange(60) % 4 != 0).astype(np.float32) if masked else None
    j, t = jev.ROC(threshold_steps=20), tev.ROC(threshold_steps=20)
    for part in (slice(0, 25), slice(25, None)):
        mm = None if m is None else m[part]
        j.eval(y[part], p[part], mask=mm)
        t.eval(torch.from_numpy(y[part]), torch.from_numpy(p[part]), mask=mm)
    for a in ("tp", "fp", "fn", "tn", "thresholds"):
        np.testing.assert_array_equal(getattr(t, a), getattr(j, a))
    assert t.calculate_auc() == j.calculate_auc()
    assert 0.5 < t.calculate_auc() <= 1.0
    for got, want in zip(t.get_roc_curve() + t.get_precision_recall_curve(),
                         j.get_roc_curve() + j.get_precision_recall_curve()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cls", ["ROCBinary", "ROCMultiClass"])
@pytest.mark.parametrize("case", ["2d", "3d_masked"])
def test_per_column_roc_matches_jax(cls, case):
    y, p, m = CASES[case]
    j, t = getattr(jev, cls)(threshold_steps=50), \
        getattr(tev, cls)(threshold_steps=50)
    j.eval(y, p, mask=m)
    t.eval(y, p, mask=m)
    assert [t.calculate_auc(c) for c in range(C)] == \
        [j.calculate_auc(c) for c in range(C)]
    assert t.average_auc() == j.average_auc()


@pytest.mark.parametrize("case", ["2d", "2d_masked", "3d", "3d_masked"])
def test_evaluation_binary_matches_jax(case):
    y, p, m = CASES[case]
    j, t = jev.EvaluationBinary(0.3), tev.EvaluationBinary(0.3)
    for _ in range(2):
        j.eval(y, p, mask=m)
        t.eval(torch.from_numpy(y), torch.from_numpy(p),
               mask=None if m is None else torch.from_numpy(m))
    assert t.num_outputs() == j.num_outputs() == C
    for a in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(t, a), getattr(j, a))
    for c in range(C):
        assert (t.accuracy(c), t.precision(c), t.recall(c), t.f1(c)) == \
            (j.accuracy(c), j.precision(c), j.recall(c), j.f1(c))
    assert t.stats() == j.stats()
