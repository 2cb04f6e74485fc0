"""The port's HTML evaluation reports (deeplearning4j_tpu_torch/eval/
tools.py) against the JAX package's: the accumulators of both packages
are built from the same arrays, and every report renders the same HTML
string (the charts, the confusion matrix and metric tables, the pages
written to files)."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.eval import Evaluation as JEvaluation
from deeplearning4j_tpu.eval import ROC as JROC
from deeplearning4j_tpu.eval import ROCBinary as JROCBinary
from deeplearning4j_tpu.eval import ROCMultiClass as JROCMultiClass
from deeplearning4j_tpu.eval import tools as jtools
from deeplearning4j_tpu_torch.eval import (ROC, Evaluation, ROCBinary,
                                           ROCMultiClass)
from deeplearning4j_tpu_torch.eval import tools as ttools


def _data(n=64, c=4, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32)
    idx = rng.integers(0, c, n)
    logits[np.arange(n), idx] += 1.0        # better than chance
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return np.eye(c, dtype=np.float32)[idx], p.astype(np.float32)


def _binary(n=80, seed=1):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    score = np.clip(0.3 * y + 0.7 * rng.random(n), 0, 1).astype(np.float32)
    return (np.eye(2, dtype=np.float32)[y],
            np.stack([1 - score, score], 1).astype(np.float32))


@pytest.mark.parametrize("names", [None, ["a", "b<", "c", "d"]],
                         ids=["indices", "names"])
def test_evaluation_html_equals_the_jax_string(tmp_path, names):
    y, p = _data()
    ev, jev = Evaluation(), JEvaluation()
    ev.eval(torch.from_numpy(y), torch.from_numpy(p))
    jev.eval(y, p)
    assert ttools.evaluation_html(ev, names) == \
        jtools.evaluation_html(jev, names)
    assert [c.render() for c in ttools.evaluation_components(ev, names)] \
        == [c.render() for c in jtools.evaluation_components(jev, names)]
    ttools.export_evaluation_to_html_file(ev, str(tmp_path / "p.html"),
                                          class_names=names)
    jtools.export_evaluation_to_html_file(jev, str(tmp_path / "j.html"),
                                          class_names=names)
    assert (tmp_path / "p.html").read_text() == \
        (tmp_path / "j.html").read_text()


@pytest.mark.parametrize("steps", [0, 10, 100])
def test_roc_html_equals_the_jax_string(tmp_path, steps):
    y, p = _binary()
    roc, jroc = ROC(steps), JROC(steps)
    roc.eval(y, p)
    jroc.eval(y, p)
    assert ttools.roc_chart_html(roc, "my roc") == \
        jtools.roc_chart_html(jroc, "my roc")
    ttools.export_roc_charts_to_html_file(roc, str(tmp_path / "p.html"))
    jtools.export_roc_charts_to_html_file(jroc, str(tmp_path / "j.html"))
    assert (tmp_path / "p.html").read_text() == \
        (tmp_path / "j.html").read_text()


@pytest.mark.parametrize("kind", ["multiclass", "binary"])
def test_multi_roc_pages_equal_the_jax_pages(tmp_path, kind):
    y, p = _data(seed=3)
    if kind == "multiclass":
        roc, jroc = ROCMultiClass(20), JROCMultiClass(20)
    else:
        roc, jroc = ROCBinary(20), JROCBinary(20)
    roc.eval(y, p)
    jroc.eval(y, p)
    ttools.export_roc_charts_to_html_file(roc, str(tmp_path / "p.html"),
                                          title="per class")
    jtools.export_roc_charts_to_html_file(jroc, str(tmp_path / "j.html"),
                                          title="per class")
    page = (tmp_path / "p.html").read_text()
    assert page == (tmp_path / "j.html").read_text()
    assert page.count("class ") >= 4
