"""The port's report components (deeplearning4j_tpu_torch/ui/components.py)
against the JAX package's: for the same inputs every component renders
the same HTML string, serializes to the same dict, and a dict one package
wrote reads back in the other to the same HTML; a page and a file render
the same way; and the tracer's timeline (observability/trace.py) renders
the JAX package's timeline for the same spans."""

import numpy as np
import pytest

from deeplearning4j_tpu.observability import trace as jtrace
from deeplearning4j_tpu.ui import components as jc
from deeplearning4j_tpu_torch.observability import trace as ttrace
from deeplearning4j_tpu_torch.ui import components as tc


def _values(seed):
    return np.random.default_rng(seed).normal(size=300)


BUILDERS = {
    "text": lambda m: m.ComponentText("<b>score</b> & 'loss'"),
    "text_styled": lambda m: m.ComponentText(
        "x", m.Style(font_size=16.0, color="#123456")),
    "table": lambda m: m.ComponentTable(
        ["class", "p"], [["<a>", 0.5], ["b", 1.25]], title="T&T",
        highlight_cells=[(0, 1)]),
    "div": lambda m: m.ComponentDiv(m.ComponentText("a"),
                                    m.ComponentTable(["h"], [[1]])),
    "accordion": lambda m: m.DecoratorAccordion(
        "sec", m.ComponentText("in"), default_collapsed=True),
    "line": lambda m: m.ChartLine("loss", xlabel="iter", ylabel="score")
    .add_series("train", [0, 1, 2, 3], [3.0, 2.0, 1.5, float("nan")])
    .add_series("val", [0, 1, 2], [3.2, 2.4, 2.0]),
    "line_flat": lambda m: m.ChartLine("flat").add_series(
        "s", [1, 1, 1], [2, 2, 2]),
    "scatter": lambda m: m.ChartScatter("pts", m.Style(width=300.0))
    .add_series("s", [0.1, -2.0, 3.5], [1, 2e-4, 3e5]),
    "histogram": lambda m: m.ChartHistogram.of(_values(0), n_bins=20),
    "histogram_bins": lambda m: m.ChartHistogram("h").add_bin(0, 1, 5)
    .add_bin(1, 2.5, 0.5),
    "hbar": lambda m: m.ChartHorizontalBar("phases").add_value(
        "fit", 12.0).add_value("average", 3.0),
    "stacked": lambda m: m.ChartStackedArea("a", x=[0, 1, 2])
    .add_series("s", [1, 2, 3]).add_series("t", [2, 1, 0]),
    "timeline": lambda m: m.ChartTimeline("phases", xlabel="s")
    .add_lane("worker_0", [(0.0, 1.5, "fit", "#1f77b4"),
                           (1.5, 1.9, "average", "#ff7f0e")])
    .add_lane("worker_1", [(0.0, 1.4, "fit", "#1f77b4")]),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_component_html_equals_the_jax_string(name):
    got, want = BUILDERS[name](tc), BUILDERS[name](jc)
    assert got.render() == want.render()
    assert got.to_json() == want.to_json()   # NaN != NaN in a dict


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_a_dict_crosses_between_the_packages(name):
    d = BUILDERS[name](tc).to_dict()
    assert jc.Component.from_dict(d).render() == \
        tc.Component.from_dict(d).render()
    jd = BUILDERS[name](jc).to_dict()
    assert tc.Component.from_dict(jd).to_json() == \
        jc.Component.from_dict(jd).to_json()


def test_page_and_file_render_like_the_jax_ones(tmp_path):
    names = sorted(BUILDERS)
    got = tc.render_components_to_html([BUILDERS[n](tc) for n in names],
                                       title="a <report>")
    want = jc.render_components_to_html([BUILDERS[n](jc) for n in names],
                                        title="a <report>")
    assert got == want
    tc.render_components_to_file([BUILDERS["line"](tc)],
                                 str(tmp_path / "p.html"), "r")
    jc.render_components_to_file([BUILDERS["line"](jc)],
                                 str(tmp_path / "j.html"), "r")
    assert (tmp_path / "p.html").read_text() == \
        (tmp_path / "j.html").read_text()


def test_refusals_match():
    with pytest.raises(ValueError):
        tc.Component.from_dict({"componentType": "Nope"})
    with pytest.raises(ValueError):
        tc.ChartStackedArea("a", x=[0, 1, 2]).add_series("s", [1, 2])
    assert sorted(tc._REGISTRY) == sorted(jc._REGISTRY)


def test_trace_timeline_renders_the_jax_timeline(tmp_path):
    """The tracer's timeline (observability/trace.py) for the same spans:
    the same ChartTimeline, the same HTML page."""
    rows = [("data_wait", 0, 1000, 1, "MainThread"),
            ("device_step", 1000, 4000, 1, "MainThread"),
            ("pipe_collate", 500, 700, 2, "dl4j-pipe-prefetch"),
            ("checkpoint_write", 2000, 2500, 3, "")]

    def spans(mod):
        return [mod.Span(name=n, ts_us=ts, dur_us=d, tid=tid, thread=th,
                         attrs=None)
                for n, ts, d, tid, th in rows]
    got = ttrace.trace_timeline_component(spans(ttrace), title="run")
    want = jtrace.trace_timeline_component(spans(jtrace), title="run")
    assert got.render() == want.render()
    ttrace.export_trace_html(spans(ttrace), str(tmp_path / "p.html"))
    jtrace.export_trace_html(spans(jtrace), str(tmp_path / "j.html"))
    assert (tmp_path / "p.html").read_text() == \
        (tmp_path / "j.html").read_text()
    assert "dl4j-pipe-prefetch" in (tmp_path / "p.html").read_text()
