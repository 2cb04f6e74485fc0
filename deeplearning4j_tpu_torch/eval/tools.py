"""Self-contained HTML evaluation reports (counterpart of
deeplearning4j_tpu/eval/tools.py, over the port's eval/ accumulators;
the same HTML for the same inputs).

Parity: deeplearning4j-core evaluation/EvaluationTools.java
(exportRocChartsToHtmlFile / exportEvaluationToHtmlFile). The reference
composes its reports from the deeplearning4j-ui-components library; this
module does the same through ``ui/components.py`` (ChartLine for
ROC/precision-recall, ComponentTable for the confusion matrix and metric
tables, rendered to one standalone page with inline SVG — zero external
assets, same stance as ui/server.py)."""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.ui.components import (
    ChartLine, ComponentDiv, ComponentTable, ComponentText, Style,
    render_components_to_file)

def _chart_style() -> Style:
    """Per-chart style instance (Style is mutable — never share one)."""
    return Style(width=380, height=380)


def _unit_chart(title, xlabel, ylabel, xs, ys, diagonal=False) -> ChartLine:
    c = ChartLine(title, _chart_style(), xlabel=xlabel, ylabel=ylabel)
    if diagonal:
        c.add_series("chance", [0.0, 1.0], [0.0, 1.0])
    c.add_series(title, list(map(float, xs)), list(map(float, ys)))
    return c


def roc_components(roc, title: str = "ROC"):
    """ROC + precision/recall chart pair for one ``ROC`` accumulator, as
    UI components (the reference builds the same pair of ChartLine
    components in EvaluationTools.rocChart)."""
    fpr, tpr = roc.get_roc_curve()
    order = np.argsort(fpr, kind="stable")
    rec, prec = roc.get_precision_recall_curve()
    ro = np.argsort(rec, kind="stable")
    auc = roc.calculate_auc()
    return ComponentDiv(
        _unit_chart(f"{title} (AUC {auc:.4f})", "False positive rate",
                    "True positive rate", fpr[order], tpr[order],
                    diagonal=True),
        _unit_chart(f"{title} P-R", "Recall", "Precision", rec[ro],
                    prec[ro]))


def roc_chart_html(roc, title: str = "ROC") -> str:
    """Rendered HTML for one ROC chart pair (back-compat surface)."""
    return roc_components(roc, title).render()


def export_roc_charts_to_html_file(roc, path: str,
                                   title: str = "ROC evaluation"):
    """EvaluationTools.exportRocChartsToHtmlFile parity. ``roc`` is a
    ``ROC`` or a ``ROCMultiClass`` (one chart pair per class)."""
    comps = []
    if hasattr(roc, "rocs"):  # ROCMultiClass / ROCBinary
        for i, r in enumerate(getattr(roc, "rocs")):
            comps.append(roc_components(r, title=f"class {i}"))
    else:
        comps.append(roc_components(roc, title="ROC"))
    render_components_to_file(comps, path, title)


def evaluation_components(ev, class_names=None):
    """Confusion matrix + per-class metric tables for an ``Evaluation``,
    as UI components."""
    n = ev.num_classes
    names = class_names or ev.class_names or [str(i) for i in range(n)]
    conf_rows = [[str(names[i])]
                 + [str(ev.confusion.get_count(i, j)) for j in range(n)]
                 for i in range(n)]
    conf = ComponentTable(
        [""] + [str(c) for c in names], conf_rows,
        title="Confusion matrix (rows = actual)",
        highlight_cells=[(i, i + 1) for i in range(n)])
    met_rows = [[str(names[c]), f"{ev.precision(c):.4f}",
                 f"{ev.recall(c):.4f}", f"{ev.f1(c):.4f}"]
                for c in range(n)]
    mets = ComponentTable(["class", "precision", "recall", "f1"], met_rows,
                          title="Per-class metrics")
    summary = ComponentText(
        f"accuracy {ev.accuracy():.4f} — macro-F1 {ev.f1():.4f}")
    return [conf, mets, summary]


def evaluation_html(ev, class_names=None) -> str:
    """Rendered HTML fragment (back-compat surface)."""
    return "\n".join(c.render()
                     for c in evaluation_components(ev, class_names))


def export_evaluation_to_html_file(ev, path: str,
                                   title: str = "Classification evaluation",
                                   class_names=None):
    """EvaluationTools evaluation-report parity (confusion + metrics)."""
    render_components_to_file(evaluation_components(ev, class_names), path,
                              title)
