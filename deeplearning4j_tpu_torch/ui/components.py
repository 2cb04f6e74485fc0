"""Standalone UI component library: build reports from typed components,
render to self-contained HTML (inline SVG, zero external assets)
(counterpart of deeplearning4j_tpu/ui/components.py: host only, and for
the same inputs the same HTML string).

Parity: deeplearning4j-ui-parent/deeplearning4j-ui-components — the
reference's reusable report tier (api/Component.java, api/Style.java,
text/ComponentText.java, table/ComponentTable.java,
component/ComponentDiv.java, decorator/DecoratorAccordion.java,
chart/ChartLine|Scatter|Histogram|HorizontalBar|StackedArea|Timeline.java,
standalone/StaticPageUtil.java). The reference serializes components to
JSON and renders them client-side with d3; in a zero-egress TPU pod there
is no CDN, so here components render SERVER-side to inline SVG — same
component model, same composition (EvaluationTools and the distributed
training timeline both emit through it), different rendering backend.
Each component also round-trips ``to_dict``/``from_dict`` (the
ComponentObject serialization surface).
"""

from __future__ import annotations

import html as _html
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# default categorical palette (d3.schemeCategory10 — what the reference's
# client-side charts use by default)
PALETTE = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
           "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")


@dataclass
class Style:
    """Visual style (api/Style.java + the chart/text/table/div style
    subclasses, collapsed into one flat bag — px units only)."""
    width: float = 560.0
    height: float = 340.0
    margin_top: float = 28.0
    margin_bottom: float = 40.0
    margin_left: float = 50.0
    margin_right: float = 16.0
    background_color: str = "#ffffff"
    color: str = "#222222"
    font_size: float = 12.0
    stroke_width: float = 1.8
    point_size: float = 3.0
    header_color: str = "#f0f0f4"
    border_color: str = "#cccccc"

    def to_dict(self):
        return {k: v for k, v in self.__dict__.items()}

    @classmethod
    def from_dict(cls, d):
        s = cls()
        for k, v in (d or {}).items():
            if hasattr(s, k):
                setattr(s, k, v)
        return s


class Component:
    """Base component (api/Component.java): typed, stylable, renderable."""

    component_type = "component"

    def __init__(self, style: Optional[Style] = None):
        self.style = style or Style()

    def render(self) -> str:
        raise NotImplementedError

    def _payload(self) -> dict:
        raise NotImplementedError

    def to_dict(self) -> dict:
        return {"componentType": self.component_type,
                "style": self.style.to_dict(), **self._payload()}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "Component":
        ct = d.get("componentType")
        cls = _REGISTRY.get(ct)
        if cls is None:
            raise ValueError(f"Unknown componentType '{ct}'")
        return cls._from_payload(d, Style.from_dict(d.get("style")))


# ---------------------------------------------------------------------------
# text / table / div / decorator
# ---------------------------------------------------------------------------

class ComponentText(Component):
    """text/ComponentText.java."""

    component_type = "ComponentText"

    def __init__(self, text: str, style: Optional[Style] = None):
        super().__init__(style)
        self.text = text

    def render(self) -> str:
        st = self.style
        return (f'<p style="color:{st.color};font-size:{st.font_size}px">'
                f"{_html.escape(self.text)}</p>")

    def _payload(self):
        return {"text": self.text}

    @classmethod
    def _from_payload(cls, d, style):
        return cls(d["text"], style)


class ComponentTable(Component):
    """table/ComponentTable.java: header + rows of strings."""

    component_type = "ComponentTable"

    def __init__(self, header: Sequence[str], content: Sequence[Sequence],
                 style: Optional[Style] = None, title: str = "",
                 highlight_cells: Sequence[Tuple[int, int]] = ()):
        super().__init__(style)
        self.title = title
        self.header = [str(h) for h in header]
        self.content = [[str(c) for c in row] for row in content]
        self.highlight_cells = {(int(r), int(c))
                                for r, c in highlight_cells}

    def render(self) -> str:
        st = self.style
        head = "".join(
            f'<th style="background:{st.header_color};border:1px solid '
            f'{st.border_color};padding:4px 9px">{_html.escape(h)}</th>'
            for h in self.header)
        rows = []
        for r, row in enumerate(self.content):
            cells = []
            for c, cell in enumerate(row):
                hl = ("background:#e4efe4;font-weight:600;"
                      if (r, c) in self.highlight_cells else "")
                cells.append(
                    f'<td style="{hl}border:1px solid {st.border_color};'
                    f'padding:4px 9px;text-align:right">'
                    f"{_html.escape(cell)}</td>")
            rows.append(f"<tr>{''.join(cells)}</tr>")
        title = (f"<h3>{_html.escape(self.title)}</h3>" if self.title else "")
        return (f'{title}<table style="border-collapse:collapse;'
                f'font-size:{st.font_size + 1}px;margin:8px 0">'
                f"<tr>{head}</tr>{''.join(rows)}</table>")

    def _payload(self):
        return {"title": self.title, "header": self.header,
                "content": self.content,
                "highlight": sorted(self.highlight_cells)}

    @classmethod
    def _from_payload(cls, d, style):
        return cls(d["header"], d["content"], style, d.get("title", ""),
                   d.get("highlight", ()))


class ComponentDiv(Component):
    """component/ComponentDiv.java: container composing child components."""

    component_type = "ComponentDiv"

    def __init__(self, *children: Component, style: Optional[Style] = None,
                 flex: bool = True):
        super().__init__(style)
        self.children = list(children)
        self.flex = flex

    def add(self, child: Component) -> "ComponentDiv":
        self.children.append(child)
        return self

    def render(self) -> str:
        disp = ("display:flex;flex-wrap:wrap;gap:22px;align-items:flex-start"
                if self.flex else "")
        inner = "\n".join(c.render() for c in self.children)
        return f'<div style="{disp}">{inner}</div>'

    def _payload(self):
        return {"flex": self.flex,
                "children": [c.to_dict() for c in self.children]}

    @classmethod
    def _from_payload(cls, d, style):
        kids = [Component.from_dict(c) for c in d.get("children", [])]
        return cls(*kids, style=style, flex=d.get("flex", True))


class DecoratorAccordion(Component):
    """decorator/DecoratorAccordion.java: collapsible section (native
    <details>, no JS)."""

    component_type = "DecoratorAccordion"

    def __init__(self, title: str, *children: Component,
                 default_collapsed: bool = False,
                 style: Optional[Style] = None):
        super().__init__(style)
        self.title = title
        self.children = list(children)
        self.default_collapsed = default_collapsed

    def render(self) -> str:
        inner = "\n".join(c.render() for c in self.children)
        op = "" if self.default_collapsed else " open"
        return (f"<details{op}><summary style=\"cursor:pointer;"
                f"font-weight:600\">{_html.escape(self.title)}</summary>"
                f"{inner}</details>")

    def _payload(self):
        return {"title": self.title,
                "defaultCollapsed": self.default_collapsed,
                "children": [c.to_dict() for c in self.children]}

    @classmethod
    def _from_payload(cls, d, style):
        kids = [Component.from_dict(c) for c in d.get("children", [])]
        return cls(d["title"], *kids,
                   default_collapsed=d.get("defaultCollapsed", False),
                   style=style)


# ---------------------------------------------------------------------------
# charts (chart/Chart.java subclasses)
# ---------------------------------------------------------------------------

def _nice_ticks(lo: float, hi: float, n: int = 5):
    """~n rounded tick positions covering [lo, hi]."""
    if not np.isfinite(lo) or not np.isfinite(hi):
        lo, hi = 0.0, 1.0
    if hi <= lo:
        hi = lo + 1.0
    raw = (hi - lo) / max(n, 1)
    mag = 10.0 ** np.floor(np.log10(raw))
    for m in (1, 2, 2.5, 5, 10):
        if raw <= m * mag:
            step = m * mag
            break
    t0 = np.ceil(lo / step) * step
    ticks = []
    t = t0
    while t <= hi + 1e-9 * step:
        ticks.append(round(t, 10))
        t += step
    return ticks or [lo, hi]


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1e4 or abs(v) < 1e-3:
        return f"{v:.1e}"
    return f"{v:g}"


class Chart(Component):
    """Shared axes/frame machinery (chart/Chart.java + StyleChart)."""

    def __init__(self, title: str, style: Optional[Style] = None,
                 xlabel: str = "", ylabel: str = ""):
        super().__init__(style)
        self.title = title
        self.xlabel = xlabel
        self.ylabel = ylabel

    # -- frame ------------------------------------------------------------
    def _frame(self, x_lo, x_hi, y_lo, y_hi, body: str,
               legend: Sequence[Tuple[str, str]] = (),
               x_ticks=None, y_ticks=None) -> str:
        st = self.style
        w, h = st.width, st.height
        il, it = st.margin_left, st.margin_top
        iw = w - st.margin_left - st.margin_right
        ih = h - st.margin_top - st.margin_bottom

        xt = x_ticks if x_ticks is not None else _nice_ticks(x_lo, x_hi)
        yt = y_ticks if y_ticks is not None else _nice_ticks(y_lo, y_hi)
        sx = iw / (x_hi - x_lo) if x_hi > x_lo else 1.0
        sy = ih / (y_hi - y_lo) if y_hi > y_lo else 1.0

        def X(v):
            return il + (v - x_lo) * sx

        def Y(v):
            return it + ih - (v - y_lo) * sy

        grid = []
        for v in xt:
            if x_lo <= v <= x_hi:
                grid.append(
                    f'<line x1="{X(v):.1f}" y1="{it}" x2="{X(v):.1f}" '
                    f'y2="{it + ih}" stroke="#eee"/>'
                    f'<text x="{X(v):.1f}" y="{it + ih + 15}" '
                    f'font-size="10" text-anchor="middle">{_fmt(v)}</text>')
        for v in yt:
            if y_lo <= v <= y_hi:
                grid.append(
                    f'<line x1="{il}" y1="{Y(v):.1f}" x2="{il + iw}" '
                    f'y2="{Y(v):.1f}" stroke="#eee"/>'
                    f'<text x="{il - 6}" y="{Y(v) + 3:.1f}" font-size="10" '
                    f'text-anchor="end">{_fmt(v)}</text>')
        leg = []
        lx = il + 8
        for i, (name, color) in enumerate(legend):
            leg.append(
                f'<rect x="{lx}" y="{it + 6 + 14 * i}" width="10" '
                f'height="10" fill="{color}"/>'
                f'<text x="{lx + 14}" y="{it + 15 + 14 * i}" '
                f'font-size="10">{_html.escape(name)}</text>')
        xl = (f'<text x="{il + iw / 2}" y="{h - 6}" text-anchor="middle" '
              f'font-size="11">{_html.escape(self.xlabel)}</text>'
              if self.xlabel else "")
        yl = (f'<text x="12" y="{it + ih / 2}" font-size="11" '
              f'text-anchor="middle" transform="rotate(-90 12 '
              f'{it + ih / 2})">{_html.escape(self.ylabel)}</text>'
              if self.ylabel else "")
        return (
            f'<svg width="{w:.0f}" height="{h:.0f}" '
            f'style="background:{st.background_color};border:1px solid '
            f'{st.border_color}">'
            f'<text x="{w / 2}" y="17" text-anchor="middle" font-size="13" '
            f'font-weight="600">{_html.escape(self.title)}</text>'
            f'{"".join(grid)}'
            f'<rect x="{il}" y="{it}" width="{iw}" height="{ih}" '
            f'fill="none" stroke="#999"/>'
            f"{body}{''.join(leg)}{xl}{yl}</svg>")

    def _scales(self, x_lo, x_hi, y_lo, y_hi):
        st = self.style
        iw = st.width - st.margin_left - st.margin_right
        ih = st.height - st.margin_top - st.margin_bottom
        sx = iw / (x_hi - x_lo) if x_hi > x_lo else 1.0
        sy = ih / (y_hi - y_lo) if y_hi > y_lo else 1.0
        return (lambda v: st.margin_left + (v - x_lo) * sx,
                lambda v: st.margin_top + ih - (v - y_lo) * sy)


def _series_extent(series):
    xs = np.concatenate([np.asarray(x, float) for _n, x, _y in series]) \
        if series else np.array([0.0, 1.0])
    ys = np.concatenate([np.asarray(y, float) for _n, _x, y in series]) \
        if series else np.array([0.0, 1.0])
    xs = xs[np.isfinite(xs)]
    ys = ys[np.isfinite(ys)]
    if xs.size == 0:
        xs = np.array([0.0, 1.0])
    if ys.size == 0:
        ys = np.array([0.0, 1.0])
    pad_y = 0.05 * (ys.max() - ys.min() or 1.0)
    return (float(xs.min()), float(xs.max()),
            float(ys.min() - pad_y), float(ys.max() + pad_y))


class ChartLine(Chart):
    """chart/ChartLine.java: named (x, y) series as polylines."""

    component_type = "ChartLine"

    def __init__(self, title: str, style: Optional[Style] = None, **kw):
        super().__init__(title, style, **kw)
        self.series: List[Tuple[str, list, list]] = []

    def add_series(self, name: str, x, y) -> "ChartLine":
        self.series.append((str(name), [float(v) for v in x],
                            [float(v) for v in y]))
        return self

    def render(self) -> str:
        x_lo, x_hi, y_lo, y_hi = _series_extent(self.series)
        X, Y = self._scales(x_lo, x_hi, y_lo, y_hi)
        body, legend = [], []
        for i, (name, xs, ys) in enumerate(self.series):
            color = PALETTE[i % len(PALETTE)]
            pts = " ".join(f"{X(x):.1f},{Y(y):.1f}"
                           for x, y in zip(xs, ys)
                           if np.isfinite(x) and np.isfinite(y))
            body.append(f'<polyline points="{pts}" fill="none" '
                        f'stroke="{color}" '
                        f'stroke-width="{self.style.stroke_width}"/>')
            legend.append((name, color))
        return self._frame(x_lo, x_hi, y_lo, y_hi, "".join(body),
                           legend if len(legend) > 1 else ())

    def _payload(self):
        return {"title": self.title, "xlabel": self.xlabel,
                "ylabel": self.ylabel,
                "series": [{"name": n, "x": x, "y": y}
                           for n, x, y in self.series]}

    @classmethod
    def _from_payload(cls, d, style):
        c = cls(d["title"], style, xlabel=d.get("xlabel", ""),
                ylabel=d.get("ylabel", ""))
        for s in d.get("series", []):
            c.add_series(s["name"], s["x"], s["y"])
        return c


class ChartScatter(ChartLine):
    """chart/ChartScatter.java: same series model, point marks."""

    component_type = "ChartScatter"

    def render(self) -> str:
        x_lo, x_hi, y_lo, y_hi = _series_extent(self.series)
        X, Y = self._scales(x_lo, x_hi, y_lo, y_hi)
        body, legend = [], []
        for i, (name, xs, ys) in enumerate(self.series):
            color = PALETTE[i % len(PALETTE)]
            body.extend(
                f'<circle cx="{X(x):.1f}" cy="{Y(y):.1f}" '
                f'r="{self.style.point_size}" fill="{color}" '
                f'fill-opacity="0.75"/>'
                for x, y in zip(xs, ys)
                if np.isfinite(x) and np.isfinite(y))
            legend.append((name, color))
        return self._frame(x_lo, x_hi, y_lo, y_hi, "".join(body),
                           legend if len(legend) > 1 else ())


class ChartStackedArea(Chart):
    """chart/ChartStackedArea.java: shared x, stacked named y series."""

    component_type = "ChartStackedArea"

    def __init__(self, title: str, x: Sequence[float] = (),
                 style: Optional[Style] = None, **kw):
        super().__init__(title, style, **kw)
        self.x = [float(v) for v in x]
        self.series: List[Tuple[str, list]] = []

    def add_series(self, name: str, y) -> "ChartStackedArea":
        y = [float(v) for v in y]
        if len(y) != len(self.x):
            raise ValueError(f"series '{name}' length {len(y)} != x length "
                             f"{len(self.x)}")
        self.series.append((str(name), y))
        return self

    def render(self) -> str:
        if not self.x or not self.series:
            return self._frame(0, 1, 0, 1, "")
        stack = np.zeros(len(self.x))
        tops = []
        for _name, y in self.series:
            stack = stack + np.asarray(y)
            tops.append(stack.copy())
        x_lo, x_hi = min(self.x), max(self.x)
        y_lo, y_hi = 0.0, float(stack.max() or 1.0) * 1.05
        X, Y = self._scales(x_lo, x_hi, y_lo, y_hi)
        body, legend = [], []
        prev = np.zeros(len(self.x))
        for i, ((name, _y), top) in enumerate(zip(self.series, tops)):
            color = PALETTE[i % len(PALETTE)]
            fwd = [f"{X(x):.1f},{Y(t):.1f}" for x, t in zip(self.x, top)]
            back = [f"{X(x):.1f},{Y(p):.1f}"
                    for x, p in zip(reversed(self.x), reversed(prev))]
            body.append(f'<polygon points="{" ".join(fwd + back)}" '
                        f'fill="{color}" fill-opacity="0.8"/>')
            legend.append((name, color))
            prev = top
        return self._frame(x_lo, x_hi, y_lo, y_hi, "".join(body), legend)

    def _payload(self):
        return {"title": self.title, "x": self.x,
                "series": [{"name": n, "y": y} for n, y in self.series]}

    @classmethod
    def _from_payload(cls, d, style):
        c = cls(d["title"], d.get("x", ()), style)
        for s in d.get("series", []):
            c.add_series(s["name"], s["y"])
        return c


class ChartHistogram(Chart):
    """chart/ChartHistogram.java: explicit (low, high, count) bins."""

    component_type = "ChartHistogram"

    def __init__(self, title: str, style: Optional[Style] = None, **kw):
        super().__init__(title, style, **kw)
        self.bins: List[Tuple[float, float, float]] = []

    def add_bin(self, low: float, high: float, count: float):
        self.bins.append((float(low), float(high), float(count)))
        return self

    @classmethod
    def of(cls, values, n_bins: int = 30, title: str = "histogram",
           style: Optional[Style] = None):
        v = np.asarray(values, float).ravel()
        v = v[np.isfinite(v)]
        if v.size == 0:
            return cls(title, style)
        counts, edges = np.histogram(v, bins=n_bins)
        c = cls(title, style)
        for i, n in enumerate(counts):
            c.add_bin(edges[i], edges[i + 1], float(n))
        return c

    def render(self) -> str:
        if not self.bins:
            return self._frame(0, 1, 0, 1, "")
        x_lo = min(b[0] for b in self.bins)
        x_hi = max(b[1] for b in self.bins)
        y_hi = max(b[2] for b in self.bins) * 1.05 or 1.0
        X, Y = self._scales(x_lo, x_hi, 0.0, y_hi)
        body = [
            f'<rect x="{X(lo):.1f}" y="{Y(n):.1f}" '
            f'width="{max(X(hi) - X(lo) - 0.5, 0.5):.1f}" '
            f'height="{max(Y(0) - Y(n), 0):.1f}" fill="{PALETTE[0]}" '
            f'fill-opacity="0.85"/>'
            for lo, hi, n in self.bins]
        return self._frame(x_lo, x_hi, 0.0, y_hi, "".join(body))

    def _payload(self):
        return {"title": self.title,
                "bins": [{"low": a, "high": b, "count": c}
                         for a, b, c in self.bins]}

    @classmethod
    def _from_payload(cls, d, style):
        c = cls(d["title"], style)
        for b in d.get("bins", []):
            c.add_bin(b["low"], b["high"], b["count"])
        return c


class ChartHorizontalBar(Chart):
    """chart/ChartHorizontalBar.java: labeled horizontal bars."""

    component_type = "ChartHorizontalBar"

    def __init__(self, title: str, style: Optional[Style] = None, **kw):
        super().__init__(title, style, **kw)
        self.values: List[Tuple[str, float]] = []

    def add_value(self, label: str, value: float):
        self.values.append((str(label), float(value)))
        return self

    def render(self) -> str:
        if not self.values:
            return self._frame(0, 1, 0, 1, "")
        st = self.style
        # both bounds clamp through 0 so all-negative values keep
        # x_lo < 0 <= x_hi (bars grow leftward from the zero line)
        x_hi = max(0.0, max(v for _l, v in self.values) * 1.05)
        x_lo = min(0.0, min(v for _l, v in self.values) * 1.05)
        if x_hi == x_lo:  # all zeros
            x_hi = 1.0
        it = st.margin_top
        ih = st.height - st.margin_top - st.margin_bottom
        bar_h = ih / len(self.values)
        X, _ = self._scales(x_lo, x_hi, 0.0, 1.0)
        body = []
        for i, (label, v) in enumerate(self.values):
            y = it + i * bar_h
            color = PALETTE[i % len(PALETTE)]
            body.append(
                f'<rect x="{X(min(0.0, v)):.1f}" y="{y + 2:.1f}" '
                f'width="{abs(X(v) - X(0)):.1f}" '
                f'height="{max(bar_h - 4, 1):.1f}" fill="{color}" '
                f'fill-opacity="0.85"/>'
                f'<text x="{st.margin_left - 6}" '
                f'y="{y + bar_h / 2 + 3:.1f}" font-size="10" '
                f'text-anchor="end">{_html.escape(label)}</text>')
        return self._frame(x_lo, x_hi, 0.0, 1.0, "".join(body), y_ticks=[])

    def _payload(self):
        return {"title": self.title,
                "values": [{"label": l, "value": v}
                           for l, v in self.values]}

    @classmethod
    def _from_payload(cls, d, style):
        c = cls(d["title"], style)
        for v in d.get("values", []):
            c.add_value(v["label"], v["value"])
        return c


class ChartTimeline(Chart):
    """chart/ChartTimeline.java: lanes of colored [start, end) entries —
    the Spark training-phase timeline surface
    (spark/stats/StatsUtils.java exportStatsAsHtml renders EventStats
    through exactly this chart)."""

    component_type = "ChartTimeline"

    def __init__(self, title: str, style: Optional[Style] = None, **kw):
        super().__init__(title, style, **kw)
        # lane -> list of (start, end, label, color)
        self.lanes: List[Tuple[str, List[Tuple[float, float, str, str]]]] = []

    def add_lane(self, name: str,
                 entries: Sequence[Tuple[float, float, str, str]]):
        self.lanes.append((str(name),
                           [(float(s), float(e), str(l), str(c))
                            for s, e, l, c in entries]))
        return self

    def render(self) -> str:
        if not self.lanes:
            return self._frame(0, 1, 0, 1, "")
        st = self.style
        all_entries = [e for _n, es in self.lanes for e in es]
        if not all_entries:
            return self._frame(0, 1, 0, 1, "")
        x_lo = min(e[0] for e in all_entries)
        x_hi = max(e[1] for e in all_entries) or 1.0
        it = st.margin_top
        ih = st.height - st.margin_top - st.margin_bottom
        lane_h = ih / len(self.lanes)
        X, _ = self._scales(x_lo, x_hi, 0.0, 1.0)
        body = []
        for i, (name, entries) in enumerate(self.lanes):
            y = it + i * lane_h
            body.append(
                f'<text x="{st.margin_left - 6}" '
                f'y="{y + lane_h / 2 + 3:.1f}" font-size="10" '
                f'text-anchor="end">{_html.escape(name)}</text>')
            for s, e, label, color in entries:
                wdt = max(X(e) - X(s), 0.8)
                body.append(
                    f'<rect x="{X(s):.1f}" y="{y + 3:.1f}" '
                    f'width="{wdt:.1f}" height="{max(lane_h - 6, 2):.1f}" '
                    f'fill="{color}" fill-opacity="0.85">'
                    f'<title>{_html.escape(label)} '
                    f'[{_fmt(s)}, {_fmt(e)}]</title></rect>')
        return self._frame(x_lo, x_hi, 0.0, 1.0, "".join(body), y_ticks=[])

    def _payload(self):
        return {"title": self.title,
                "lanes": [{"name": n,
                           "entries": [{"start": s, "end": e, "label": l,
                                        "color": c}
                                       for s, e, l, c in es]}
                          for n, es in self.lanes]}

    @classmethod
    def _from_payload(cls, d, style):
        c = cls(d["title"], style)
        for lane in d.get("lanes", []):
            c.add_lane(lane["name"],
                       [(e["start"], e["end"], e["label"], e["color"])
                        for e in lane.get("entries", [])])
        return c


_REGISTRY: Dict[str, type] = {
    c.component_type: c
    for c in (ComponentText, ComponentTable, ComponentDiv,
              DecoratorAccordion, ChartLine, ChartScatter, ChartHistogram,
              ChartHorizontalBar, ChartStackedArea, ChartTimeline)
}


# ---------------------------------------------------------------------------
# standalone page rendering (standalone/StaticPageUtil.java)
# ---------------------------------------------------------------------------

_PAGE_STYLE = """
body{font-family:system-ui,sans-serif;margin:18px;color:#222}
h2{color:#1a237e} h3{margin:18px 0 6px;font-size:15px;color:#444}
details{margin:10px 0}
"""


def render_components_to_html(components: Sequence[Component],
                              title: str = "Report") -> str:
    """StaticPageUtil.renderHTML parity: one self-contained page."""
    body = "\n".join(c.render() for c in components)
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{_html.escape(title)}</title>"
            f"<style>{_PAGE_STYLE}</style></head><body>"
            f"<h2>{_html.escape(title)}</h2>{body}</body></html>")


def render_components_to_file(components: Sequence[Component], path: str,
                              title: str = "Report") -> None:
    with open(path, "w") as f:
        f.write(render_components_to_html(components, title))
