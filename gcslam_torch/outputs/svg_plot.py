"""Line and scatter plots as SVG written from numpy: the run dashboard's
panels (outputs/dashboard.py) and the figures of the tools whose JAX
counterparts draw PNGs with matplotlib (the GPU hosts the port runs on have
no matplotlib). A panel maps data to pixels with one SVG transform, so each
polyline's `points` hold the plotted values themselves, every float written
in full (repr)."""

from __future__ import annotations

import html
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np


COLORS = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b"]
PAD_L, PAD_R, PAD_T, PAD_B = 64, 150, 26, 34
# matplotlib's viridis and coolwarm, sampled at equal steps
VIRIDIS = ["#440154", "#3b528b", "#21918c", "#5ec962", "#fde725"]
COOLWARM = ["#3b4cc0", "#dddddd", "#b40426"]
DOT_R = 2.0  # px


def _fmt(v: float) -> str:
    return f"{v:.4g}"


def frame(title: str, w: int, h: int, x0: float, x1: float, y0: float, y1: float,
          xlabel: str = "", ylabel: str = "") -> List[str]:
    """SVG header, frame, title and the axis range labels of one panel."""
    pw, ph = w - PAD_L - PAD_R, h - PAD_T - PAD_B
    return [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" font-family="sans-serif" font-size="10">',
        f'<rect x="{PAD_L}" y="{PAD_T}" width="{pw}" height="{ph}" fill="none" stroke="#444"/>',
        f'<text x="{PAD_L + pw / 2}" y="16" text-anchor="middle" font-size="12">{html.escape(title)}</text>',
        f'<text x="{PAD_L}" y="{h - 18}" text-anchor="middle">{_fmt(x0)}</text>',
        f'<text x="{PAD_L + pw}" y="{h - 18}" text-anchor="middle">{_fmt(x1)}</text>',
        f'<text x="{PAD_L + pw / 2}" y="{h - 4}" text-anchor="middle">{html.escape(xlabel)}</text>',
        f'<text x="{PAD_L - 4}" y="{PAD_T + ph}" text-anchor="end">{_fmt(y0)}</text>',
        f'<text x="{PAD_L - 4}" y="{PAD_T + 8}" text-anchor="end">{_fmt(y1)}</text>',
        f'<text x="12" y="{PAD_T + ph / 2}" transform="rotate(-90 12 {PAD_T + ph / 2})" '
        f'text-anchor="middle">{html.escape(ylabel)}</text>',
    ]


def _range(vals: Sequence[np.ndarray]) -> Tuple[float, float]:
    finite = [v[np.isfinite(v)] for v in vals]
    finite = [v for v in finite if v.size]
    if not finite:
        return 0.0, 1.0
    lo, hi = min(float(v.min()) for v in finite), max(float(v.max()) for v in finite)
    return (lo - 0.5, hi + 0.5) if hi - lo < 1e-12 else (lo, hi)


class Line(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    label: str = ""
    dashed: bool = False


class Dots(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    colors: Sequence[str]  # one "#rrggbb" per dot


def check_svg_path(path: str) -> None:
    """The port writes its plots as SVG only: any other suffix raises, so the
    format never changes behind the caller's back."""
    if not path.lower().endswith(".svg"):
        raise ValueError(f"{path}: plots are written as SVG; give a path ending in .svg")


def ramp(values, anchors: Sequence[str], vmin=None, vmax=None) -> List[str]:
    """Each value's colour on the piecewise-linear ramp through `anchors`
    over [vmin, vmax] (default: the values' range)."""
    v = np.asarray(values, dtype=np.float64)
    lo = float(v.min()) if vmin is None else vmin
    hi = float(v.max()) if vmax is None else vmax
    s = np.clip((v - lo) / (hi - lo if hi > lo else 1.0), 0.0, 1.0) * (len(anchors) - 1)
    rgb = np.array([[int(a[i:i + 2], 16) for i in (1, 3, 5)] for a in anchors], dtype=np.float64)
    k = np.minimum(s.astype(int), len(anchors) - 2)
    c = rgb[k] + (s - k)[:, None] * (rgb[k + 1] - rgb[k])
    return ["#%02x%02x%02x" % tuple(int(round(x)) for x in row) for row in c]


def panel(title: str, lines: Sequence[Line] = (), dots: Sequence[Dots] = (), w: int = 420, h: int = 380,
          xlabel: str = "", ylabel: str = "", equal_aspect: bool = False, hline=None) -> str:
    """One panel as a standalone <svg>: the lines as polylines in data
    coordinates under the panel's transform, the dots as circles, an
    optional horizontal rule at y = hline, a legend of the labelled lines."""
    def f64(a):
        return np.asarray(a, dtype=np.float64).reshape(-1)

    x0, x1 = _range([f64(s.x) for s in (*lines, *dots)])
    y0, y1 = _range([f64(s.y) for s in (*lines, *dots)])
    pw, ph = w - PAD_L - PAD_R, h - PAD_T - PAD_B
    if equal_aspect:  # one unit is as long on both axes
        scale = min(pw / (x1 - x0), ph / (y1 - y0))
        cx, cy = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
        x0, x1 = cx - 0.5 * pw / scale, cx + 0.5 * pw / scale
        y0, y1 = cy - 0.5 * ph / scale, cy + 0.5 * ph / scale
    sx, sy = pw / (x1 - x0), ph / (y1 - y0)
    tx, ty = PAD_L - x0 * sx, PAD_T + ph + y0 * sy  # pixel = (tx + sx x, ty - sy y)
    out = frame(title, w, h, x0, x1, y0, y1, xlabel, ylabel)
    if hline is not None:
        py = ty - sy * hline
        out.append(f'<line x1="{PAD_L}" y1="{py:.2f}" x2="{PAD_L + pw}" y2="{py:.2f}" stroke="#000" '
                   f'stroke-width="0.5"/>')
    out.append(f'<g transform="matrix({sx!r} 0 0 {-sy!r} {tx!r} {ty!r})">')
    for i, s in enumerate(lines):
        xv, yv = f64(s.x), f64(s.y)
        ok = np.isfinite(xv) & np.isfinite(yv)
        pts = " ".join(f"{float(a)!r},{float(b)!r}" for a, b in zip(xv[ok], yv[ok]))
        dash = ' stroke-dasharray="5,3"' if s.dashed else ""
        out.append(f'<polyline points="{pts}" fill="none" stroke="{COLORS[i % len(COLORS)]}" stroke-width="1.2" '
                   f'vector-effect="non-scaling-stroke"{dash}/>')
    out.append("</g>")
    for d in dots:
        for a, b, col in zip(f64(d.x), f64(d.y), d.colors):
            if np.isfinite(a) and np.isfinite(b):
                out.append(f'<circle cx="{tx + sx * a:.2f}" cy="{ty - sy * b:.2f}" r="{DOT_R}" fill="{col}"/>')
    labelled = [(i, s) for i, s in enumerate(lines) if s.label]
    for j, (i, s) in enumerate(labelled):
        ly = PAD_T + 12 + 14 * j
        dash = ' stroke-dasharray="5,3"' if s.dashed else ""
        out.append(f'<line x1="{w - PAD_R + 8}" y1="{ly - 3}" x2="{w - PAD_R + 24}" y2="{ly - 3}" '
                   f'stroke="{COLORS[i % len(COLORS)]}" stroke-width="2"{dash}/>')
        out.append(f'<text x="{w - PAD_R + 28}" y="{ly}">{html.escape(s.label)}</text>')
    out.append("</svg>")
    return "\n".join(out)


def write_figure(path: str, panels: Sequence[str], w: int = 420, h: int = 380) -> None:
    """The panels side by side in one SVG file (each `w` x `h`)."""
    check_svg_path(path)
    body = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{w * len(panels)}" height="{h}">']
    body += [f'<g transform="translate({i * w},0)">\n{p}\n</g>' for i, p in enumerate(panels)]
    body.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(body) + "\n")
