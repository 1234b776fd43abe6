"""Standalone-HTML building blocks for run artifacts (the port's own copy of
dba_mod_tpu/utils/html.py).

`dict_html` is the reference's params table (utils/utils.py:8-19) — the
reference posts it into the visdom dashboard header (main.py:122); here it
is written into the run folder as `params.html` so a run's exact
configuration is one click away without a plot server. The rest
(`html_doc`, `table_html`, `svg_timeline`) are the shared pieces of the
forensics round-audit report (utils/forensics.py): pure string builders,
no external assets, so every emitted document is self-contained.
"""
from __future__ import annotations

import html
import math
from typing import Any, Dict, List, Sequence


def dict_html(d: Dict[str, Any], current_time: str = "") -> str:
    rows = "".join(
        f"<tr><td>{html.escape(str(k))}</td>"
        f"<td>{html.escape(str(v))}</td></tr>"
        for k, v in sorted(d.items(), key=lambda kv: str(kv[0])))
    return (f"<h4>Run {html.escape(str(current_time))}</h4>"
            f"<table border=1 cellpadding=2>"
            f"<tr><th>param</th><th>value</th></tr>{rows}</table>")


_DOC_CSS = """
body { font-family: system-ui, sans-serif; margin: 24px; color: #1a1a1a; }
h1 { font-size: 1.4em; } h2 { font-size: 1.1em; margin-top: 1.6em; }
table { border-collapse: collapse; margin: 8px 0; font-size: 0.85em; }
th, td { border: 1px solid #bbb; padding: 3px 8px; text-align: left; }
th { background: #f0f0f0; }
tr.flagged td { background: #fde8e8; }
figure { margin: 8px 0; }
figcaption { font-size: 0.8em; color: #555; }
.note { font-size: 0.85em; color: #555; }
"""


def html_doc(title: str, body: str) -> str:
    """Wrap a body fragment into a complete self-contained document."""
    return ("<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title>"
            f"<style>{_DOC_CSS}</style></head>"
            f"<body><h1>{html.escape(title)}</h1>{body}</body></html>")


def table_html(header: Sequence[str], rows: Sequence[Sequence[Any]],
               flagged: Sequence[bool] = ()) -> str:
    """Rows are escaped; `flagged[i]` highlights row i (quarantine rows)."""
    head = "".join(f"<th>{html.escape(str(h))}</th>" for h in header)
    body = []
    for i, row in enumerate(rows):
        cls = " class='flagged'" if (i < len(flagged) and flagged[i]) else ""
        cells = "".join(f"<td>{html.escape(str(c))}</td>" for c in row)
        body.append(f"<tr{cls}>{cells}</tr>")
    return f"<table><tr>{head}</tr>{''.join(body)}</table>"


def svg_timeline(series: List[Dict[str, Any]], title: str = "",
                 width: int = 720, height: int = 200) -> str:
    """Inline-SVG line chart. `series` is a list of
    {"label": str, "color": str, "points": [(x, y), ...], "dash": bool?};
    non-finite points are dropped per-series (a NaN-corrupted round must
    not blank the whole timeline). Returns an empty string when no series
    has any finite point."""
    clean = []
    for s in series:
        pts = [(float(x), float(y)) for x, y in s.get("points", ())
               if math.isfinite(float(x)) and math.isfinite(float(y))]
        if pts:
            clean.append({**s, "points": sorted(pts)})
    if not clean:
        return ""
    xs = [p[0] for s in clean for p in s["points"]]
    ys = [p[1] for s in clean for p in s["points"]]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if x1 - x0 < 1e-12:
        x1 = x0 + 1.0
    if y1 - y0 < 1e-12:
        y1 = y0 + (abs(y0) or 1.0) * 0.1
    ml, mr, mt, mb = 58, 12, 26, 30   # margins: left/right/top/bottom
    pw, ph = width - ml - mr, height - mt - mb

    def sx(x):
        return ml + (x - x0) / (x1 - x0) * pw

    def sy(y):
        return mt + ph - (y - y0) / (y1 - y0) * ph

    parts = [f"<svg width='{width}' height='{height}' "
             f"viewBox='0 0 {width} {height}' "
             "xmlns='http://www.w3.org/2000/svg'>",
             f"<rect x='{ml}' y='{mt}' width='{pw}' height='{ph}' "
             "fill='#fafafa' stroke='#ccc'/>"]
    if title:
        parts.append(f"<text x='{ml}' y='16' font-size='12' "
                     f"font-weight='bold'>{html.escape(title)}</text>")
    for frac in (0.0, 0.5, 1.0):  # y gridline + label at min/mid/max
        yv = y0 + frac * (y1 - y0)
        py = sy(yv)
        parts.append(f"<line x1='{ml}' y1='{py:.1f}' x2='{ml + pw}' "
                     f"y2='{py:.1f}' stroke='#ddd'/>")
        parts.append(f"<text x='{ml - 4}' y='{py + 4:.1f}' font-size='10' "
                     f"text-anchor='end'>{yv:.4g}</text>")
    for xv in (x0, x1):           # x labels at the range ends (epochs)
        parts.append(f"<text x='{sx(xv):.1f}' y='{mt + ph + 14}' "
                     f"font-size='10' text-anchor='middle'>"
                     f"{xv:.4g}</text>")
    lx = ml + 6
    for i, s in enumerate(clean):
        color = s.get("color", "#1f77b4")
        dash = " stroke-dasharray='5,3'" if s.get("dash") else ""
        path = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in s["points"])
        parts.append(f"<polyline points='{path}' fill='none' "
                     f"stroke='{color}' stroke-width='1.5'{dash}/>")
        for x, y in s["points"]:
            parts.append(f"<circle cx='{sx(x):.1f}' cy='{sy(y):.1f}' "
                         f"r='2' fill='{color}'/>")
        ly = mt + 12 + 13 * i
        parts.append(f"<line x1='{lx}' y1='{ly - 3}' x2='{lx + 16}' "
                     f"y2='{ly - 3}' stroke='{color}' "
                     f"stroke-width='2'{dash}/>")
        parts.append(f"<text x='{lx + 20}' y='{ly}' font-size='10'>"
                     f"{html.escape(str(s.get('label', '')))}</text>")
    parts.append("</svg>")
    return "".join(parts)
