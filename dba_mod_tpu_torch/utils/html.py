"""The run folder's params.html (port of dba_mod_tpu/utils/html.py::dict_html):
the reference's params table (utils/utils.py:8-19), which it posts into the
visdom dashboard header (main.py:122), written into the run folder.
"""
from __future__ import annotations

import html
from typing import Any, Dict


def dict_html(d: Dict[str, Any], current_time: str = "") -> str:
    rows = "".join(
        f"<tr><td>{html.escape(str(k))}</td>"
        f"<td>{html.escape(str(v))}</td></tr>"
        for k, v in sorted(d.items(), key=lambda kv: str(kv[0])))
    return (f"<h4>Run {html.escape(str(current_time))}</h4>"
            f"<table border=1 cellpadding=2>"
            f"<tr><th>param</th><th>value</th></tr>{rows}</table>")
