"""Finding a cell's parts by the names in BENCHMARK.json.

- configuration: the ``file`` of its entry under ``configs``;
- traffic mix:   ``perfbench/traffic/<traffic>.json``;
- per-layer metric: ``perfbench/metrics/<name>.py``, a module with
  ``read(ctx) -> float | None``;
- the limits of the numbers that decide ``correct``:
  ``perfbench/limits/<workload>.json``;
- peaks of the card: ``perfbench/peaks.json``.

A cell added with its own files and a new ``workloads`` entry needs no
edit of anything here.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / "perfbench"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, workload: str) -> Dict[str, Any]:
        for w in self.data["workloads"]:
            if w["name"] == workload:
                return w
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict[str, Any]:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> Dict[str, float]:
        return json.loads((self.dir / "limits" / f"{workload}.json"
                           ).read_text())["limits"]

    def metrics(self, kind: str, workload: str) -> List[Dict[str, Any]]:
        """The `end_to_end` or `per_layer` metrics this cell reports."""
        return [m for m in self.data[kind]
                if workload in m.get("workloads", [workload])]

    def peaks(self) -> Dict[str, Any]:
        return json.loads((self.dir / "peaks.json").read_text())

    def reader(self, name: str):
        """The `read` function of perfbench/metrics/<name>.py."""
        return _load_reader(self.dir / "metrics" / f"{name}.py", name)


def _load_reader(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
