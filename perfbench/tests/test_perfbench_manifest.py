"""BENCHMARK.json against the contract's character rules, and a cell added
from new files alone."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench.manifest import Manifest
from perfbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_use_allowed_characters():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("perfbench/")
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert len(names) == len(set(names))
    assert 1 <= b["run_seconds"] <= 51
    assert all(TEXT.match(w) for w in b["command"])


@pytest.mark.parametrize("kind", ["traffic", "limits", "metrics"])
def test_every_named_part_has_its_file(kind):
    b = _bench()
    m = Manifest(ROOT)
    for w in b["workloads"]:
        if kind == "traffic":
            assert m.traffic(w["traffic"])["start_epoch"] > 0
        elif kind == "limits":
            from perfbench.compare import NAMES
            lim = m.limits(w["name"])
            assert lim and set(lim) <= set(NAMES)
            assert all(0 < v < 1e3 for v in lim.values())
        else:
            for e in b["per_layer"]:
                assert callable(m.reader(e["name"]))


def test_a_cell_added_from_new_files_is_found_by_name(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    (tmp_path / "perfbench" / "traffic" / "as_nolocal.json").write_text(
        json.dumps({"start_epoch": 211, "params": {"local_eval": False}}))
    (tmp_path / "perfbench" / "limits" /
     "cifar10_resnet18.as_nolocal.json").write_text(json.dumps(
         {"limits": {"grad0": 1.0}}))
    b["workloads"].append({"name": "cifar10_resnet18.as_nolocal",
                           "config": "cifar10_resnet18",
                           "traffic": "as_nolocal", "chips": 1,
                           "why": "a cell of new files"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    m = Manifest(tmp_path)
    cell = m.cell("cifar10_resnet18.as_nolocal")
    assert m.config(cell["config"])["params"]["type"] == "cifar"
    assert m.traffic(cell["traffic"])["params"] == {"local_eval": False}
    assert m.limits(cell["name"]) == {"grad0": 1.0}
    listed = {e["name"] for e in m.metrics("end_to_end", cell["name"])}
    assert {"round_s", "setup_s"} <= listed
