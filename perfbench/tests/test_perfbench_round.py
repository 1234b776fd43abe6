"""One small round on the CPU through the whole run: the port against the
plain reference, and the run's result line."""
from __future__ import annotations

import math

from perfbench.cell import run_cell
from perfbench.manifest import Manifest
from perfbench.tests.conftest import ROOT, SMALL


def test_a_small_round_agrees_with_the_reference(cpu_threads, small_cache):
    w = "cifar10_resnet18.as_local"
    res, lines = run_cell(ROOT, w, 2 ** 40 + 7, 0.1, False, device="cpu",
                          overrides=SMALL[w], cache=small_cache)
    assert res["correct"], lines
    assert set(res["compared"]) == set(Manifest(ROOT).limits(w))
    assert lines[-1].startswith("compared eval_acc")
    m = res["metrics"]
    assert {"round_s", "mfu", "setup_s"} == set(m)
    assert all(math.isfinite(v["value"]) and v["value"] > 0
               for v in m.values())
    assert res["attempted"] >= 1 and res["failed"] == 0
