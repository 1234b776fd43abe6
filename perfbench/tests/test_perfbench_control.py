"""The control and the planted faults fail the limits. On the card (marked
``cuda``): the plain reference in TF32 in the port's place, at a reduced
size of each cell. On the CPU: the faults' readings."""
from __future__ import annotations

import pytest

from perfbench.control import readings
from perfbench.manifest import Manifest
from perfbench.tests.conftest import ROOT, SMALL

CELLS = list(SMALL)


def _over(nums, limits):
    """The compared numbers over their limits."""
    return [n for n, v in nums.items() if n in limits and not v <= limits[n]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_tf32_control_fails_on_the_card(workload, card, small_cache):
    limits = Manifest(ROOT).limits(workload)
    for r in readings(ROOT, workload, [3, 4, 5], device="cuda",
                      overrides=SMALL[workload], cache=small_cache,
                      faults=("tf32",)):
        assert r["agents_match"]
        assert not _over(r["program"], limits), r["program"]
        assert _over(r["tf32"], limits), r["tf32"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_faults_fail_on_the_cpu(workload, cpu_threads, small_cache):
    limits = Manifest(ROOT).limits(workload)
    faults = ("half_batch", "answer", "unchanged")
    if "server_rule" in limits:
        faults += ("server_unchanged", "half_clients")
    for r in readings(ROOT, workload, [6], device="cpu",
                      overrides=SMALL[workload], cache=small_cache,
                      faults=faults):
        assert r["agents_match"]
        for fault in faults:
            assert _over(r[fault], limits), (fault, r[fault])
