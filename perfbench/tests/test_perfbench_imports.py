"""Nothing the benchmark loads is JAX or the JAX package, top-level names
compared whole (the port's own name begins with the JAX package's)."""
from __future__ import annotations

import json
import subprocess
import sys

from perfbench.run import BANNED, banned_modules
from perfbench.tests.conftest import ROOT

PROBE = r"""
import json, sys
import torch
torch.set_num_threads(2)
from pathlib import Path
import perfbench.run, perfbench.cell, perfbench.control, perfbench.compare
import perfbench.counting, perfbench.inputs, perfbench.plan, perfbench.trace
from perfbench.cell import run_cell
from perfbench.tests.conftest import SMALL
w = "cifar10_resnet18.as_local"
run_cell(Path(sys.argv[1]), w, 5, 0.1, True, device="cpu",
         overrides=SMALL[w], cache=Path(sys.argv[2]))
print(json.dumps(sorted({m.split(".")[0] for m in list(sys.modules)})))
"""


def test_the_whole_name_is_compared():
    assert banned_modules(["dba_mod_tpu_torch.fl.rounds", "jaxtyping",
                           "flaxen", "perfbench.run"]) == []
    assert banned_modules(["dba_mod_tpu.fl.rounds", "jax.numpy", "jaxlib",
                           "flax.linen"]) == ["dba_mod_tpu", "flax", "jax",
                                              "jaxlib"]


def test_a_traced_run_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT),
                          str(tmp_path)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "dba_mod_tpu_torch" in names and "perfbench" in names
    assert not names & set(BANNED), sorted(names & set(BANNED))
