"""The port stands alone and runs where it is told.

- It imports no JAX: every module of dba_mod_tpu_torch (and chip_smoke.py)
  imports, and a tiny CPU round runs, in a subprocess where `jax`, `flax`,
  `optax` and `orbax` cannot be imported; and no port file has an import
  statement naming jax, flax, optax, orbax or the JAX package.
- Its entry points default to the card and never fall back: asking for
  CUDA without one raises (checked with torch.cuda.is_available forced
  False, so the test means the same on a machine with a card)."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.fl.experiment import Experiment
from dba_mod_tpu_torch.main import main
from dba_mod_tpu_torch.utils.device import resolve_device


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "dba_mod_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|flax|optax|orbax|dba_mod_tpu(?!_torch))"
    r"\b", re.M)

_NO_JAX_SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import dba_mod_tpu_torch, chip_smoke
mods = [m.name for m in pkgutil.walk_packages(dba_mod_tpu_torch.__path__,
                                             "dba_mod_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.fl.experiment import Experiment
p = Params.from_yaml("configs/smoke_params.yaml")
p.raw.update(synthetic_train_size=120, synthetic_test_size=32,
             run_dir=sys.argv[1])
r = Experiment(p, save_results=True, device="cpu").run_round(3)
assert 0.0 <= r["global_acc"] <= 100.0, r
assert not any(k.split(".")[0] in ("jax", "flax", "optax", "orbax",
                                   "dba_mod_tpu") for k in sys.modules
               if sys.modules[k] is not None), "JAX-side module imported"
print("ok", len(mods))
"""


def test_port_imports_and_runs_a_round_without_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT,
                          str(tmp_path)], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().startswith("ok")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_file_imports_jax(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, (path, hits)


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    p = Params.from_yaml(REPO / "configs" / "smoke_params.yaml")
    p.raw.update(run_dir=str(tmp_path / "runs"))
    with pytest.raises(RuntimeError, match="cuda"):
        Experiment(p, save_results=False)             # default: the card
    cfg_path = REPO / "configs" / "smoke_params.yaml"
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--params", str(cfg_path), "--no-save"])
    with pytest.raises(RuntimeError, match="cuda"):
        main(["pretrain", "--params", str(cfg_path), "--device", "cuda"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
