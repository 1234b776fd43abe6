"""Full-state resume of the port: a killed or stopped run, resumed with
``resumed_model: auto``, continues the uninterrupted trajectory bitwise
(after the JAX package's tests/test_full_state_resume.py and
tests/test_crash_harness.py::test_kill9_then_auto_resume_bit_identical_
trajectory).

The run is an MNIST FoolsGold experiment at the synthetic size of
configs/crash_smoke_params.yaml with the stale fault lane (whose replay
source rides the sidecar), DP noise, forensics and the health sentinel on.
Against its uninterrupted twin: the global weights, the FoolsGold memory,
the FoolsGold weight vectors (weight_result.csv), every recorded row
(clock columns aside) and the forensic rows are bitwise equal.

- a graceful stop after round 2 (the SIGTERM handler, in process), then
  ``--resume auto`` to round 4;
- ``kill -9`` of a ``main train`` process once 2 rounds committed, then
  an auto-resume to round 6 (six rounds leave the kill room to land);
- a sidecar from another participant set raises; a pretrain snapshot
  without a sidecar resumes model-only;
- ``python -m dba_mod_tpu_torch.crash_smoke --device cpu``: SIGTERM, exit
  75, relaunch, every round once in one folder."""
import json
from concurrent.futures import ThreadPoolExecutor
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import yaml

from dba_mod_tpu_torch import checkpoint as ckpt
from dba_mod_tpu_torch import crash_smoke
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.fl.experiment import Experiment

REPO = Path(__file__).resolve().parent.parent
SMALL = yaml.safe_load(open(REPO / "configs" / "crash_smoke_params.yaml"))
CFG = dict(SMALL, aggregation_methods="foolsgold", local_eval=False,
           save_on_epochs=[], keep_last_n=0, watchdog_soft_s=0,
           watchdog_hard_s=0, random_seed=7, fault_injection=True,
           fault_stale_prob=0.3, fault_seed=2, diff_privacy=True,
           sigma=0.001, forensics=True, model_health_check=True,
           health_norm_band=50.0, health_warmup_merges=1)
VOLATILE = {"time", "round_time", "dispatch_time", "finalize_time"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _exp(cfg, **kw):
    return Experiment(Params.from_dict(dict(cfg, **kw)), save_results=True,
                      device="cpu")


def _outputs(folder: Path) -> dict:
    """Everything a run records, clock columns aside."""
    out = {"metrics": [{k: v for k, v in json.loads(line).items()
                        if k not in VOLATILE} for line in
                       (folder / "metrics.jsonl").read_text().splitlines()]}
    rr = (folder / "round_result.csv").read_text().splitlines()
    out["round_result"] = [line.split(",")[:8] for line in rr]
    for name in ("weight_result.csv", "train_result.csv", "test_result.csv",
                 "forensics.jsonl", "client_forensics.csv"):
        out[name] = (folder / name).read_bytes()
    return out


def _assert_same_run(ref: Experiment, folder: Path, got: Experiment):
    for tree in ("params", "batch_stats"):
        a, b = getattr(ref.global_vars, tree), getattr(got.global_vars, tree)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(ref.fg_state.memory, got.fg_state.memory)
    assert got._sentinel.state() == ref._sentinel.state()
    want, have = _outputs(ref.folder), _outputs(folder)
    assert sorted(want) == sorted(have)
    for k in want:
        assert want[k] == have[k], k
    ok, why = ckpt.verify_checkpoint(folder / "model_last.pt.tar")
    assert ok, why


def test_graceful_stop_then_auto_resume_is_bitwise(tmp_path, monkeypatch):
    ref = _exp(CFG, run_dir=str(tmp_path / "ref"))
    ref.run(4)
    a = _exp(CFG, run_dir=str(tmp_path / "run"), graceful_shutdown=True)
    orig = Experiment.save_model

    def save_then_sigterm(self, epoch):
        orig(self, epoch)
        if epoch == 2:
            self.guard.shutdown._handler(signal.SIGTERM, None)

    monkeypatch.setattr(Experiment, "save_model", save_then_sigterm)
    last = a.run(4)
    assert a.interrupted and last["epoch"] == 2
    monkeypatch.setattr(Experiment, "save_model", orig)
    folder = a.folder
    del a
    b = _exp(CFG, run_dir=str(tmp_path / "run"), resumed_model="auto")
    assert b.folder == folder and b.start_epoch == 3
    assert b._resume_aux is not None and "prev_deltas" in b._resume_aux
    b.run(4)
    _assert_same_run(ref, folder, b)


def test_kill9_then_auto_resume_is_bitwise(tmp_path):
    """The uninterrupted run goes on a worker thread beside the killed
    process (each run is its own Experiment; the results are those of
    running them one after the other)."""
    ref = _exp(CFG, run_dir=str(tmp_path / "ref"))
    pool = ThreadPoolExecutor(max_workers=1)
    ref_done = pool.submit(ref.run, 6)
    cfg_path = tmp_path / "crash.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(CFG, epochs=6,
                                            run_dir=str(tmp_path / "run"))))
    run_dir = tmp_path / "run"
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = crash_smoke.launch(cfg_path, "cpu", [], tmp_path / "crash.log",
                              env)
    try:
        deadline = time.monotonic() + 120
        while (crash_smoke.rounds_recorded(run_dir, "mnist") < 2
               and proc.poll() is None and time.monotonic() < deadline):
            time.sleep(0.02)
        assert proc.poll() is None, (tmp_path / "crash.log").read_text()
        proc.kill()             # SIGKILL: no handlers, no cleanup
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGKILL
    (folder,) = crash_smoke.run_folders(run_dir, "mnist")
    b = _exp(CFG, run_dir=str(run_dir), resumed_model="auto")
    assert b.folder == folder
    assert 2 <= b.start_epoch <= 6, b.start_epoch
    b.run(6)
    assert crash_smoke.recorded_epochs(folder) == [1, 2, 3, 4, 5, 6]
    ref_done.result()
    pool.shutdown()
    _assert_same_run(ref, folder, b)


def test_sidecar_shape_mismatch_is_loud(tmp_path):
    e = _exp(CFG, run_dir=str(tmp_path / "runs"))
    e.run(1)
    bad = dict(CFG, number_of_total_participants=6,
               checkpoint_dir=str(e.folder), resumed_model=True,
               resumed_model_name="model_last.pt.tar")
    with pytest.raises(ValueError, match="FoolsGold memory shape"):
        Experiment(Params.from_dict(bad), save_results=False, device="cpu")


def test_model_only_resume_of_a_pretrain_snapshot(tmp_path):
    e = Experiment(Params.from_dict(dict(CFG, save_model=False)),
                   save_results=False, device="cpu")
    e.run_round(1)
    path = tmp_path / "model.pt.tar"
    ckpt.save_checkpoint(path, e.global_vars, 1, float(e.params["lr"]))
    assert ckpt.load_aux_state(path) is None
    r = Experiment(Params.from_dict(dict(
        CFG, save_model=False, checkpoint_dir=str(tmp_path),
        resumed_model=True, resumed_model_name="model.pt.tar")),
        save_results=False, device="cpu")
    assert r.start_epoch == 2 and r._resume_aux is None
    assert float(r.fg_state.memory.abs().max()) == 0
    r.run_round(2)


def test_crash_smoke_cli_on_cpu(tmp_path):
    cfg_path = tmp_path / "crash_smoke.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(
        SMALL, epochs=6, run_dir=str(tmp_path / "cs"))))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "dba_mod_tpu_torch.crash_smoke", "--params",
         str(cfg_path), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["epochs"] == [1, 2, 3, 4, 5, 6]
    assert res["signalled_after_rounds"] >= 2
    assert res["stopped_epochs"][-1] < 6
