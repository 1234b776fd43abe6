"""Crash/preemption smoke of the port: a real process, a real signal.

    python -m dba_mod_tpu_torch.crash_smoke [--params configs/crash_smoke_params.yaml]
        [--device cuda|cpu]

Launches ``python -m dba_mod_tpu_torch.main train`` on a config with
``graceful_shutdown: true`` and ``save_model: true``, SIGTERMs it once two
rounds have committed (data rows in round_result.csv), and
expects the graceful-stop exit code 75 and a verified ``model_last``. Then
it relaunches with ``--resume auto`` and holds that the run finished in the
SAME run folder with every round recorded exactly once and a verified final
checkpoint. A ``mode: async`` config works the same way, its rounds being
merge steps. The run folder lives under the config's ``run_dir``, which is
emptied first. Prints one JSON summary line; exits non-zero on a failure.

:func:`interrupted_run` is the launcher the chip smoke test reuses; it
also sends SIGKILL instead (``sig``), once a checkpoint of the asked round
is committed, and then expects the process killed and a verified snapshot
to resume from (model_last, or its ``.prev`` clone when the kill landed
inside a save).
"""
from __future__ import annotations

import argparse
import json
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence

REPO = Path(__file__).resolve().parent.parent


def launch(params: Path, device: str, extra: Sequence[str], log: Path,
           env: Dict[str, str] | None = None) -> subprocess.Popen:
    """Start one ``main train`` process, its output appended to `log`."""
    out = open(log, "ab")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "dba_mod_tpu_torch.main", "train",
             "--params", str(params), "--device", device, *extra],
            cwd=REPO, stdout=out, stderr=subprocess.STDOUT, env=env)
    finally:
        out.close()   # the child holds its own descriptor


def run_dir_of(raw: dict) -> Path:
    """The config's run_dir as the launched runs see it: relative paths
    are taken from the repository root, where they start."""
    run_dir = Path(raw["run_dir"])
    return run_dir if run_dir.is_absolute() else REPO / run_dir


def run_folders(run_dir: Path, run_type: str) -> List[Path]:
    return sorted(p for p in run_dir.glob(f"{run_type}_*") if p.is_dir())


def rounds_recorded(run_dir: Path, run_type: str) -> int:
    """Data rows of the run folder's round_result.csv (0 before the first
    round lands)."""
    rows = 0
    for f in run_dir.glob(f"{run_type}_*/round_result.csv"):
        try:
            rows = max(rows, len(f.read_text().strip().splitlines()) - 1)
        except OSError:
            pass
    return rows


def committed_epoch(run_dir: Path, run_type: str) -> int:
    """The epoch of the run folder's committed (manifest-written)
    model_last; 0 before the first."""
    from dba_mod_tpu_torch import checkpoint as ckpt
    return max((ckpt.manifest_epoch(f / "model_last.pt.tar") or 0
                for f in run_folders(run_dir, run_type)), default=0)


def recorded_epochs(folder: Path) -> List[int]:
    return [json.loads(line)["epoch"] for line in
            (folder / "metrics.jsonl").read_text().splitlines() if line]


def interrupted_run(params: Path, device: str, stop_after: int,
                    extra: Sequence[str] = (), timeout: float = 1800.0,
                    env: Dict[str, str] | None = None,
                    sig: int = signal.SIGTERM) -> dict:
    """SIGTERM a ``train`` run of `params` once `stop_after` rounds have
    recorded, hold exit 75 and a verified model_last, relaunch it with
    ``--resume auto`` and hold one run folder holding every round once
    with a verified final checkpoint. With ``sig=signal.SIGKILL`` the kill
    lands once round `stop_after`'s checkpoint is committed and the first
    process must die by it. `extra` goes to both launches. Returns the run
    folder and the numbers seen on the way."""
    import yaml
    from dba_mod_tpu_torch import checkpoint as ckpt

    raw = yaml.safe_load(Path(params).read_text())
    run_dir, run_type = run_dir_of(raw), str(raw["type"])
    run_dir.mkdir(parents=True, exist_ok=True)
    log = run_dir.parent / f"{run_dir.name}.crash_smoke.log"
    t0 = time.perf_counter()
    proc = launch(params, device, extra, log, env)
    deadline = time.monotonic() + timeout
    if sig == signal.SIGKILL:
        def reached():
            return committed_epoch(run_dir, run_type) >= stop_after
    else:
        def reached():
            return rounds_recorded(run_dir, run_type) >= stop_after
    try:
        while not reached() and proc.poll() is None:
            if time.monotonic() > deadline:
                raise AssertionError(f"no {stop_after} committed rounds in "
                                     f"{timeout:.0f}s")
            time.sleep(0.05)
        if proc.poll() is not None:
            raise AssertionError(
                f"train exited (rc={proc.returncode}) before {stop_after} "
                f"rounds committed and the signal could land; see {log}")
        signalled_at = rounds_recorded(run_dir, run_type)
        proc.send_signal(sig)
        rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    first_s = time.perf_counter() - t0
    want = 75 if sig == signal.SIGTERM else -sig
    if rc != want:
        raise AssertionError(f"signal {int(sig)}: exited {rc}, expected "
                             f"{want}; see {log}")
    (folder,) = run_folders(run_dir, run_type)
    stopped_at = recorded_epochs(folder)
    if sig == signal.SIGTERM:
        ok, why = ckpt.verify_checkpoint(folder / "model_last.pt.tar")
        if not ok:
            raise AssertionError(f"model_last after the stop not verified: "
                                 f"{why}")
        resume_point = folder / "model_last.pt.tar"
    else:
        # a kill can land inside a save: model_last may then fail
        # verification, and the resume falls back to its .prev clone
        resume_point = ckpt.latest_verified_checkpoint(folder,
                                                       quarantine=False)
        if resume_point is None:
            raise AssertionError(f"no verified checkpoint in {folder} "
                                 f"after the kill")
    resumed_from = (resume_point.name, ckpt.manifest_epoch(resume_point))

    t0 = time.perf_counter()
    proc = launch(params, device, [*extra, "--resume", "auto"], log, env)
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    resume_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"resumed run exited {rc}; see {log}")
    folders = run_folders(run_dir, run_type)
    if folders != [folder]:
        raise AssertionError(f"auto-resume must reuse {folder}, found "
                             f"{folders}")
    epochs = recorded_epochs(folder)
    interval = int(raw.get("aggr_epoch_interval", 1))
    if epochs != list(range(epochs[0], epochs[-1] + 1, interval)):
        raise AssertionError(f"rounds not recorded exactly once: {epochs}")
    ok, why = ckpt.verify_checkpoint(folder / "model_last.pt.tar")
    if not ok:
        raise AssertionError(f"final checkpoint not verified: {why}")
    return {"folder": folder, "signalled_after_rounds": signalled_at,
            "stopped_epochs": stopped_at, "epochs": epochs,
            "resumed_from": resumed_from,
            "first_run_s": first_s, "resume_run_s": resume_s}


def main(argv=None) -> int:
    import yaml
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--params", default=str(
        REPO / "configs" / "crash_smoke_params.yaml"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    shutil.rmtree(run_dir_of(yaml.safe_load(Path(args.params).read_text())),
                  ignore_errors=True)
    res = interrupted_run(Path(args.params).absolute(), args.device, 2)
    print(json.dumps(dict(res, folder=str(res["folder"]))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
