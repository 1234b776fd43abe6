"""The port's copy of the crash/preemption guard
(dba_mod_tpu_torch/utils/run_guard.py), after the JAX package's
tests/test_run_guard.py: the watchdog's soft/hard/no-op cases, the signal
flag and the forcing second signal, install/restore of the handlers, the
round-boundary stop in Experiment.run with a verified checkpoint, and the
strict no-op with the knobs off. The end-to-end signal and kill behavior
against a real process is in tests/test_torch_resume.py."""
import os
import signal
import threading
import time

import pytest
import torch

from dba_mod_tpu_torch import checkpoint as ckpt
from dba_mod_tpu_torch.config import Params
from dba_mod_tpu_torch.fl.experiment import Experiment
from dba_mod_tpu_torch.utils.run_guard import (EXIT_INTERRUPTED,
                                               EXIT_WATCHDOG,
                                               GracefulShutdown, RunGuard,
                                               Watchdog)

CFG = dict(
    type="mnist", lr=0.1, batch_size=16, epochs=6, no_models=4,
    number_of_total_participants=10, eta=0.8, aggregation_methods="mean",
    internal_epochs=1, is_poison=False, synthetic_data=True,
    synthetic_train_size=600, synthetic_test_size=256, momentum=0.9,
    decay=0.0005, sampling_dirichlet=False, local_eval=False, random_seed=3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test (six test workers share eight cores),
    restored afterwards so other files' tests keep torch's default."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------- watchdog
def test_watchdog_disabled_is_strict_noop():
    wd = Watchdog(soft_s=0.0, hard_s=0.0)
    assert not wd.enabled and wd._thread is None
    with wd.zone("anything"):
        pass
    assert wd._thread is None  # no thread ever started


def test_watchdog_soft_then_hard_fire(caplog):
    fired = []
    wd = Watchdog(soft_s=0.05, hard_s=0.15, on_hard=lambda: fired.append(1))
    wd.epoch = 7
    with caplog.at_level("ERROR", logger="dba_mod_tpu_torch"):
        with wd.zone("round/finalize"):
            deadline = time.monotonic() + 5.0
            while not fired and time.monotonic() < deadline:
                time.sleep(0.01)
    assert wd.soft_stalls == 1 and wd.hard_aborts == 1 and fired
    stall = [r.getMessage() for r in caplog.records
             if "stalled" in r.getMessage()]
    assert stall and "round/finalize" in stall[0] and "epoch=7" in stall[0]
    assert any(str(EXIT_WATCHDOG) in m for m in stall)


def test_watchdog_fast_zone_fires_nothing():
    fired = []
    wd = Watchdog(soft_s=0.5, hard_s=1.0, on_hard=lambda: fired.append(1))
    for _ in range(5):
        with wd.zone("quick"):
            time.sleep(0.01)
    time.sleep(0.1)  # give the thread a chance to mis-fire
    assert wd.soft_stalls == 0 and wd.hard_aborts == 0 and not fired


def test_watchdog_soft_only_never_aborts():
    fired = []
    wd = Watchdog(soft_s=0.05, hard_s=0.0, on_hard=lambda: fired.append(1))
    with wd.zone("slow"):
        time.sleep(0.2)
    assert wd.soft_stalls == 1 and wd.hard_aborts == 0 and not fired


# -------------------------------------------------------- graceful shutdown
def test_shutdown_disabled_installs_no_handlers():
    before = {s: signal.getsignal(s) for s in GracefulShutdown.SIGNALS}
    g = GracefulShutdown(enabled=False)
    g.install()
    assert not g._prev
    for s, h in before.items():
        assert signal.getsignal(s) is h
    g.uninstall()


def test_shutdown_signal_sets_flag_then_second_forces_exit():
    g = GracefulShutdown(enabled=True)
    codes = []
    g._force_exit = codes.append
    g.install()
    try:
        assert not g.stop_requested
        os.kill(os.getpid(), signal.SIGTERM)
        # delivery is synchronous in the main thread on return from kill
        assert g.stop_requested
        assert not codes
        os.kill(os.getpid(), signal.SIGTERM)
        assert codes == [128 + signal.SIGTERM]
    finally:
        g.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not g._handler


def test_shutdown_state_resets_on_reinstall():
    g = GracefulShutdown(enabled=True)
    g._force_exit = lambda code: None
    g.install()
    try:
        g._handler(signal.SIGTERM, None)
        assert g.stop_requested and g._signal_count == 1
    finally:
        g.uninstall()
    g.install()
    try:
        assert not g.stop_requested and g._signal_count == 0
    finally:
        g.uninstall()


def test_runguard_context_installs_and_restores():
    prev = signal.getsignal(signal.SIGTERM)
    guard = RunGuard(graceful_shutdown=True)
    with guard:
        assert signal.getsignal(signal.SIGTERM) == guard.shutdown._handler
        assert signal.getsignal(signal.SIGINT) == guard.shutdown._handler
    assert signal.getsignal(signal.SIGTERM) is prev


def test_runguard_disabled_watch_is_nullcontext():
    guard = RunGuard()  # everything off
    assert not guard.watchdog.enabled and not guard.shutdown.enabled
    with guard.watch("x"):
        pass
    assert guard.watchdog._thread is None
    assert len({0, EXIT_INTERRUPTED, EXIT_WATCHDOG}) == 3
    assert (EXIT_INTERRUPTED, EXIT_WATCHDOG) == (75, 76)


def test_runguard_from_params():
    g = RunGuard.from_params(Params.from_dict(dict(
        CFG, graceful_shutdown=True, watchdog_soft_s=5, watchdog_hard_s=30)))
    assert g.shutdown.enabled and g.watchdog.enabled
    assert (g.watchdog.soft_s, g.watchdog.hard_s) == (5.0, 30.0)


# -------------------------------------------- round-boundary graceful stop
def test_run_stops_at_round_boundary_with_verified_checkpoint(tmp_path,
                                                              monkeypatch):
    """A SIGTERM lands in round 2's save: the run finishes the round,
    checkpoints it (manifest-verified), has saved the recorder, and
    reports interrupted — epochs after the boundary never run."""
    cfg = dict(CFG, save_model=True, graceful_shutdown=True,
               run_dir=str(tmp_path / "runs"))
    e = Experiment(Params.from_dict(cfg), save_results=True, device="cpu")
    orig = Experiment.save_model

    def save_and_signal(self, epoch):
        orig(self, epoch)
        if epoch >= 2:
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(Experiment, "save_model", save_and_signal)
    last = e.run(6)
    assert e.interrupted
    assert last["epoch"] == 2  # the boundary honored the stop before 3
    path = e.folder / "model_last.pt.tar"
    ok, reason = ckpt.verify_checkpoint(path)
    assert ok, reason
    _, saved_epoch, _ = ckpt.load_checkpoint(path, e.global_vars)
    assert saved_epoch == 2
    rows = (e.folder / "round_result.csv").read_text().strip().splitlines()
    assert len(rows) - 1 == 2  # header + 2 rounds
    # the handlers are restored after run()
    assert signal.getsignal(signal.SIGTERM) is not e.guard.shutdown._handler


def test_run_without_guard_has_no_handlers_or_threads():
    before = {s: signal.getsignal(s) for s in GracefulShutdown.SIGNALS}
    threads_before = {t.name for t in threading.enumerate()}
    e = Experiment(Params.from_dict(dict(CFG, epochs=1)), save_results=False,
                   device="cpu")
    e.run(1)
    assert not e.interrupted
    for s, h in before.items():
        assert signal.getsignal(s) is h
    assert "dba-watchdog" not in {t.name for t in threading.enumerate()
                                  } - threads_before


def test_watchdog_zones_cover_a_round(tmp_path, monkeypatch):
    """With the watchdog on, the round's host sync (finalize) runs inside
    an armed zone labelled with the epoch; a fast round fires nothing."""
    zones = []
    real = Watchdog.zone

    def spy(self, label):
        zones.append((label, self.epoch))
        return real(self, label)

    monkeypatch.setattr(Watchdog, "zone", spy)
    e = Experiment(Params.from_dict(dict(
        CFG, watchdog_soft_s=60, watchdog_hard_s=120)), save_results=False,
        device="cpu")
    e.run(1)
    assert ("round/finalize", 1) in zones
    assert e.guard.watchdog.soft_stalls == 0
