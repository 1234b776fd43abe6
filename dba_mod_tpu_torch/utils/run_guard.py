"""Process-level crash/preemption tolerance: graceful shutdown + watchdog
(the port's own copy of dba_mod_tpu/utils/run_guard.py).

Preemptible machines deliver SIGTERM with a short grace window, operators
deliver SIGINT, and a wedged runtime delivers nothing at all — three
failure shapes, two tools:

- :class:`GracefulShutdown` — SIGTERM/SIGINT set a stop flag that the
  experiment loop checks at round boundaries; the run has already written
  the last round's verified checkpoint and recorder files, and the CLI
  exits with :data:`EXIT_INTERRUPTED` so wrappers can tell "preempted,
  resume me" from success and from crashes. A second signal forces
  immediate exit (``128 + signum``) for operators who mean it.
- :class:`Watchdog` — a monotonic-deadline timer around the round path's
  host-blocking sync points (the round's device-to-host transfer at
  finalize, the robust screen's finite check, LOAN's poison probe). A
  stall past ``watchdog_soft_s`` logs a loud diagnostic (zone label,
  epoch, elapsed); past ``watchdog_hard_s`` the process is aborted with
  :data:`EXIT_WATCHDOG` — a wedged run dies *checkpointed* (the previous
  round's verified checkpoint is on disk) instead of burning quota.

Both are strict no-ops when disabled (the config defaults): no signal
handlers installed, no threads started, no per-round work beyond one
attribute check. :class:`RunGuard` bundles them behind the config knobs
(``graceful_shutdown``, ``watchdog_soft_s``, ``watchdog_hard_s``).

The JAX package's elastic verdict (peer-health probe, exit code 77 for a
lost peer host) belongs to multi-device runs, ROADMAP A18, and is not here.
"""
from __future__ import annotations

import contextlib
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger("dba_mod_tpu_torch")

# Distinct exit codes so run wrappers can tell the exit shapes apart
# without parsing logs; 75/76 follow the sysexits.h convention of
# "temporary failure — retrying is the fix".
EXIT_INTERRUPTED = 75   # graceful stop after SIGTERM/SIGINT; resume-able
EXIT_WATCHDOG = 76      # watchdog hard abort: a sync point stalled past
                        # watchdog_hard_s; the last committed checkpoint
                        # is the resume point

_NULL_CM = contextlib.nullcontext()


class GracefulShutdown:
    """SIGTERM/SIGINT → stop flag; second signal → immediate exit.

    Handlers are installed only via :meth:`install` (RunGuard's
    ``__enter__``), only when enabled, and only from the main thread
    (Python restricts ``signal.signal`` to it); :meth:`uninstall` restores
    whatever was there before, so sequential experiments in one process
    don't fight over handlers."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self._stop = threading.Event()
        self._prev: Dict[int, Any] = {}
        self._signal_count = 0
        # injectable for tests — the real thing must be os._exit: a second
        # signal means "now", and raising inside a signal handler would
        # unwind into whatever happens to be on the stack
        self._force_exit: Callable[[int], None] = os._exit

    @property
    def stop_requested(self) -> bool:
        return self._stop.is_set()

    def request_stop(self) -> None:
        """Programmatic stop (tests; the same round-boundary drain a
        signal triggers)."""
        self._stop.set()

    def install(self) -> None:
        # fresh run, fresh state: without this a second run() on the same
        # Experiment would stop at once on the stale flag, and its FIRST
        # signal would take the force-exit branch
        self._stop.clear()
        self._signal_count = 0
        if not self.enabled or self._prev:
            return
        if threading.current_thread() is not threading.main_thread():
            logger.warning("graceful_shutdown: not on the main thread — "
                           "signal handlers not installed")
            return
        for sig in self.SIGNALS:
            self._prev[sig] = signal.signal(sig, self._handler)

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _handler(self, signum, frame) -> None:
        self._signal_count += 1
        if self._signal_count >= 2:
            # the operator insists: no checkpoint, no flush, out now
            self._force_exit(128 + int(signum))
            return
        self._stop.set()
        try:
            name = signal.Signals(signum).name
        except ValueError:  # pragma: no cover — unknown signum
            name = str(signum)
        logger.warning(
            "received %s — finishing the current round, then exiting with "
            "code %d; signal again to force immediate exit", name,
            EXIT_INTERRUPTED)


class _Zone:
    __slots__ = ("label", "t0", "soft_at", "hard_at", "soft_fired",
                 "epoch")

    def __init__(self, label: str, t0: float, soft_at: float, hard_at: float,
                 epoch: Optional[int]):
        self.label = label
        self.t0 = t0
        self.soft_at = soft_at
        self.hard_at = hard_at
        self.soft_fired = False
        self.epoch = epoch


class Watchdog:
    """Monotonic-deadline stall detector for host-blocking sync points.

    ``with watchdog.zone("round/finalize"):`` arms a deadline; leaving the
    block disarms it. One daemon thread (started lazily on the first armed
    zone, never when disabled) watches the active zone: at ``soft_s`` it
    logs a stall diagnostic once (the zone label, the epoch the caller set
    in :attr:`epoch`, elapsed seconds); at ``hard_s`` it aborts the process
    via `on_hard` (default: flush logging, ``os._exit(EXIT_WATCHDOG)``).
    Deadlines use ``time.monotonic()`` so wall-clock adjustments can
    neither fire nor suppress the timer."""

    def __init__(self, soft_s: float = 0.0, hard_s: float = 0.0,
                 on_hard: Optional[Callable[[], None]] = None):
        self.soft_s = float(soft_s)
        self.hard_s = float(hard_s)
        self.enabled = self.soft_s > 0 or self.hard_s > 0
        self._on_hard = on_hard or self._default_abort
        self._cv = threading.Condition()
        self._zone: Optional[_Zone] = None
        self._thread: Optional[threading.Thread] = None
        self.soft_stalls = 0
        self.hard_aborts = 0
        self.epoch: Optional[int] = None  # the round in flight, for the log

    @contextlib.contextmanager
    def zone(self, label: str):
        if not self.enabled:
            yield
            return
        self._ensure_thread()
        t0 = time.monotonic()
        z = _Zone(label, t0,
                  t0 + self.soft_s if self.soft_s > 0 else float("inf"),
                  t0 + self.hard_s if self.hard_s > 0 else float("inf"),
                  self.epoch)
        with self._cv:
            self._zone = z
            self._cv.notify()
        try:
            yield
        finally:
            with self._cv:
                self._zone = None
                self._cv.notify()

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dba-watchdog")
        self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cv:
                z = self._zone
                if z is None:
                    self._cv.wait()
                    continue
                now = time.monotonic()
                nxt = min(z.hard_at,
                          z.soft_at if not z.soft_fired else float("inf"))
                if now < nxt:
                    # cap the wait so a re-armed zone is noticed promptly
                    self._cv.wait(min(nxt - now, 1.0))
                    continue
            # a deadline passed. Re-verify the zone is still armed right
            # before acting — the sync point may have completed in the gap,
            # and a recovered process must not be aborted (nor a misleading
            # stall logged)
            elapsed = now - z.t0
            if not z.soft_fired and now >= z.soft_at:
                with self._cv:
                    armed = self._zone is z
                if not armed:
                    continue
                z.soft_fired = True
                self.soft_stalls += 1
                logger.error(
                    "watchdog: %s has stalled for %.1fs (soft limit %.1fs) "
                    "— epoch=%s; hard abort %s", z.label, elapsed,
                    self.soft_s, z.epoch,
                    (f"at {self.hard_s:.1f}s" if self.hard_s > 0
                     else "disabled"))
            if now >= z.hard_at:
                # hold the lock across the abort: a zone exit racing this
                # blocks on the cv until the process dies, so a sync point
                # that completed just before the deadline check can never
                # be killed after the fact
                with self._cv:
                    if self._zone is not z:
                        continue
                    self.hard_aborts += 1
                    logger.critical(
                        "watchdog: %s stalled past the hard limit (%.1fs > "
                        "%.1fs) — epoch=%s; aborting with exit code %d (the "
                        "last committed checkpoint is the resume point)",
                        z.label, elapsed, self.hard_s, z.epoch,
                        EXIT_WATCHDOG)
                    self._on_hard()
                    # an injected on_hard (tests) returns — drop the zone
                    # so the abort doesn't re-fire every poll
                    self._zone = None

    @staticmethod
    def _default_abort() -> None:  # pragma: no cover — kills the process
        # checkpoints are written synchronously at round boundaries, so
        # nothing is in flight to land before the exit
        logging.shutdown()
        os._exit(EXIT_WATCHDOG)


class RunGuard:
    """The experiment-facing bundle: one stop flag + one watchdog, built
    from config. ``with guard:`` installs/uninstalls the signal handlers
    around the run loop; both members are inert when their knobs are off
    (no threads, no handlers, no per-round cost beyond an attribute
    check)."""

    def __init__(self, graceful_shutdown: bool = False,
                 watchdog_soft_s: float = 0.0, watchdog_hard_s: float = 0.0):
        self.shutdown = GracefulShutdown(enabled=graceful_shutdown)
        self.watchdog = Watchdog(soft_s=watchdog_soft_s,
                                 hard_s=watchdog_hard_s)

    @classmethod
    def from_params(cls, params) -> "RunGuard":
        return cls(
            graceful_shutdown=bool(params.get("graceful_shutdown", False)),
            watchdog_soft_s=float(params.get("watchdog_soft_s", 0.0)),
            watchdog_hard_s=float(params.get("watchdog_hard_s", 0.0)))

    @property
    def stop_requested(self) -> bool:
        return self.shutdown.stop_requested

    def watch(self, label: str):
        """Watchdog zone around a host-blocking sync point; the shared
        null context when the watchdog is off."""
        if not self.watchdog.enabled:
            return _NULL_CM
        return self.watchdog.zone(label)

    def __enter__(self) -> "RunGuard":
        self.shutdown.install()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown.uninstall()
