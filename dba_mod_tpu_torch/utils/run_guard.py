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
  finalize, the robust screen's finite check, LOAN's poison probe, the
  async-checkpoint wait). A stall past ``watchdog_soft_s`` logs a loud
  diagnostic (zone label, epoch, elapsed, the telemetry span stack
  captured at zone entry); past ``watchdog_hard_s`` the process is
  aborted with
  :data:`EXIT_WATCHDOG` — a wedged run dies *checkpointed* (the previous
  round's verified checkpoint is on disk) instead of burning quota.

Both are strict no-ops when disabled (the config defaults): no signal
handlers installed, no threads started, no per-round work beyond one
attribute check. :class:`RunGuard` bundles them behind the config knobs
(``graceful_shutdown``, ``watchdog_soft_s``, ``watchdog_hard_s``).

In a multi-process run with heartbeats on, the watchdog also asks the
peer-health layer (parallel/distributed.py::PeerHealth) for its verdict: a
hard stall that coincides with stale peer heartbeats exits
:data:`EXIT_PEER_LOST` instead of :data:`EXIT_WATCHDOG`.
"""
from __future__ import annotations

import contextlib
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from dba_mod_tpu_torch.utils import telemetry

logger = logging.getLogger("dba_mod_tpu_torch")

# Distinct exit codes so run wrappers can tell the exit shapes apart
# without parsing logs; 75/76/77 follow the sysexits.h convention of
# "temporary failure — retrying is the fix", and 77 also tells the wrapper
# the retry must SHRINK the world.
EXIT_INTERRUPTED = 75   # graceful stop after SIGTERM/SIGINT; resume-able
EXIT_WATCHDOG = 76      # watchdog hard abort: a sync point stalled past
                        # watchdog_hard_s; the last committed checkpoint
                        # is the resume point
EXIT_PEER_LOST = 77     # a peer process is gone (a stall coincides with
                        # stale heartbeats, or the round-boundary check
                        # found a stale peer): relaunch the SURVIVORS with
                        # WORLD_SIZE shrunk and --resume auto

_NULL_CM = contextlib.nullcontext()


def _flush_checkpoints_bounded(timeout_s: float = 10.0) -> None:
    """Best-effort landing of queued async checkpoint writes before an
    abort exit. Bounded: the abort must never trade a wedged round for a
    wedged flush, so the wait runs on a side thread and is abandoned at the
    deadline; the previous verified snapshot is on disk either way."""
    done = threading.Event()

    def _wait():
        try:
            from dba_mod_tpu_torch import checkpoint as ckpt  # no cycle
            ckpt.wait_for_async_saves()
        except Exception:  # noqa: BLE001 — aborting anyway
            pass
        finally:
            done.set()

    threading.Thread(target=_wait, daemon=True,
                     name="dba-abort-flush").start()
    if not done.wait(timeout_s):
        logger.warning("abort: async checkpoint flush did not finish in "
                       "%.0fs — exiting on the previous verified snapshot",
                       timeout_s)


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
        # NO telemetry.count here: counters take telemetry's non-reentrant
        # lock, and a handler runs on the main thread — a signal landing
        # while that thread holds the lock would deadlock the process. The
        # honored stop is counted at the round boundary (run/interrupted).
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
                 "epoch", "spans")

    def __init__(self, label: str, t0: float, soft_at: float, hard_at: float,
                 epoch: Optional[int], spans: List[str]):
        self.label = label
        self.t0 = t0
        self.soft_at = soft_at
        self.hard_at = hard_at
        self.soft_fired = False
        self.epoch = epoch
        self.spans = spans


class Watchdog:
    """Monotonic-deadline stall detector for host-blocking sync points.

    ``with watchdog.zone("round/finalize"):`` arms a deadline; leaving the
    block disarms it. One daemon thread (started lazily on the first armed
    zone, never when disabled) watches the active zone: at ``soft_s`` it
    logs a stall diagnostic once (the zone label, the epoch the caller set
    in :attr:`epoch`, elapsed seconds, and the telemetry span stack
    captured at zone entry — in the arming thread, since span stacks are
    thread-local); at ``hard_s`` it aborts the process
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
        # elastic verdict hook (PeerHealth.lost_peers): a hard stall that
        # coincides with stale peer heartbeats is a lost peer, and the
        # abort exits EXIT_PEER_LOST instead of EXIT_WATCHDOG
        self.peer_probe: Optional[Callable[[], List[int]]] = None
        # the verdict the hard-abort path logged: _default_abort reuses it,
        # so the logged code, the run/peer_lost counter and the exit code
        # cannot disagree
        self._verdict: Optional["tuple[int, List[int]]"] = None

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
                  self.epoch, telemetry.current().span_stack())
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
                telemetry.count("watchdog/soft_stalls")
                logger.error(
                    "watchdog: %s has stalled for %.1fs (soft limit %.1fs) "
                    "— epoch=%s span stack at entry=%s; hard abort %s",
                    z.label, elapsed, self.soft_s, z.epoch,
                    z.spans or ["-"],
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
                    telemetry.count("watchdog/hard_aborts")
                    code, lost = self._verdict = self.abort_verdict()
                    if lost:
                        telemetry.count("run/peer_lost")
                    logger.critical(
                        "watchdog: %s stalled past the hard limit (%.1fs > "
                        "%.1fs) — epoch=%s span stack at entry=%s; %s"
                        "aborting with exit code %d (the last committed "
                        "checkpoint is the resume point)", z.label, elapsed,
                        self.hard_s, z.epoch, z.spans or ["-"],
                        (f"stall coincides with missed heartbeats from "
                         f"peer(s) {lost} — peer lost, relaunch the "
                         f"survivors shrunk; " if lost else ""),
                        code)
                    self._on_hard()
                    # an injected on_hard (tests) returns — drop the zone
                    # so the abort doesn't re-fire every poll
                    self._zone = None

    def abort_verdict(self) -> "tuple[int, List[int]]":
        """Classify the hard stall: (exit code, lost peer ids). A stall
        with stale peer heartbeats is a peer loss (EXIT_PEER_LOST): the
        survivor is wedged in a collective whose peer vanished, and only a
        shrunk relaunch can make progress; anything else is the generic
        wedged-runtime abort (EXIT_WATCHDOG). A probe failure never masks
        the abort itself."""
        lost: List[int] = []
        if self.peer_probe is not None:
            try:
                lost = list(self.peer_probe())
            except Exception:  # noqa: BLE001 — the verdict is best-effort
                lost = []
        return (EXIT_PEER_LOST if lost else EXIT_WATCHDOG), lost

    def _default_abort(self) -> None:  # pragma: no cover — kills the process
        # reuse the verdict _loop just logged; land queued async checkpoint
        # writes first (bounded), so the newest committed round is
        # resumable
        code, _ = self._verdict or self.abort_verdict()
        _flush_checkpoints_bounded()
        logging.shutdown()
        os._exit(code)


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

    def attach_peer_health(self, peers) -> None:
        """Wire the peer-health layer into the watchdog's verdict: a hard
        stall that coincides with stale heartbeats exits EXIT_PEER_LOST
        (77) instead of EXIT_WATCHDOG (76). `peers` is a PeerHealth
        (parallel/distributed.py), or None to detach."""
        self.watchdog.peer_probe = (peers.lost_peers
                                    if peers is not None else None)

    def __enter__(self) -> "RunGuard":
        self.shutdown.install()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown.uninstall()
