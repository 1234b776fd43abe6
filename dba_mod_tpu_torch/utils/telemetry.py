"""Process-wide telemetry: span tracing, a metrics registry, and CUDA build
and memory instrumentation for the round path (the port's own copy of
dba_mod_tpu/utils/telemetry.py).

- **Spans** — nestable ``with telemetry.span("round/dispatch"):`` blocks
  timed with ``time.perf_counter()``. CUDA launches are asynchronous, so a
  span that measures device work ends at an explicit sync point:
  ``telemetry.sync(payload)`` inside the block, or :func:`instrument`,
  which wraps a callable so every call runs under a synced span. Spans
  export as a Chrome-trace ``trace.json`` (open it in Perfetto or
  ``chrome://tracing``) and feed per-round duration histograms.
- **Metrics registry** — counters (cumulative), gauges (last value) and
  histograms (windowed between flushes). :meth:`Telemetry.flush_round`
  writes one JSON line per round to ``telemetry.jsonl`` and mirrors the
  scalars to the recorder's TensorBoard writer under ``telemetry/...``.
- **CUDA instrumentation** — the port compiles nothing at run time but its
  hand-written kernels: ``utils/cuda_build.load_library`` reports every
  nvcc build to ``cuda/kernel_builds`` (and its seconds to
  ``cuda/kernel_build_secs``). After :meth:`Telemetry.mark_warm` a build
  increments ``cuda/kernel_builds_after_warmup`` and logs a warning — the
  JAX package's ``xla/recompiles_after_warmup``. Device memory gauges come
  from ``torch.cuda.memory_stats()`` (``memory/bytes_in_use``,
  ``memory/peak_bytes_in_use``); on the CPU they are absent.

The module keeps ONE process-wide current instance (:func:`current`),
defaulting to a no-op null object: call sites in the round path pay one
attribute check when telemetry is off, and the knobs (``telemetry``,
``telemetry_dir``) add no files and no per-round work.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("dba_mod_tpu_torch")

# Round-pipelining metric family (fl/experiment.py, fl/async_rounds.py).
# Emitted only when overlap_eval is on and telemetry is on, which forces the
# round loop sequential (per-phase span attribution is only honest when the
# phases do not overlap), so these measure the split program run serially:
#   overlap/rounds               counter   rounds run through the split path
#   overlap/hidden_eval_s        gauge     cumulative eval+fetch seconds that
#                                          ran behind the next dispatch
#   overlap/dispatch_ahead_depth gauge     in-flight rounds ahead (depth 1)
#   overlap/eval_wait_s          histogram per-round blocking fetch tail

_LOCK = threading.Lock()


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted list (q in [0, 1])."""
    if not sorted_vals:
        return 0.0
    i = min(round(q * (len(sorted_vals) - 1)), len(sorted_vals) - 1)
    return sorted_vals[i]


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with _LOCK:
            self.value += int(n)


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Windowed histogram: observations accumulate until the next per-round
    flush snapshots and resets the window; the all-run count and sum ride
    along."""

    __slots__ = ("window", "total_count", "total_sum")

    def __init__(self):
        self.window: List[float] = []
        self.total_count = 0
        self.total_sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with _LOCK:
            self.window.append(v)
            self.total_count += 1
            self.total_sum += v

    def snapshot_and_reset(self) -> Dict[str, float]:
        with _LOCK:
            vals, self.window = self.window, []
        vals.sort()
        return {"count": len(vals), "sum": sum(vals),
                "min": vals[0] if vals else 0.0,
                "max": vals[-1] if vals else 0.0,
                "p50": _percentile(vals, 0.50),
                "p95": _percentile(vals, 0.95)}


class _NullMetric:
    """Shared no-op counter/gauge/histogram of the disabled path."""
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_METRIC = _NullMetric()
_NULL_CM = contextlib.nullcontext()


class _NullTelemetry:
    """The disabled telemetry object: every operation is a no-op, `enabled`
    is the one attribute hot paths check. Shared singleton."""
    enabled = False
    current_epoch: Optional[int] = None

    def span(self, name: str):
        return _NULL_CM

    def sync(self, x: Any) -> Any:
        return x

    def counter(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def phase(self) -> str:
        return "-"

    def span_stack(self) -> List[str]:
        return []

    def set_epoch(self, epoch: Optional[int]) -> None:
        pass

    def mark_warm(self) -> None:
        pass

    def record_memory(self) -> None:
        pass

    def flush_round(self, epoch: int) -> None:
        pass

    def write_trace(self) -> None:
        pass

    def summary_table(self) -> str:
        return "telemetry disabled"

    def close(self) -> None:
        pass


NULL = _NullTelemetry()


def cuda_device_of(x: Any):
    """The device of the first CUDA tensor in a payload tree, or None."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.device if x.is_cuda else None
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            d = cuda_device_of(v)
            if d is not None:
                return d
    return None


class Telemetry:
    """One run's telemetry state. Construct through :func:`configure` so
    call sites throughout the round path resolve it via :func:`current`."""

    enabled = True
    TRACE_WRITE_EVERY = 20  # flushes between periodic trace.json rewrites

    def __init__(self, folder: Optional[Path] = None,
                 tb_sink: Optional[Callable[[str, float, int], None]] = None,
                 device=None, max_trace_events: int = 200_000):
        self.folder = Path(folder) if folder is not None else None
        self.tb_sink = tb_sink
        self.device = device          # memory gauges read this CUDA device
        self.max_trace_events = int(max_trace_events)
        self._origin = time.perf_counter()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._trace_events: List[dict] = []
        self._span_all: Dict[str, List[float]] = {}
        self._local = threading.local()
        self._flush_count = 0
        self._warm = False
        self.current_epoch: Optional[int] = None
        self.peak_memory_bytes = 0
        # present in every row, so a run that built nothing reports 0
        self.counter("cuda/kernel_builds")
        if self.folder is not None:
            self.folder.mkdir(parents=True, exist_ok=True)
            # truncate a stale jsonl from a previous run in the same folder
            (self.folder / "telemetry.jsonl").write_text("")

    # ------------------------------------------------------------- registry
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with _LOCK:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with _LOCK:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with _LOCK:
                h = self._histograms.setdefault(name, Histogram())
        return h

    # ---------------------------------------------------------------- spans
    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str):
        """Nestable timed block. End device-measuring spans at a sync
        point: call :meth:`sync` on the measured payload inside the
        block."""
        stack = self._stack()
        stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            self._record_span(name, t0, dur)

    def sync(self, x: Any) -> Any:
        """The device sync point that makes a span honest: wait for every
        stream of the card the payload lives on (the batteries of an
        overlapped round run on a second stream); a no-op for a CPU
        payload."""
        dev = cuda_device_of(x)
        if dev is not None:
            import torch
            torch.cuda.synchronize(dev)
        return x

    def _record_span(self, name: str, t0: float, dur: float) -> None:
        event = {"name": name, "ph": "X", "cat": "span",
                 "ts": (t0 - self._origin) * 1e6, "dur": dur * 1e6,
                 "pid": os.getpid(), "tid": threading.get_ident()}
        with _LOCK:
            if len(self._trace_events) < self.max_trace_events:
                self._trace_events.append(event)
                dropped = False
            else:
                dropped = True
            self._span_all.setdefault(name, []).append(dur)
        if dropped:
            self.counter("trace/dropped_events").inc()
        self.histogram(f"span/{name}").observe(dur)

    def phase(self) -> str:
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else "-"

    def span_stack(self) -> List[str]:
        """Copy of the calling thread's open-span stack (thread-local: the
        watchdog captures it at zone entry, in the arming thread)."""
        stack = getattr(self._local, "stack", None)
        return list(stack) if stack else []

    def set_epoch(self, epoch: Optional[int]) -> None:
        self.current_epoch = epoch

    # ------------------------------------------------------ instrumentation
    def mark_warm(self) -> None:
        """Declare warm-up over: every kernel library a steady-state round
        needs is built. A build after this is a regression, counted in
        ``cuda/kernel_builds_after_warmup`` and logged. Idempotent."""
        if self._warm:
            return
        self._warm = True
        # materialized, so post-warm-up flushes report an explicit 0
        self.counter("cuda/kernel_builds_after_warmup")
        logger.info("telemetry: warm-up complete after %d CUDA kernel "
                    "builds; further builds are counted",
                    self.counter("cuda/kernel_builds").value)

    def note_kernel_build(self, source: str, seconds: float) -> None:
        self.counter("cuda/kernel_builds").inc()
        self.histogram("cuda/kernel_build_secs").observe(seconds)
        if self._warm:
            self.counter("cuda/kernel_builds_after_warmup").inc()
            logger.warning("telemetry: CUDA kernel library %s built AFTER "
                           "warm-up (%.2fs) — a kernel the steady state "
                           "needs was not built ahead", source, seconds)

    def record_memory(self) -> None:
        """Device memory gauges from ``torch.cuda.memory_stats()`` of the
        run's card; nothing on the CPU."""
        dev = self.device
        if dev is None or getattr(dev, "type", None) != "cuda":
            return
        import torch
        stats = torch.cuda.memory_stats(dev)
        cur = stats.get("allocated_bytes.all.current")
        peak = stats.get("allocated_bytes.all.peak")
        if cur is not None:
            self.gauge("memory/bytes_in_use").set(cur)
        if peak is not None:
            self.gauge("memory/peak_bytes_in_use").set(peak)
            self.peak_memory_bytes = max(self.peak_memory_bytes, int(peak))

    # ----------------------------------------------------------- round flush
    def flush_round(self, epoch: int) -> None:
        """One JSON line per round: cumulative counters, last-value gauges
        and the histogram windows since the previous flush. Mirrored to
        TensorBoard when a sink is wired."""
        self.record_memory()
        with _LOCK:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: g.value for k, g in self._gauges.items()
                      if g.value is not None}
            hist_items = list(self._histograms.items())
        hists = {}
        for k, h in hist_items:
            snap = h.snapshot_and_reset()
            if snap["count"]:
                hists[k] = {m: round(v, 6) for m, v in snap.items()}
        row = {"epoch": int(epoch), "time": time.time(),
               "counters": counters, "gauges": gauges, "histograms": hists}
        if self.folder is not None:
            with open(self.folder / "telemetry.jsonl", "a") as f:
                f.write(json.dumps(row) + "\n")
            # trace.json is one JSON document, so it is rewritten whole: on
            # the first flush and every Kth after; close() writes it last
            self._flush_count += 1
            if self._flush_count % self.TRACE_WRITE_EVERY == 1:
                self.write_trace()
        if self.tb_sink is not None:
            step = int(epoch)
            for k, v in counters.items():
                self.tb_sink(f"telemetry/{k}", float(v), step)
            for k, v in gauges.items():
                self.tb_sink(f"telemetry/{k}", float(v), step)
            for k, snap in hists.items():
                self.tb_sink(f"telemetry/{k}/p50", snap["p50"], step)
                self.tb_sink(f"telemetry/{k}/p95", snap["p95"], step)

    # ----------------------------------------------------------- trace file
    def write_trace(self) -> None:
        """Atomic rewrite of ``trace.json`` (Chrome trace format), so a
        crashed run still leaves a loadable trace."""
        if self.folder is None:
            return
        with _LOCK:
            events = list(self._trace_events)
        meta = [{"name": "process_name", "ph": "M", "pid": os.getpid(),
                 "args": {"name": "dba_mod_tpu_torch"}}]
        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        path = self.folder / "trace.json"
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(doc))
        os.replace(tmp, path)

    # -------------------------------------------------------------- summary
    def summary_table(self) -> str:
        """End-of-run phase summary: p50/p95 per span, kernel builds, peak
        device memory."""
        with _LOCK:
            spans = {k: sorted(v) for k, v in self._span_all.items()}
        lines = [f"{'span':<32} {'count':>6} {'total_s':>9} "
                 f"{'p50_ms':>9} {'p95_ms':>9}"]
        for name in sorted(spans):
            vals = spans[name]
            lines.append(
                f"{name:<32} {len(vals):>6} {sum(vals):>9.3f} "
                f"{_percentile(vals, 0.50) * 1e3:>9.2f} "
                f"{_percentile(vals, 0.95) * 1e3:>9.2f}")
        builds = self.counter("cuda/kernel_builds").value
        late = self.counter("cuda/kernel_builds_after_warmup").value
        mem = (f"{self.peak_memory_bytes / 2**20:.1f} MiB"
               if self.peak_memory_bytes else "n/a")
        lines.append(f"cuda kernel builds: {builds} (after warmup: {late}) "
                     f"| peak device memory: {mem}")
        return "\n".join(lines)

    def close(self) -> None:
        """Final trace flush; safe to call more than once."""
        if self.folder is not None:
            self.write_trace()


# --------------------------------------------------------- process-wide state
_current: Any = NULL


def current() -> Any:
    """The process-wide telemetry instance (the null object when off)."""
    return _current


def configure(enabled: bool, folder: Optional[Path] = None,
              tb_sink: Optional[Callable[[str, float, int], None]] = None,
              device=None) -> Any:
    """Install (or clear) the process-wide telemetry instance. With
    `enabled` False the null object is installed and no file is touched.
    A second Experiment in the same process takes over the module-level
    current, so spans of shared code (checkpoint.py, the eval batteries)
    follow the most recent experiment."""
    global _current
    _current = (Telemetry(folder=folder, tb_sink=tb_sink, device=device)
                if enabled else NULL)
    return _current


def span(name: str):
    return _current.span(name)


def sync(x: Any) -> Any:
    if _current.enabled:
        _current.sync(x)
    return x


def count(name: str, n: int = 1) -> None:
    if _current.enabled:
        _current.counter(name).inc(n)


def observe(name: str, v: float) -> None:
    if _current.enabled:
        _current.histogram(name).observe(v)


def set_gauge(name: str, v: float) -> None:
    if _current.enabled:
        _current.gauge(name).set(v)


def set_epoch(epoch: Optional[int]) -> None:
    _current.set_epoch(epoch)


def kernel_built(source: str, seconds: float) -> None:
    """utils/cuda_build reports each nvcc build here."""
    if _current.enabled:
        _current.note_kernel_build(source, seconds)


def instrument(fn: Callable, name: str, batches: int = 0) -> Callable:
    """Wrap a callable so every call runs under a synced span (honest
    device time under asynchronous launches). A passthrough while
    telemetry is off; `batches` increments ``eval/batches`` per call."""
    def wrapped(*args, **kwargs):
        t = _current
        if not t.enabled:
            return fn(*args, **kwargs)
        with t.span(name):
            out = fn(*args, **kwargs)
            t.sync(out)
        if batches:
            t.counter("eval/batches").inc(batches)
        return out
    wrapped.__wrapped__ = fn
    wrapped.__name__ = getattr(fn, "__name__", name)
    return wrapped


# -------------------------------------------------------------- logging setup
class _PhaseFilter(logging.Filter):
    """Injects epoch/phase context (the current telemetry span) into every
    record so the formatter shows where in the round a line came from."""

    def filter(self, record: logging.LogRecord) -> bool:
        t = _current
        ep = t.current_epoch
        record.phase = (f"e{ep}/{t.phase()}" if ep is not None
                        else t.phase())
        return True


_LOG_FORMAT = "%(asctime)s %(levelname).1s [%(phase)s] %(message)s"


def setup_logging(folder: Optional[Path] = None,
                  level: int = logging.INFO) -> logging.Logger:
    """Idempotent configuration of the ``dba_mod_tpu_torch`` logger: the
    run folder's ``log.txt`` handler (phase-tagged lines) is REPLACED when
    a new folder is configured, so log lines follow the active experiment
    and two experiments in one process never write every line twice. The
    logger keeps propagating to the root, where the CLI's console handler
    (and pytest's capture) sit. With no `folder` the logger is returned
    untouched."""
    lg = logging.getLogger("dba_mod_tpu_torch")
    if folder is None:
        return lg
    if lg.level == logging.NOTSET:
        lg.setLevel(level)
    path = os.path.abspath(str(Path(folder) / "log.txt"))
    existing = [h for h in lg.handlers
                if getattr(h, "_dba_run_file", False)]
    if any(getattr(h, "baseFilename", None) == path for h in existing):
        return lg
    for h in existing:
        lg.removeHandler(h)
        h.close()
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter(_LOG_FORMAT))
    fh.addFilter(_PhaseFilter())
    fh._dba_run_file = True  # type: ignore[attr-defined]
    lg.addHandler(fh)
    return lg
