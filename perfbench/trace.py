"""Reading one traced round: device intervals from torch.profiler, the
program's telemetry spans on the host, and their alignment.

The interval-union arithmetic is a copy of dba_mod_tpu_torch/profile_round.py's
busy-time computation. Events come straight from the profiler's kineto
results (no FunctionEvent tree is built, which is what makes a whole-round
trace slow to read); the trace's clock is the wall clock, and a reading of
both clocks at the window's start aligns the device events with the
program's perf_counter spans; a trace on another clock is an error.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

def _start_s(e) -> float:
    """An event's start in seconds on the trace's clock (kineto events
    give ns in newer torch, us in older)."""
    return (e.start_ns() * 1e-9 if hasattr(e, "start_ns")
            else e.start_us() * 1e-6)


def _dur_s(e) -> float:
    return (e.duration_ns() * 1e-9 if hasattr(e, "duration_ns")
            else e.duration_us() * 1e-6)


class RoundTrace:
    """Device events of the traced round and the host spans around them."""

    def __init__(self):
        self.device: List[Tuple[str, float, float]] = []   # name, start, end (s)
        self.window: Tuple[float, float] = (0.0, 0.0)       # host perf_counter
        self.spans: List[Tuple[str, float, float]] = []     # name, start, end
        self.first_event_s: Optional[float] = None          # after window start

    # ------------------------------------------------------------ collect
    @contextlib.contextmanager
    def record(self, device: torch.device):
        """Profile the block: device activity only on the card, so that the
        profiler adds next to nothing to the host's time and the traced
        window is the program's own."""
        cuda = device.type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CUDA if cuda
                else torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            if cuda:
                torch.cuda.synchronize(device)
            t0, w0 = time.perf_counter(), time.time()
            yield
            if cuda:
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
        self.window = (t0, t1)
        self._read(prof, t0, w0)

    def _read(self, prof, t0: float, w0: float) -> None:
        """Device events, moved from the trace's clock (the wall clock) to
        the host's perf_counter. A trace whose first device event does not
        land inside the window (a second of slack before its start) is on
        another clock: that is an error, not something to move."""
        cuda = torch.autograd.DeviceType.CUDA
        raw = [(e.name(), _start_s(e), _dur_s(e))
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        if not raw:
            return
        off = t0 - w0
        first = min(a for _, a, _ in raw) + off
        self.first_event_s = first - self.window[0]
        if not self.window[0] - 1.0 <= first <= self.window[1]:
            raise RuntimeError(
                f"the profiler's first device event lies "
                f"{self.first_event_s:.3f} s from the traced window's start "
                f"({self.window_s:.3f} s long): its clock is not the wall "
                f"clock")
        self.device = [(n, a + off, a + off + d) for n, a, d in raw]

    def add_spans(self, events: List[dict], origin: float) -> None:
        """The program's telemetry spans (Chrome-trace events, us from the
        telemetry's perf_counter origin) that overlap the traced window."""
        t0, t1 = self.window
        for ev in events:
            a = origin + ev["ts"] * 1e-6
            b = a + ev["dur"] * 1e-6
            if b > t0 and a < t1:
                self.spans.append((ev["name"], a, b))

    # --------------------------------------------------------------- read
    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, clipped to the window."""
        t0, t1 = self.window
        spans = sorted((max(a, t0), min(b, t1)) for _, a, b in self.device
                       if b > t0 and a < t1)
        out: List[List[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_time(self, match: Optional[str] = None) -> Tuple[float, int]:
        """(seconds, count) of kernels whose name contains `match` (all
        kernels when None)."""
        s, n = 0.0, 0
        for name, a, b in self.device:
            if match is None or match in name:
                s += b - a
                n += 1
        return s, n

    def top_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for name, a, b in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The k longest idle gaps of the device inside the window, each
        named by the innermost program span open on the host at its middle
        ("-" when none)."""
        t0, t1 = self.window
        edges = [t0]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(t1)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            open_ = [(s1 - s0, n) for n, s0, s1 in self.spans
                     if s0 <= mid <= s1]
            out.append([min(open_)[1] if open_ else "-", b - a])
        return out
