"""What a ``--trace 1`` run records: the harness's own host spans, CUDA-event
timings of the calls into the program, the work of each step, and a
``torch.profiler`` trace of the card's activity over a steady part of the
window (the traced window).

The traced window starts and ends at a step boundary with the card
drained, so it holds whole steps only. Two marker kernels
(``torch.cuda._sleep``), launched at known host times, tie the card's
clock to the host's, so that an idle gap on the card can be labelled by
the host span it fell in. Only the card's activity is profiled (no CPU
operator events), which keeps the profiler's cost off the host path.

The profiler keeps only operations that fall between its start and stop
on the host's clock, and the card's timestamps, as it converts them, lie
off that clock by up to a tenth of a second either way (on the H100 with
torch 2.11 and CUDA 12.8). Without room around them, one marker or both
went missing in 22 of 25 back-to-back sessions under load, and in one of
six traced runs of a training cell. So a few small kernels run and the card
idles ``START_MARGIN_S`` between the profiler's start and the first marker,
and the card idles ``STOP_MARGIN_S`` between the last marker and the stop;
a marker that is lost all the same is placed from the other.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
MARKER_CYCLES = 2000
PRIMER_LAUNCHES = 16  # small kernels between the profiler's start and the first marker
START_MARGIN_S = 0.1  # idle seconds before the first marker
STOP_MARGIN_S = 0.5  # and after the last one, before the profiler stops


@dataclass
class TraceData:
    """What a metric reader reads. Times in seconds unless named ``_ms``."""

    kind: str
    config: dict
    workload: dict
    window_s: float = 0.0  # between the markers, on the card's clock as the profiler converts it
    host_window_s: float = 0.0  # the same window on the host's clock
    busy_s: float | None = None
    kernels: list = field(default_factory=list)  # (name, start_s, dur_s) on the card, window-relative
    spans: dict = field(default_factory=lambda: defaultdict(list))  # name -> [seconds]
    timings: dict = field(default_factory=lambda: defaultdict(list))  # name -> [ms], CUDA events
    steps: list = field(default_factory=list)  # the work of each step in the traced window
    counters: dict = field(default_factory=dict)
    breakdown: dict | None = None
    notes: list = field(default_factory=list)  # lines for standard error


class Recorder:
    """Records inside the traced window only; does nothing when disabled."""

    def __init__(self, enabled: bool, device: torch.device, start_at: float, stop_at: float):
        self.enabled = enabled
        self.cuda = device.type == "cuda"
        self.start_at, self.stop_at = start_at, stop_at  # seconds into the measured window
        self.window_start = None
        self.active = False
        self.done = False
        self.lock = threading.Lock()
        self._spans = []  # (name, t0, t1) host perf_counter
        self._timings = []  # (name, start, end): CUDA events, or host seconds
        self.steps = []
        self.counters = {}
        self._prof = None
        self._marks = []  # host perf_counter_ns at each marker launch
        self._host_window = (0.0, 0.0)
        self.on_start = []  # callbacks run as the traced window opens and closes
        self.on_stop = []

    # ------------------------------------------------------------ window
    def begin_window(self) -> float:
        self.window_start = time.perf_counter()
        return self.window_start

    def boundary(self) -> None:
        """Called by a driver between steps: opens or closes the traced window."""
        if not self.enabled or self.done or self.window_start is None:
            return
        elapsed = time.perf_counter() - self.window_start
        with self.lock:
            if not self.active and elapsed >= self.start_at:
                self._start()
            elif self.active and elapsed >= self.stop_at:
                self._stop()

    def finish(self) -> None:
        """Closes the traced window if the measured one ended first."""
        with self.lock:
            if self.active:
                self._stop()

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA])

    def _mark(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            self._marks.append(time.perf_counter_ns())
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()

    def _start(self) -> None:
        for fn in self.on_start:
            fn()
        if self.cuda:
            torch.cuda.synchronize()
            self._prof = self._profiler()
            self._prof.start()
            primer = torch.zeros(1, device=torch.cuda.current_device())
            for _ in range(PRIMER_LAUNCHES):
                primer.add_(1)
            torch.cuda.synchronize()
            time.sleep(START_MARGIN_S)
        self._mark()
        self._host_window = (time.perf_counter(), 0.0)
        self.active = True

    def _stop(self) -> None:
        self.active = False
        self.done = True
        self._mark()
        self._host_window = (self._host_window[0], time.perf_counter())
        if self.cuda:
            time.sleep(STOP_MARGIN_S)
            self._prof.stop()
        for fn in self.on_stop:
            fn()

    # ------------------------------------------------------------ records
    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._spans.append((name, t0, time.perf_counter()))

    def add_span(self, name: str, t0: float, t1: float) -> None:
        if self.active:
            self._spans.append((name, t0, t1))

    @contextlib.contextmanager
    def timed(self, name: str):
        """CUDA events around the body (host seconds on the CPU)."""
        if not self.active:
            yield
            return
        if self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._timings.append((name, start, end))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._timings.append((name, t0, time.perf_counter()))

    def step(self, work: dict) -> None:
        if self.active:
            self.steps.append(work)

    # ------------------------------------------------------------ result
    def data(self, kind: str, config: dict, workload: dict) -> TraceData:
        out = TraceData(kind, config, workload, steps=list(self.steps), counters=dict(self.counters))
        h0, h1 = self._host_window
        out.window_s = out.host_window_s = max(h1 - h0, 0.0)
        for name, t0, t1 in self._spans:
            out.spans[name].append(t1 - t0)
        for name, a, b in self._timings:
            out.timings[name].append(a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
        if self.cuda and self._prof is not None:
            events = device_events(self._prof)
            marks = sorted((s, d) for n, s, d in events if MARKER in n)
            if len(marks) < 2:  # the profiler's second view of the same trace
                other = device_events(self._prof, chrome=True)
                other_marks = sorted((s, d) for n, s, d in other if MARKER in n)
                if len(other_marks) > len(marks):
                    events, marks = other, other_marks
            if len(marks) != 2:
                out.notes.append(f"trace: {len(marks)} of the 2 marker kernels among {len(events)} operations "
                                 "on the card; the other placed by the host's interval")
            marks = place_markers(marks, events, self._marks)
            w0, w1 = marks[0][0] + marks[0][1], marks[-1][0]
            offset = marks[0][0] - self._marks[0]  # card ns minus host ns
            ops = [(n, s, d) for n, s, d in events if MARKER not in n and s + d > w0 and s < w1]
            out.window_s = (w1 - w0) / 1e9
            out.notes.append(f"trace: the traced window {out.window_s:.4f} s on the card's clock, "
                             f"{out.host_window_s:.4f} s on the host's")
            out.kernels = [(n, (s - w0) / 1e9, d / 1e9) for n, s, d in ops]
            busy = merge([(max(s, w0), min(s + d, w1)) for _, s, d in ops])
            out.busy_s = sum(b - a for a, b in busy) / 1e9
            out.breakdown = breakdown(ops, busy, (w0, w1), self._spans, offset)
        return out


def place_markers(marks: list, events: list, host_ns: list) -> list:
    """The two markers' sorted (start_ns, duration_ns) on the card. Where the
    trace lost one of them, it is placed from the other by the host's
    interval between their launches (the card's and the host's agreed
    within half a millisecond over traced windows of about 4 s)."""
    if len(marks) == 1 and len(host_ns) == 2:
        (start, dur), interval = marks[0], host_ns[1] - host_ns[0]
        work = [s for n, s, _ in events if MARKER not in n]
        if sum(s > start for s in work) * 2 >= len(work):  # the work follows it: it is the first
            return [(start, dur), (start + interval, dur)]
        return [(start - interval, dur), (start, dur)]
    if len(marks) != 2:
        raise RuntimeError(f"the trace holds {len(marks)} marker kernels among {len(events)} operations "
                           "on the card, not 2: cannot place the traced window")
    return marks


def device_events(prof, chrome: bool = False) -> list:
    """(name, start_ns, duration_ns) of every operation the card ran
    (kernels, copies, fills) in the profile: from the profiler's results,
    or with ``chrome`` from its exported trace."""
    try:
        if chrome:
            raise AttributeError
        from torch.autograd import DeviceType

        out = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
            out.append((e.name(), int(start), int(dur)))
        if out:
            return out
    except (AttributeError, RuntimeError):
        pass
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    finally:
        os.unlink(path)
    return [(e["name"], int(e["ts"] * 1000), int(e.get("dur", 0) * 1000)) for e in trace.get("traceEvents", [])
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def merge(intervals) -> list:
    """The union of ``intervals`` as sorted disjoint (start, end) pairs."""
    out = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def breakdown(ops, busy, window, spans, offset_ns, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time on the
    card by the harness span the host was in when each gap began."""
    per_op = defaultdict(float)
    for name, _, dur in ops:
        per_op[name] += dur / 1e9
    gaps, at = [], window[0]
    for a, b in busy + [(window[1], window[1])]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    ordered = sorted(spans, key=lambda s: s[1])
    per_label = defaultdict(float)
    for a, b in gaps:
        host = (a - offset_ns) / 1e9
        label = "outside any span"
        for name, t0, t1 in ordered:
            if t0 > host:
                break
            if t1 >= host:
                label = name
        per_label[label] += (b - a) / 1e9
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(per_op), "idle_gaps": rank(per_label)}
