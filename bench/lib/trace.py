"""The profiler reader: device operations and the harness's own host spans
over one traced slice of the window.

A traced run profiles a steady slice of its window with
``torch.profiler`` (CUPTI on the card), exports the trace as JSON into a
private temporary directory under ``TMPDIR``, reads it and deletes it.
From the trace it keeps:

- every device operation (kernels, including those a CUDA graph launches,
  memory copies and sets) as (name, start, end) in microseconds;
- the harness's host spans (``record_function("bench:<name>")`` around its
  calls into the program's layers), the same way.

Busy time is the union of the device intervals inside the slice; an idle
gap is named by the innermost harness span open on the host when it began.
Modelled on the program's ``chip_smoke._traced``, which it does not import.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import tempfile
import time
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "bench:"


@dataclass
class TraceData:
    ops: list = field(default_factory=list)     # (name, t0_us, t1_us) device ops
    spans: list = field(default_factory=list)   # (name, t0_us, t1_us) harness spans
    ranges: list = field(default_factory=list)  # (name, t0_us, t1_us) the program's
    # profiler ranges as the device ran them (``gpu_user_annotation``)
    start_us: float = 0.0
    end_us: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def ops_named(self, patterns) -> list:
        """Device ops whose name holds any of ``patterns``."""
        return [o for o in self.ops if any(p in o[0] for p in patterns)]

    @staticmethod
    def seconds(ops) -> float:
        return sum(t1 - t0 for _, t0, t1 in ops) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device ops' intervals, clipped to the slice."""
        iv = sorted((max(t0, self.start_us), min(t1, self.end_us)) for _, t0, t1 in self.ops
                    if t1 > self.start_us and t0 < self.end_us)
        out: list = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_within(self, t0: float, t1: float) -> float:
        """Seconds in [t0, t1] (microseconds) in which a device op ran."""
        iv = sorted((max(a, t0), min(b, t1)) for _, a, b in self.ops if b > t0 and a < t1)
        busy, end = 0.0, t0
        for a, b in iv:
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> list:
        """(t0, t1) of every stretch of the slice with no device op."""
        gaps, t = [], self.start_us
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end_us > t:
            gaps.append((t, self.end_us))
        return gaps

    def host_activity(self, t_us: float) -> str:
        """The innermost harness span open at ``t_us`` ("client loop" when
        only the slice itself is)."""
        best = None
        for name, t0, t1 in self.spans:
            if t0 <= t_us < t1 and name != "slice" and (best is None or t0 >= best[1]):
                best = (name, t0)
        return best[0] if best else "client loop"

    def breakdown(self, n: int = 10) -> dict:
        """The device ops that took the most time, by kernel name, and the
        idle time by what the host was doing, each as [name, seconds]."""
        by_op: dict = {}
        for name, t0, t1 in self.ops:
            k = short_name(name)
            by_op[k] = by_op.get(k, 0.0) + (t1 - t0) / 1e6
        by_host: dict = {}
        for a, b in self.idle_gaps():
            k = self.host_activity(a)
            by_host[k] = by_host.get(k, 0.0) + (b - a) / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters (``void repro::gemm_bf16_kernel<...>(...)`` ->
    ``repro::gemm_bf16_kernel``)."""
    s = re.sub(r"^void\s+", "", name)
    s = re.split(r"[<(]", s, maxsplit=1)[0].strip()
    return s[:80] or name[:80]


def parse(doc: dict) -> TraceData:
    """A chrome trace as ``torch.profiler`` exports it -> :class:`TraceData`;
    the slice is the harness's ``bench:slice`` span."""
    td = TraceData()
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        t0 = float(ev["ts"])
        t1 = t0 + float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            td.ops.append((name, t0, t1))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            td.spans.append((name[len(PREFIX):], t0, t1))
        elif cat == "gpu_user_annotation":
            td.ranges.append((name, t0, t1))
    sl = [s for s in td.spans if s[0] == "slice"]
    if sl:
        td.start_us, td.end_us = sl[0][1], sl[0][2]
    elif td.ops:
        td.start_us, td.end_us = min(o[1] for o in td.ops), max(o[2] for o in td.ops)
    return td


class Tracer:
    """Profiles one slice: :meth:`start` at a step boundary, :meth:`stop` at
    a later one.  While active, :func:`span` wrappers record host spans."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.done = False
        self.data: TraceData | None = None
        self.t_start = self.t_stop = None  # host seconds of the slice
        self._prof = None
        self._slice = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        return profile(activities=acts)

    def warm(self):
        """Start and stop the profiler once, in set-up: its first start
        initialises the tracing library (seconds), which the slice must not
        pay inside the window."""
        if not self.enabled:
            return
        prof = self._profile()
        prof.start()
        torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
        prof.stop()

    def start(self):
        self._prof = self._profile()
        self._prof.start()
        self._slice = torch.profiler.record_function(PREFIX + "slice")
        self._slice.__enter__()
        self.active = True
        self.t_start = time.time()

    def stop(self):
        """End the slice; the trace is read later (:meth:`collect`), outside
        the window."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._slice.__exit__(None, None, None)
        self._prof.stop()  # the profiler's own processing: part of the slice
        self.t_stop = time.time()
        self.active = False
        self.done = True

    def collect(self) -> TraceData | None:
        """Export the stopped slice's trace into a private temporary
        directory, read it and delete it."""
        if self._prof is None:
            return self.data
        tmp = tempfile.mkdtemp(prefix="bench-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.data = parse(json.load(f))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            self._prof = None
        return self.data

    @property
    def slice_s(self) -> float:
        """Host seconds the slice lasted (0 without one)."""
        return (self.t_stop - self.t_start) if self.done else 0.0

    def wrap(self, name: str, fn):
        """``fn`` with a host span ``bench:<name>`` around each call made
        while the slice is traced."""
        rf = torch.profiler.record_function
        tag = PREFIX + name

        def traced(*a, **k):
            if not self.active:
                return fn(*a, **k)
            with rf(tag):
                return fn(*a, **k)
        return traced

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            yield
