"""Lightweight metrics/observability registry (SURVEY.md §5).

The reference's only runtime metric is transactions-per-second computed
from the last two block timestamps (reference: src/blockchain/mod.rs:420-440)
plus unstructured env_logger lines.  The library needs more: the hot paths
are asynchronous device work, so the registry records host-side counters,
gauges, and wall-time timers with a structured JSON export — enough to
answer "how many inserts/proofs, at what latency" without dragging in a
metrics server (the export is file/line oriented so any collector can
tail it).

Usage:
    from owshen_tpu_torch.runtime.metrics import metrics
    metrics.inc("pool.deposits", 3)
    with metrics.timer("pool.prove_withdraw"):
        ...
    metrics.dump()          # dict snapshot
    metrics.emit(path)      # one JSON line appended (structured event log)
    with metrics.recording() as rec:
        ...                 # rec.spans: every timed region closed inside

Timers aggregate count/total/min/max; a timed region ending in an
exception still records (latency of failures matters).  Thread-safe.

A timer is also the span of a trace: while `recording()` is on, each timed
region closed keeps a `Span` with its start and end on the epoch clock
(`time.time_ns()`, the clock the profiler's device timeline is read on),
the span it ran inside on its thread, and the root span of that thread's
stack (one request).  Spans time the host only: none waits for the device.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

MAX_SPANS = 1 << 16     # spans one recording keeps; later ones are counted


class Span(NamedTuple):
    """One timed region: epoch ns, its id, its parent's id (None at a root)
    and its root's id (the request)."""
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent: int | None
    request: int


class Recording:
    """The spans closed while `recording()` is on, at most MAX_SPANS of them;
    `dropped` counts the rest."""

    def __init__(self):
        self.spans: list[Span] = []
        self.dropped = 0
        self.limit = MAX_SPANS


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._timers: dict[str, dict] = {}
        self._attached: dict = {}
        self._recording: Recording | None = None
        self._ids = itertools.count(1)
        self._local = threading.local()

    def inc(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = float(value)

    def _add(self, name: str, dt: float, rec: Recording | None = None, span=None):
        with self._lock:
            t = self._timers.setdefault(
                name, {"count": 0, "total_s": 0.0,
                       "min_s": float("inf"), "max_s": 0.0})
            t["count"] += 1
            t["total_s"] += dt
            t["min_s"] = min(t["min_s"], dt)
            t["max_s"] = max(t["max_s"], dt)
            if rec is not None:
                if len(rec.spans) < rec.limit:
                    rec.spans.append(span)
                else:
                    rec.dropped += 1

    @contextmanager
    def timer(self, name: str):
        rec = self._recording
        if rec is None:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._add(name, time.perf_counter() - t0)
            return
        stack = self._local.__dict__.setdefault("stack", [])
        span_id = next(self._ids)
        parent, request = stack[-1] if stack else (None, span_id)
        stack.append((span_id, request))
        start = time.time_ns()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            end = time.time_ns()
            stack.pop()
            self._add(name, dt, rec, Span(name, start, end, span_id, parent, request))

    @contextmanager
    def recording(self):
        """Keep a `Span` of every timed region closed inside the block, on
        every thread; yields the `Recording` that holds them."""
        rec = Recording()
        with self._lock:
            if self._recording is not None:
                raise RuntimeError("a recording is already on")
            self._recording = rec
        try:
            yield rec
        finally:
            with self._lock:
                self._recording = None

    def attach_timer(self, name: str, read):
        """Report a time kept elsewhere as the timer `name` of `dump()`:
        `read()` returns its (count, total seconds); it has no min or max."""
        with self._lock:
            self._attached[name] = read

    def dump(self) -> dict:
        with self._lock:
            timers = {
                k: {**v, "mean_s": v["total_s"] / max(v["count"], 1)}
                for k, v in self._timers.items()
            }
            out = {"counters": dict(self._counters),
                   "gauges": dict(self._gauges), "timers": timers}
            attached = list(self._attached.items())
        for k, read in attached:
            count, total = read()
            timers[k] = {"count": count, "total_s": total, "mean_s": total / max(count, 1)}
        return out

    def emit(self, path: str):
        """Append one structured JSON line (timestamped snapshot)."""
        snap = {"t": time.time(), **self.dump()}
        with open(path, "a") as fh:
            fh.write(json.dumps(snap, default=float) + "\n")

    def reset(self):
        """Clear every counter, gauge and timer (an attached timer is read
        where it is kept)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()


metrics = MetricsRegistry()
