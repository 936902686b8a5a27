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
    with metrics.timer("groth16.prove"):
        ...
    metrics.dump()          # dict snapshot
    metrics.emit(path)      # one JSON line appended (structured event log)

Timers aggregate count/total/min/max; a timed region ending in an
exception still records (latency of failures matters).  Thread-safe.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._timers: dict[str, dict] = {}

    def inc(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = float(value)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                t = self._timers.setdefault(
                    name, {"count": 0, "total_s": 0.0,
                           "min_s": float("inf"), "max_s": 0.0})
                t["count"] += 1
                t["total_s"] += dt
                t["min_s"] = min(t["min_s"], dt)
                t["max_s"] = max(t["max_s"], dt)

    def dump(self) -> dict:
        with self._lock:
            timers = {
                k: {**v, "mean_s": v["total_s"] / max(v["count"], 1)}
                for k, v in self._timers.items()
            }
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges), "timers": timers}

    def emit(self, path: str):
        """Append one structured JSON line (timestamped snapshot)."""
        snap = {"t": time.time(), **self.dump()}
        with open(path, "a") as fh:
            fh.write(json.dumps(snap, default=float) + "\n")

    def reset(self):
        """Clear every counter, gauge and timer."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()


metrics = MetricsRegistry()
