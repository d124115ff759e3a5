# Copy of repro/core/telemetry.py; the port imports nothing of repro.
"""Telemetry for the sync stack (paper §3.1: "telemetry for monitoring").

One thread-safe :class:`Telemetry` instance rides a whole run: every sync
phase appends a timestamped :class:`Event` (dataset, target, phase, wall
time), and named counters accumulate the work done — request/byte counts
from the instrumented storage layer, per-subsystem occurrences from the
daemon (checkpoint saves, breaker trips, catalog publishes/errors).  The
daemon, fleet, executor, and benchmarks all report through it, so a
single object answers both "what happened, in order" (the event
timeline) and "how much did it cost" (the counters).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Event:
    ts_ms: int
    dataset: str
    target: str
    phase: str          # plan | full | incremental | skip | error
    detail: str = ""
    elapsed_s: float = 0.0


@dataclass
class Telemetry:
    """Thread-safe: sync units report from executor worker threads."""

    events: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def record(self, dataset: str, target: str, phase: str, detail: str = "",
               elapsed_s: float = 0.0) -> None:
        with self._lock:
            self.events.append(Event(time.time_ns() // 1_000_000, dataset,
                                     target, phase, detail, elapsed_s))

    @contextmanager
    def timed(self, dataset: str, target: str, phase: str, detail: str = ""):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(dataset, target, phase, detail,
                        time.perf_counter() - t0)

    def timeline(self) -> list[str]:
        return [f"[{e.ts_ms}] {e.dataset} -> {e.target}: {e.phase} "
                f"{e.detail} ({e.elapsed_s * 1e3:.2f} ms)" for e in self.events]

    def summary(self) -> dict:
        return dict(self.counters)
