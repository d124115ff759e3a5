# Copy of repro/core/executor.py; the port imports nothing of repro.
"""Concurrent sync execution (stage 3 of plan -> execute).

Runs the independent :class:`~repro_torch.core.plan.SyncUnit`s of a plan on a
thread pool: the targets of one dataset translate in parallel (they write
disjoint metadata directories — ``_delta_log/`` / ``metadata/`` /
``.hoodie/`` — and each target commit is atomic via the filesystem's
put-if-absent), and so do unrelated datasets.  Source metadata is served
from the shared :class:`~repro_torch.core.metadata_cache.MetadataCache`, so
concurrency adds no extra log replays.

Failures are isolated per unit: one target blowing up yields an ERROR
result for that cell and leaves every other cell untouched (recovery is
"run it again", as in the seed design).  Results are returned in plan
order regardless of completion order, so callers see a deterministic
result list.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass

from repro_torch.core.ir import fold_changes
from repro_torch.core.metadata_cache import MetadataCache
from repro_torch.core.plan import (ERROR, FULL, INCREMENTAL, SKIP, SyncPlan,
                             SyncUnit)
from repro_torch.core.sources import make_source
from repro_torch.core.targets import make_target
from repro_torch.core.telemetry import Telemetry
from repro_torch.lst.storage.base import latency_bound

DEFAULT_MAX_WORKERS = 8


@dataclass
class SyncResult:
    dataset: str
    target_format: str
    mode: str                  # FULL | INCREMENTAL | SKIP | ERROR
    commits_synced: int = 0    # SOURCE commits this run advanced the target by
    source_commit: str | None = None   # last source commit applied
    elapsed_s: float = 0.0
    error: str | None = None
    target_commits: int = 0    # target commits written (< commits_synced when
                               # the backlog was coalesced)
    storage_ops: dict | None = None  # per-unit storage request census (only
                                     # when the run's fs is instrumented)

    @property
    def ok(self) -> bool:
        return self.error is None


class SyncExecutor:
    """Executes a SyncPlan; ``max_workers=1`` degrades to the serial loop."""

    def __init__(self, fs, cache: MetadataCache | None = None,
                 telemetry: Telemetry | None = None,
                 max_workers: int | None = None, *,
                 manifest_compaction_threshold: int | None = None):
        self.fs = fs
        self.cache = cache or MetadataCache(fs)
        self.telemetry = telemetry or Telemetry()
        self.max_workers = max_workers
        # threaded into fallback-constructed targets so a unit whose writer
        # is missing from plan.writers behaves like a planner-built one
        self.manifest_compaction_threshold = manifest_compaction_threshold
        self._writers: dict = {}

    # ------------------------------------------------------------------ api
    def execute(self, plan: SyncPlan) -> list:
        units = plan.units
        # reuse the planner's target writers (cached target-side state);
        # each (path, format) pair belongs to exactly one unit, so worker
        # threads never share a writer
        self._writers = dict(plan.writers)
        if not units:
            return []
        workers = self.max_workers or self._auto_workers(len(units))
        if workers <= 1 or len(units) == 1:
            return [self.execute_unit(u) for u in units]
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="xtable-sync") as pool:
            return list(pool.map(self.execute_unit, units))

    def prepare(self, writers: dict) -> None:
        """Install the planner's target writers for direct
        ``execute_unit`` calls — the fleet path drives units through its
        own shard queues instead of ``execute()``."""
        self._writers = dict(writers)

    def _auto_workers(self, n_units: int) -> int:
        """Pool width when the caller didn't pin one.

        Against a latency-bound store every unit spends its time waiting
        on round trips, so a wide pool overlaps them — the win the paper's
        "negligible overhead" claim rests on.  Against zero-RTT storage
        the units are pure CPU-bound metadata translation holding the GIL;
        threads beyond the hardware's parallelism only convoy on it (the
        measured sub-1x "concurrent" bootstrap regression), so the width
        is capped at the core count.
        """
        workers = min(DEFAULT_MAX_WORKERS, n_units)
        if not latency_bound(self.fs):
            workers = min(workers, max(1, os.cpu_count() or 1))
        return workers

    def execute_unit(self, unit: SyncUnit) -> SyncResult:
        t0 = time.perf_counter()
        # an instrumented fs tracks per-thread request counters, and a unit
        # runs entirely on this thread — scope them to get the unit's exact
        # storage census (the O(1)-target-reads guarantee is pinned on it)
        scoped = getattr(self.fs, "scoped", None)
        scope_cm = scoped() if scoped is not None else nullcontext()
        try:
            with scope_cm as scope:
                r = self._run_unit(unit)
        except Exception as e:  # a failing target must not poison others
            self.telemetry.bump("sync.errors")
            self.telemetry.record(unit.dataset, unit.target_format,
                                  "error", str(e))
            r = SyncResult(unit.dataset, unit.target_format, ERROR,
                           source_commit=unit.source_head, error=str(e))
        else:
            if scope is not None:
                r.storage_ops = scope.as_dict()
        r.elapsed_s = time.perf_counter() - t0
        return r

    # ------------------------------------------------------------- internals
    def _run_unit(self, unit: SyncUnit) -> SyncResult:
        if unit.mode == SKIP:
            self.telemetry.bump("sync.skipped")
            self.telemetry.record(unit.dataset, unit.target_format, "skip",
                                  unit.reason)
            return SyncResult(unit.dataset, unit.target_format, SKIP,
                              source_commit=unit.source_head)

        if unit.mode == ERROR:  # planning already failed this cell
            self.telemetry.bump("sync.errors")
            self.telemetry.record(unit.dataset, unit.target_format, "error",
                                  unit.reason)
            return SyncResult(unit.dataset, unit.target_format, ERROR,
                              source_commit=unit.source_head,
                              error=unit.reason or "planning failed")

        source = make_source(unit.source_format, self.fs, unit.base_path,
                             self.cache.index(unit.source_format,
                                              unit.base_path))
        target = self._writers.get((unit.base_path, unit.target_format)) \
            or make_target(unit.target_format, self.fs, unit.base_path,
                           manifest_compaction_threshold=self
                           .manifest_compaction_threshold)

        # transactional drain: the target's metadata is parsed once at the
        # first commit and threaded through the rest in memory, so an
        # N-commit unit costs O(N) writes and O(1) reads in table history
        txn = target.transaction() if (unit.transactional and
                                       hasattr(target, "transaction")) \
            else nullcontext()

        if unit.mode == FULL:
            with txn, self.telemetry.timed(unit.dataset, unit.target_format,
                                           "full", f"to {unit.source_head}"):
                snapshot = source.get_snapshot(unit.source_head)
                target.full_sync(snapshot)
            self.telemetry.bump("sync.full")
            return SyncResult(unit.dataset, unit.target_format, FULL,
                              1, unit.source_head, target_commits=1)

        changes = [source.get_changes(c) for c in unit.commits]
        if unit.coalesce and len(changes) > 1:
            changes = [fold_changes(changes)]
        n = 0
        with txn:
            for change in changes:
                label = (f"commits {change.lineage[0]}..{change.source_commit}"
                         if change.lineage else
                         f"commit {change.source_commit}")
                with self.telemetry.timed(unit.dataset, unit.target_format,
                                          "incremental", label):
                    target.incremental_sync(change)
                n += 1
        self.telemetry.bump("sync.incremental", n)
        last = unit.commits[-1] if unit.commits else unit.source_head
        return SyncResult(unit.dataset, unit.target_format,
                          INCREMENTAL, len(unit.commits), last,
                          target_commits=n)
