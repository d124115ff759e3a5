# Copy of repro/core/sync.py; the port imports nothing of repro.
"""XTable core logic (paper §3.1): a facade over plan -> cache -> execute.

Responsibilities, per the paper: initializing components, managing sources
and targets, caching for efficiency, state management for recovery and
incremental processing, telemetry for monitoring.

The work is split across three layers (see ``plan.py``, ``metadata_cache.py``
and ``executor.py``):

1. :class:`~repro_torch.core.plan.SyncPlanner` inspects all sources and targets and
   emits a ``SyncPlan`` of FULL / INCREMENTAL / SKIP units with exact commit
   ranges — decisions, testable without executing anything.
2. :class:`~repro_torch.core.metadata_cache.MetadataCache` replays each source log
   ONCE and serves every per-commit snapshot/change from that pass, shared
   by all targets of a dataset; a moved head refreshes the index by
   replaying only the new tail commits.
3. :class:`~repro_torch.core.executor.SyncExecutor` runs independent units on a
   thread pool with per-unit telemetry and fail isolation.  Each unit
   drains inside one target *transaction* (target metadata parsed once,
   every commit flushed put-if-absent with no re-read), and the
   ``coalesceIncremental`` / ``maxCommitsPerSync`` config knobs trade 1:1
   history fidelity for a single net commit / bounded batch per run.

Both paths stay idempotent: rerunning a sync that is already current is a
no-op (``skip``), and a crash between two targets leaves each target either
untouched or atomically advanced — recovery is simply "run it again",
because the sync state lives inside each target's own atomic commit.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.core.config import DatasetConfig, SyncConfig
from repro_torch.core.executor import SyncExecutor, SyncResult
from repro_torch.core.metadata_cache import MetadataCache
from repro_torch.core.plan import SyncPlan, SyncPlanner
from repro_torch.core.telemetry import Telemetry

__all__ = ["SyncResult", "XTableSyncer", "run_sync"]


@dataclass
class XTableSyncer:
    config: SyncConfig
    fs: object = None
    telemetry: Telemetry = field(default_factory=Telemetry)
    max_workers: int | None = None        # None = auto; 1 = serial
    cache: MetadataCache | None = None
    coalesce: bool | None = None          # None = take from config
    max_commits_per_sync: int | None = None

    def __post_init__(self):
        # no explicit fs -> build the config's storage stack (scheme-registry
        # backend + optional simulation + retry + telemetry instrumentation)
        self.fs = self.fs or self.config.build_fs(self.telemetry)
        self.cache = self.cache or MetadataCache(self.fs)
        overrides = {}
        if self.coalesce is not None:
            overrides["coalesce_incremental"] = self.coalesce
        if self.max_commits_per_sync is not None:
            overrides["max_commits_per_sync"] = self.max_commits_per_sync
        if overrides:
            self.config = replace(self.config, **overrides)

    # ------------------------------------------------------------------ api
    def plan(self) -> SyncPlan:
        """Inspect sources/targets and decide, without executing anything."""
        return SyncPlanner(self.config, self.fs, self.cache,
                           self.telemetry).plan()

    def run(self) -> list[SyncResult]:
        return self._execute(self.plan())

    def sync_dataset(self, ds: DatasetConfig) -> list[SyncResult]:
        planner = SyncPlanner(self.config, self.fs, self.cache,
                              self.telemetry)
        units = planner.plan_dataset(ds)
        return self._execute(SyncPlan(units, planner.writers))

    # ------------------------------------------------------------- internals
    def _execute(self, plan: SyncPlan) -> list[SyncResult]:
        executor = SyncExecutor(
            self.fs, self.cache, self.telemetry, self.max_workers,
            manifest_compaction_threshold=self.config
            .manifest_compaction_threshold)
        return executor.execute(plan)


def run_sync(config: SyncConfig, fs=None,
             telemetry: Telemetry | None = None, *,
             max_workers: int | None = None,
             cache: MetadataCache | None = None,
             coalesce: bool | None = None,
             max_commits_per_sync: int | None = None) -> list[SyncResult]:
    """One-shot entry point (the CLI / background-process body).

    ``coalesce`` / ``max_commits_per_sync`` override the corresponding
    config knobs for this run only.
    """
    syncer = XTableSyncer(config, fs, telemetry or Telemetry(),
                          max_workers, cache, coalesce, max_commits_per_sync)
    return syncer.run()
