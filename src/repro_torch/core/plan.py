# Copy of repro/core/plan.py; the port imports nothing of repro.
"""Sync planning (stage 1 of plan -> execute).

The planner inspects every (dataset, target) cell of the config up front and
emits a :class:`SyncPlan` of :class:`SyncUnit` work items — FULL /
INCREMENTAL (with the exact commit range) / SKIP / ERROR — without executing
anything.  Decisions become testable in isolation, and the executor receives
a set of independent units it can run concurrently.

Decision per target (same contract as the seed syncer):

* target has no sync state            -> FULL snapshot sync
* target's token missing from source  -> FULL (history cleaned / diverged)
* target already at the source head   -> SKIP
* otherwise                           -> INCREMENTAL, commit-by-commit
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.config import DatasetConfig, SyncConfig
from repro_torch.core.metadata_cache import MetadataCache
from repro_torch.core.sources import make_source
from repro_torch.core.targets import make_target
from repro_torch.core.telemetry import Telemetry

FULL = "FULL"
INCREMENTAL = "INCREMENTAL"
SKIP = "SKIP"
ERROR = "ERROR"


@dataclass(frozen=True)
class SyncUnit:
    """One independently executable (dataset, target) translation."""
    dataset: str
    base_path: str
    source_format: str
    target_format: str
    mode: str                       # FULL | INCREMENTAL | SKIP | ERROR
    source_head: str | None = None
    commits: tuple = ()             # commit range for INCREMENTAL, in order
    reason: str = ""
    transactional: bool = True      # drain inside one target transaction
    coalesce: bool = False          # fold the range into one net commit
    backlog: int = 0                # total commits behind BEFORE the
                                    # maxCommitsPerSync cap; len(commits) <
                                    # backlog means this unit is a bounded
                                    # drain and the target stays behind

    @property
    def actionable(self) -> bool:
        return self.mode in (FULL, INCREMENTAL)


@dataclass
class SyncPlan:
    """Ordered set of SyncUnits for one config (order == config order).

    ``writers`` carries the target writers the planner already opened (keyed
    by ``(base_path, target_format)``) so the executor reuses their cached
    target-side state instead of replaying each target log a second time.
    """
    units: list = field(default_factory=list)
    writers: dict = field(default_factory=dict, repr=False, compare=False)

    def by_mode(self, mode: str) -> list:
        return [u for u in self.units if u.mode == mode]

    def pending(self) -> list:
        return [u for u in self.units if u.actionable]

    def summary(self) -> dict:
        out: dict[str, int] = {}
        for u in self.units:
            out[u.mode] = out.get(u.mode, 0) + 1
        return out


class SyncPlanner:
    """Builds a SyncPlan; shares one MetadataCache with the executor so the
    single log replay done while planning also serves execution."""

    def __init__(self, config: SyncConfig, fs=None,
                 cache: MetadataCache | None = None,
                 telemetry: Telemetry | None = None):
        self.config = config
        self.telemetry = telemetry or Telemetry()
        self.fs = fs or config.build_fs(self.telemetry)
        self.cache = cache or MetadataCache(self.fs)
        self.writers: dict = {}

    # ------------------------------------------------------------------ api
    def plan(self) -> SyncPlan:
        plan = SyncPlan()
        for ds in self.config.datasets:
            plan.units.extend(self.plan_dataset(ds))
        plan.writers = self.writers
        return plan

    def plan_dataset(self, ds: DatasetConfig,
                     head_hint: str | None = None) -> list:
        """Plan every (``ds``, target) cell.

        ``head_hint`` — a head token the caller just probed (the daemon's
        watch phase) — is installed on the dataset's metadata index for the
        duration of this planning pass, so ``current_commit()`` and the
        index's tail refresh consume that one probe instead of re-reading
        the source head; the daemon clears it at cycle end (the hint is
        scoped to a single cycle — ``refresh()`` stays the one explicit
        staleness point).
        """
        src_fmt = self.config.source_format
        index = self.cache.index(src_fmt, ds.path)
        if head_hint:
            index.hint_head(head_hint)
        source = make_source(src_fmt, self.fs, ds.path, index)
        head = source.current_commit()
        units = []
        for tf in self.config.target_formats:
            try:
                u = self._plan_one(ds, source, head, tf)
            except Exception as e:  # a broken target must not poison others
                u = SyncUnit(ds.name, ds.path, src_fmt, tf, ERROR,
                             source_head=head, reason=str(e))
            self.telemetry.record(ds.name, tf, "plan",
                                  f"{u.mode} {u.reason}".strip())
            units.append(u)
        return units

    # ------------------------------------------------------------- internals
    def _plan_one(self, ds: DatasetConfig, source, head: str,
                  target_format: str) -> SyncUnit:
        target = make_target(
            target_format, self.fs, ds.path,
            manifest_compaction_threshold=self.config
            .manifest_compaction_threshold)
        token = target.get_sync_token()
        src_fmt_on_target = target.get_sync_source_format()
        self.writers[(ds.path, target_format)] = target
        txn = self.config.transactional_targets

        if token == head and src_fmt_on_target == source.format:
            return SyncUnit(ds.name, ds.path, source.format, target_format,
                            SKIP, source_head=head,
                            reason=f"already at {head}")

        use_incremental = (
            self.config.incremental
            and token is not None
            and src_fmt_on_target == source.format
            and source.has_commit(token))

        if not use_incremental:
            if token is None:
                reason = "no sync state on target"
            elif src_fmt_on_target != source.format:
                reason = (f"source format changed "
                          f"({src_fmt_on_target} -> {source.format})")
            elif not self.config.incremental:
                reason = "incremental disabled"
            else:
                reason = f"token {token} not in source history"
            return SyncUnit(ds.name, ds.path, source.format, target_format,
                            FULL, source_head=head, reason=reason,
                            transactional=txn)

        commits = tuple(source.get_commits_since(token))
        backlog = len(commits)
        reason = f"{backlog} commits behind"
        cap = self.config.max_commits_per_sync
        if cap is not None and len(commits) > cap:
            commits = commits[:cap]
            reason += f", capped at {cap}"
        return SyncUnit(ds.name, ds.path, source.format, target_format,
                        INCREMENTAL, source_head=head, commits=commits,
                        reason=reason, transactional=txn,
                        coalesce=self.config.coalesce_incremental,
                        backlog=backlog)
