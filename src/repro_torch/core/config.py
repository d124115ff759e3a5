# Copy of repro/core/config.py; the port imports nothing of repro.
"""Sync configuration — the paper's Listing 2.

::

    sourceFormat: HUDI
    targetFormats:
      - DELTA
      - ICEBERG
    datasets:
      -
        tableBasePath: abfs://container@ac.dfs.core.windows.net/sales

Accepts YAML text, a file path, or a plain dict.  Optional knobs:

* ``incremental`` (default true) — prefer incremental, fall back to full.
* ``transactionalTargets`` (default true) — drain each sync unit inside one
  target transaction (target metadata parsed once, commits flushed with no
  re-reads); false restores the seed per-commit path.
* ``coalesceIncremental`` (default false) — fold the whole backlog into a
  single net target commit (freshness over 1:1 history fidelity).
* ``maxCommitsPerSync`` (default unlimited) — cap the commits one run
  applies; the next run continues from the recorded sync token.
* ``manifestCompactionThreshold`` (default off) — iceberg targets: when a
  commit would leave more than this many manifests in the manifest list
  (long incremental chains grow one small manifest per commit), fold them
  all into one, bounding snapshot-read amplification.
* ``storage`` (default local, no injection) — storage-backend behavior:
  any of ``rttMs`` / ``faultRate`` / ``ambiguousPutRate`` wraps the backend
  in a simulated object store; ``pipelineDepth`` / ``seed`` shape that
  simulation (honored on ``s3sim://`` even with no injection knobs set);
  ``retry: {maxAttempts, baseDelayMs, maxDelayMs}`` tunes the
  exponential-backoff retry layer.  The backend itself comes from the
  dataset URI scheme (``file://`` / ``mem://`` / ``s3sim://`` / plain
  path) via the storage registry.
* ``daemon`` — continuous-sync daemon scheduling (see ``core/daemon.py``):
  ``pollIntervalMs`` between watch cycles, ``maxCyclesIdle`` (stop after N
  consecutive idle cycles; default run forever), and
  ``backoff: {baseDelayMs, maxDelayMs, multiplier, jitter, seed}`` — the
  jittered per-table backoff applied when a table's probe or drain hits a
  (transient) storage error.
* ``fleet`` — sharded sync fleet (see ``core/fleet.py``): ``workers`` (> 1
  engages the fleet cycle path, as does setting a drain budget),
  ``shardStrategy`` (``hash`` |
  ``roundRobin``), ``stealThresholdMs`` (min queue age before an idle
  worker may steal a cell), ``urgencyHalfLifeMs`` (the commit-rate EWMA
  half-life behind urgency = backlog x rate), ``scheduler`` (``urgency`` |
  ``fifo``), ``maxUnitsPerCycle`` (per-cycle drain budget across all
  workers — the top-budget cells of the global scheduler ordering),
  and ``mode`` (``thread`` | ``process``).
* ``checkpoint`` — durable daemon checkpoint for crash-safe warm restarts
  (see ``core/checkpoint.py``): ``enabled``, ``path`` (store-local dir,
  default ``<first dataset>/_xtable/checkpoint``), ``intervalCycles``,
  ``retain`` (generations kept), ``minWindow`` (index entries kept beyond
  each table's pending lag).  The checkpoint is advisory — a restarted
  daemon re-verifies it against the live head, which always wins.
* ``health`` — per-table circuit breakers (see ``core/health.py``):
  ``enabled`` (default true), ``failureThreshold``, ``openCooldownMs``,
  ``halfOpenProbes``, ``quarantineAfter``, ``quarantineCooldownMs``.
* ``readPlane`` — snapshot-serving read plane (see ``serve/read_plane.py``):
  ``ttlMs`` (head-probe amortization window: at most one O(1) head probe
  per table per window, shared across every reader), ``maxSnapshots``
  (LRU bound on memoized head-keyed snapshots), ``statsCacheBytes``
  (budget for the immutable chunk-stats footer cache behind
  ``scan()`` predicate pushdown).
* ``catalog`` — catalog registration + atomic multi-table group publish
  (see ``lst/catalog/``): ``enabled``, ``path``, ``group`` (the dataset
  group this config's tables publish under), ``publishViews``
  (``all`` | ``source``), ``retain`` (manifest generations kept).

The consolidated reference for every block — defaults, camelCase keys,
and the semantics behind each knob — is ``docs/config.md``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.lst.storage import (RetryPolicy, StorageProfile, layer_fs, make_fs,
                               resolve_uri, scheme_of)

KNOWN_FORMATS = ("delta", "iceberg", "hudi")


@dataclass(frozen=True)
class DatasetConfig:
    table_base_path: str
    table_name: str | None = None

    @property
    def path(self) -> str:
        # registry-based resolution keeps the authority/bucket component,
        # so two buckets with the same key path cannot collide
        return resolve_uri(self.table_base_path)

    @property
    def name(self) -> str:
        return self.table_name or self.path.rstrip("/").rsplit("/", 1)[-1]


@dataclass(frozen=True)
class StorageOptions:
    """Storage-backend behavior: fault/latency injection + retry policy."""
    rtt_ms: float = 0.0
    fault_rate: float = 0.0
    ambiguous_put_rate: float = 0.0
    pipeline_depth: int = 16
    seed: int = 0
    retry_max_attempts: int = 5
    retry_base_delay_ms: float = 10.0
    retry_max_delay_ms: float = 1000.0

    def profile(self) -> StorageProfile | None:
        """A StorageProfile when any injection knob is set, else None."""
        if self.rtt_ms or self.fault_rate or self.ambiguous_put_rate:
            return StorageProfile(
                rtt_ms=self.rtt_ms, fault_rate=self.fault_rate,
                ambiguous_put_rate=self.ambiguous_put_rate,
                pipeline_depth=self.pipeline_depth, seed=self.seed)
        return None

    def retry_policy(self) -> RetryPolicy:
        return RetryPolicy(max_attempts=self.retry_max_attempts,
                           base_delay_s=self.retry_base_delay_ms / 1000.0,
                           max_delay_s=self.retry_max_delay_ms / 1000.0)

    @staticmethod
    def from_dict(d: dict) -> "StorageOptions":
        r = d.get("retry", {})
        return StorageOptions(
            rtt_ms=float(d.get("rttMs", 0.0)),
            fault_rate=float(d.get("faultRate", 0.0)),
            ambiguous_put_rate=float(d.get("ambiguousPutRate", 0.0)),
            pipeline_depth=int(d.get("pipelineDepth", 16)),
            seed=int(d.get("seed", 0)),
            retry_max_attempts=int(r.get("maxAttempts", 5)),
            retry_base_delay_ms=float(r.get("baseDelayMs", 10.0)),
            retry_max_delay_ms=float(r.get("maxDelayMs", 1000.0)))


@dataclass(frozen=True)
class DaemonOptions:
    """Continuous-sync daemon scheduling knobs (the ``daemon:`` block)."""
    poll_interval_ms: float = 1000.0
    max_cycles_idle: int | None = None     # None = run until stopped
    backoff_base_delay_ms: float = 100.0
    backoff_max_delay_ms: float = 30_000.0
    backoff_multiplier: float = 2.0
    backoff_jitter: float = 0.1            # +-fraction of the delay
    seed: int = 0                          # jitter RNG seed (determinism)

    def __post_init__(self):
        if self.poll_interval_ms < 0:
            raise ValueError("pollIntervalMs must be >= 0")
        if self.max_cycles_idle is not None and self.max_cycles_idle < 1:
            raise ValueError("maxCyclesIdle must be >= 1")

    def backoff_delay_s(self, failures: int) -> float:
        """Un-jittered backoff after ``failures`` consecutive errors."""
        d = self.backoff_base_delay_ms * \
            (self.backoff_multiplier ** max(0, failures - 1))
        return min(self.backoff_max_delay_ms, d) / 1000.0

    @staticmethod
    def from_dict(d: dict) -> "DaemonOptions":
        b = d.get("backoff", {})
        mci = d.get("maxCyclesIdle")
        return DaemonOptions(
            poll_interval_ms=float(d.get("pollIntervalMs", 1000.0)),
            max_cycles_idle=int(mci) if mci is not None else None,
            backoff_base_delay_ms=float(b.get("baseDelayMs", 100.0)),
            backoff_max_delay_ms=float(b.get("maxDelayMs", 30_000.0)),
            backoff_multiplier=float(b.get("multiplier", 2.0)),
            backoff_jitter=float(b.get("jitter", 0.1)),
            seed=int(b.get("seed", 0)))


@dataclass(frozen=True)
class FleetOptions:
    """Sharded sync fleet knobs (the ``fleet:`` block; see ``core/fleet.py``).

    ``workers > 1`` (or any ``maxUnitsPerCycle`` budget) switches the
    daemon's cycle from the serial per-dataset loop to the fleet path:
    probes and planning fan out over the worker pool, and the planned
    (dataset, target) cells drain through per-worker shard queues with
    work stealing, ordered by the lag-aware scheduler.
    """
    workers: int = 1
    shard_strategy: str = "hash"           # hash | round_robin
    steal_threshold_ms: float = 0.0        # min cell age before stealable
    urgency_half_life_ms: float = 60_000.0  # commit-rate EWMA half-life
    scheduler: str = "urgency"             # urgency | fifo
    max_units_per_cycle: int | None = None  # per-cycle drain budget (None = all)
    mode: str = "thread"                   # thread | process (FULL bootstraps)

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError("fleet workers must be >= 1")
        if self.shard_strategy not in ("hash", "round_robin"):
            raise ValueError("shardStrategy must be 'hash' or 'roundRobin'")
        if self.scheduler not in ("urgency", "fifo"):
            raise ValueError("scheduler must be 'urgency' or 'fifo'")
        if self.mode not in ("thread", "process"):
            raise ValueError("fleet mode must be 'thread' or 'process'")
        if self.steal_threshold_ms < 0:
            raise ValueError("stealThresholdMs must be >= 0")
        if self.urgency_half_life_ms <= 0:
            raise ValueError("urgencyHalfLifeMs must be > 0")
        if self.max_units_per_cycle is not None \
                and self.max_units_per_cycle < 1:
            raise ValueError("maxUnitsPerCycle must be >= 1")

    @staticmethod
    def from_dict(d: dict) -> "FleetOptions":
        strategy = str(d.get("shardStrategy", "hash"))
        # accept camelCase (config idiom) and snake_case spellings
        strategy = {"roundrobin": "round_robin"}.get(
            strategy.replace("_", "").lower(), strategy)
        mupc = d.get("maxUnitsPerCycle")
        return FleetOptions(
            workers=int(d.get("workers", 1)),
            shard_strategy=strategy,
            steal_threshold_ms=float(d.get("stealThresholdMs", 0.0)),
            urgency_half_life_ms=float(d.get("urgencyHalfLifeMs", 60_000.0)),
            scheduler=str(d.get("scheduler", "urgency")).lower(),
            max_units_per_cycle=int(mupc) if mupc is not None else None,
            mode=str(d.get("mode", "thread")).lower())


@dataclass(frozen=True)
class CheckpointOptions:
    """Durable daemon checkpoint knobs (the ``checkpoint:`` block).

    The checkpoint is *advisory*: it only seeds the restarted daemon's
    in-memory state (sync tokens, metadata-index tail, backoff/health and
    commit-rate estimates) so the first cycle costs O(new commits) instead
    of a cold O(history) rebuild — the live table head is always
    re-verified and wins over anything the checkpoint claims (see
    ``core/checkpoint.py``).
    """
    enabled: bool = False
    # store-local path of the checkpoint dir; None derives
    # "<first dataset>/_xtable/checkpoint" so the default always lands in a
    # namespace the daemon can already write
    path: str | None = None
    interval_cycles: int = 1       # save at most every N non-idle cycles
    retain: int = 3                # generations kept (older ones pruned)
    # index entries checkpointed beyond each table's pending lag, so a
    # target that slipped a little further behind still resumes warm
    min_window: int = 4

    def __post_init__(self):
        if self.interval_cycles < 1:
            raise ValueError("checkpoint intervalCycles must be >= 1")
        if self.retain < 1:
            raise ValueError("checkpoint retain must be >= 1")
        if self.min_window < 1:
            raise ValueError("checkpoint minWindow must be >= 1")

    @staticmethod
    def from_dict(d: dict) -> "CheckpointOptions":
        return CheckpointOptions(
            enabled=bool(d.get("enabled", False)),
            path=d.get("path"),
            interval_cycles=int(d.get("intervalCycles", 1)),
            retain=int(d.get("retain", 3)),
            min_window=int(d.get("minWindow", 4)))


@dataclass(frozen=True)
class HealthOptions:
    """Per-table circuit-breaker knobs (the ``health:`` block).

    ``closed -> open -> half_open`` per table (see ``core/health.py``):
    ``failureThreshold`` consecutive probe/plan/drain failures open the
    breaker (the table is skipped — not even probed — until
    ``openCooldownMs`` passes), then one half-open trial cycle either
    closes it or re-opens; ``quarantineAfter`` consecutive opens move the
    table to ``quarantined`` — parked until ``quarantineCooldownMs`` (and
    excluded from ``stop(drain=True)``, so one poisoned table cannot hold
    the daemon's shutdown hostage).
    """
    enabled: bool = True
    failure_threshold: int = 5
    open_cooldown_ms: float = 60_000.0
    half_open_probes: int = 1          # successes to close from half-open
    quarantine_after: int = 3          # consecutive opens before quarantine
    quarantine_cooldown_ms: float = 3_600_000.0

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError("health failureThreshold must be >= 1")
        if self.open_cooldown_ms < 0:
            raise ValueError("health openCooldownMs must be >= 0")
        if self.half_open_probes < 1:
            raise ValueError("health halfOpenProbes must be >= 1")
        if self.quarantine_after < 1:
            raise ValueError("health quarantineAfter must be >= 1")
        if self.quarantine_cooldown_ms < 0:
            raise ValueError("health quarantineCooldownMs must be >= 0")

    @staticmethod
    def from_dict(d: dict) -> "HealthOptions":
        return HealthOptions(
            enabled=bool(d.get("enabled", True)),
            failure_threshold=int(d.get("failureThreshold", 5)),
            open_cooldown_ms=float(d.get("openCooldownMs", 60_000.0)),
            half_open_probes=int(d.get("halfOpenProbes", 1)),
            quarantine_after=int(d.get("quarantineAfter", 3)),
            quarantine_cooldown_ms=float(
                d.get("quarantineCooldownMs", 3_600_000.0)))


@dataclass(frozen=True)
class ReadPlaneOptions:
    """Snapshot-serving read plane knobs (the ``readPlane:`` block).

    The read plane (``serve/read_plane.py``) serves immutable table
    snapshots keyed by head token with conditional-GET semantics:
    ``ttlMs`` bounds how stale a served token may be — within one window
    at most ONE head probe happens per table, shared by every reader;
    ``maxSnapshots`` bounds the LRU of memoized snapshots; and
    ``statsCacheBytes`` budgets the chunk-stats footer cache behind
    ``scan()``'s predicate pushdown (chunk files are write-once, so the
    footer cache never invalidates — only evicts).
    ``lateMaterialization`` (default on) makes predicated scans fetch in
    two phases through the CHK3 column index — predicate columns first,
    then only the projected columns of chunks whose row masks survived;
    off, a predicated scan fetches every needed column in one ranged
    round (projection pushdown itself stays on — it needs no knob, the
    results are byte-identical either way).
    """
    ttl_ms: float = 1000.0
    max_snapshots: int = 64
    stats_cache_bytes: int = 16 * 2**20
    late_materialization: bool = True

    def __post_init__(self):
        if self.ttl_ms < 0:
            raise ValueError("readPlane ttlMs must be >= 0")
        if self.max_snapshots < 1:
            raise ValueError("readPlane maxSnapshots must be >= 1")
        if self.stats_cache_bytes < 0:
            raise ValueError("readPlane statsCacheBytes must be >= 0")

    @staticmethod
    def from_dict(d: dict) -> "ReadPlaneOptions":
        return ReadPlaneOptions(
            ttl_ms=float(d.get("ttlMs", 1000.0)),
            max_snapshots=int(d.get("maxSnapshots", 64)),
            stats_cache_bytes=int(d.get("statsCacheBytes", 16 * 2**20)),
            late_materialization=bool(d.get("lateMaterialization", True)))


@dataclass(frozen=True)
class CatalogOptions:
    """Catalog publishing knobs (the ``catalog:`` block).

    With ``enabled`` the daemon registers every cleanly drained table in
    the catalog (``lst/catalog/``) and publishes each cycle's drained
    set as ONE atomic group commit, so cross-table readers resolving
    through the catalog never observe a half-synced dataset.  ``group``
    names the dataset group this config's tables publish under;
    ``publishViews`` selects which format views get pinned head tokens
    (``all`` also pins every target view — one O(1) probe plus a
    tail-only index refresh per target per publish; ``source`` pins only
    the source view at zero extra requests).  ``path`` defaults to
    ``<parent of first dataset>/_xtable/catalog``.
    """
    enabled: bool = False
    path: str | None = None
    group: str = "default"
    publish_views: str = "all"     # all | source
    retain: int = 8                # manifest generations kept

    def __post_init__(self):
        if not self.group:
            raise ValueError("catalog group must be non-empty")
        if self.publish_views not in ("all", "source"):
            raise ValueError("catalog publishViews must be 'all' or 'source'")
        if self.retain < 1:
            raise ValueError("catalog retain must be >= 1")

    @staticmethod
    def from_dict(d: dict) -> "CatalogOptions":
        return CatalogOptions(
            enabled=bool(d.get("enabled", False)),
            path=d.get("path"),
            group=str(d.get("group", "default")),
            publish_views=str(d.get("publishViews", "all")).lower(),
            retain=int(d.get("retain", 8)))


@dataclass(frozen=True)
class SyncConfig:
    source_format: str
    target_formats: tuple
    datasets: tuple
    incremental: bool = True      # prefer incremental, fall back to full
    # drain an N-commit backlog inside ONE target transaction (state read
    # once, every commit flushed without a re-read); off = seed per-commit
    # path, kept for benchmarking the difference
    transactional_targets: bool = True
    # fold the whole backlog into a single net target commit (freshness over
    # 1:1 history fidelity; per-commit lineage kept in the commit metadata)
    coalesce_incremental: bool = False
    # cap how many backlog commits one sync run applies (None = all); the
    # target advances to the cap and the next run continues from there
    max_commits_per_sync: int | None = None
    # iceberg targets: fold the manifest list into one manifest whenever a
    # commit would leave more than this many (None = never compact)
    manifest_compaction_threshold: int | None = None
    # storage-backend behavior (latency/fault injection, retry policy)
    storage: StorageOptions = field(default_factory=StorageOptions)
    # continuous-sync daemon scheduling (poll interval, idle stop, backoff)
    daemon: DaemonOptions = field(default_factory=DaemonOptions)
    # sharded sync fleet (workers > 1 engages the fleet cycle path)
    fleet: FleetOptions = field(default_factory=FleetOptions)
    # durable daemon checkpoint (crash-safe warm restarts)
    checkpoint: CheckpointOptions = field(default_factory=CheckpointOptions)
    # per-table circuit breakers (closed -> open -> half_open -> quarantined)
    health: HealthOptions = field(default_factory=HealthOptions)
    # snapshot-serving read plane (memoized head-keyed snapshots)
    read_plane: ReadPlaneOptions = field(default_factory=ReadPlaneOptions)
    # catalog registration + atomic multi-table group publish
    catalog: CatalogOptions = field(default_factory=CatalogOptions)

    def __post_init__(self):
        for f in (self.source_format, *self.target_formats):
            if f not in KNOWN_FORMATS:
                raise ValueError(f"unknown format {f!r}; known: {KNOWN_FORMATS}")
        if self.source_format in self.target_formats:
            raise ValueError("source format cannot also be a target")
        if self.max_commits_per_sync is not None \
                and self.max_commits_per_sync < 1:
            raise ValueError("maxCommitsPerSync must be >= 1")
        if self.manifest_compaction_threshold is not None \
                and self.manifest_compaction_threshold < 1:
            raise ValueError("manifestCompactionThreshold must be >= 1")

    @staticmethod
    def from_dict(d: dict) -> "SyncConfig":
        datasets = tuple(
            DatasetConfig(x["tableBasePath"], x.get("tableName"))
            for x in d.get("datasets", []))
        mcps = d.get("maxCommitsPerSync")
        mct = d.get("manifestCompactionThreshold")
        return SyncConfig(
            source_format=d["sourceFormat"].lower(),
            target_formats=tuple(t.lower() for t in d["targetFormats"]),
            datasets=datasets,
            incremental=bool(d.get("incremental", True)),
            transactional_targets=bool(d.get("transactionalTargets", True)),
            coalesce_incremental=bool(d.get("coalesceIncremental", False)),
            max_commits_per_sync=int(mcps) if mcps is not None else None,
            manifest_compaction_threshold=int(mct) if mct is not None
            else None,
            storage=StorageOptions.from_dict(d.get("storage", {})),
            daemon=DaemonOptions.from_dict(d.get("daemon", {})),
            fleet=FleetOptions.from_dict(d.get("fleet", {})),
            checkpoint=CheckpointOptions.from_dict(d.get("checkpoint", {})),
            health=HealthOptions.from_dict(d.get("health", {})),
            read_plane=ReadPlaneOptions.from_dict(d.get("readPlane", {})),
            catalog=CatalogOptions.from_dict(d.get("catalog", {})))

    def build_fs(self, telemetry=None, *, sleep=None):
        """Construct the storage stack this config describes.

        The backend comes from the dataset URI scheme through the registry
        (all datasets of one config must agree on a scheme — they share one
        FileSystem for the run); it is then layered per ``storage``:
        latency/fault simulation when injection knobs are set, the
        exponential-backoff retry layer, and the instrumented wrapper
        feeding ``telemetry`` request/byte counters.  ``sleep`` replaces
        the retry layer's backoff sleeper — the daemon passes its injected
        clock's ``sleep`` so retry backoff never wall-sleeps in tests or
        benchmarks.
        """
        schemes = {scheme_of(ds.table_base_path) for ds in self.datasets}
        schemes.discard(None)       # plain paths ride the local backend
        if len(schemes) > 1:
            raise ValueError(f"datasets span multiple storage schemes: "
                             f"{sorted(schemes)}")
        scheme = schemes.pop() if schemes else "file"
        profile = self.storage.profile()
        if scheme == "s3sim":
            # the s3sim factory owns the simulation wrapper; hand it every
            # simulation knob (pipelineDepth/seed included, even with no
            # fault/latency injection) instead of double-wrapping
            from dataclasses import asdict
            base = make_fs("s3sim", **asdict(profile or StorageProfile(
                pipeline_depth=self.storage.pipeline_depth,
                seed=self.storage.seed)))
            profile = None
        else:
            base = make_fs(scheme)
        return layer_fs(base, profile=profile,
                        retry=self.storage.retry_policy(),
                        telemetry=telemetry, sleep=sleep)

    @staticmethod
    def from_yaml(text: str) -> "SyncConfig":
        import yaml
        return SyncConfig.from_dict(yaml.safe_load(text))

    @staticmethod
    def from_file(path: str) -> "SyncConfig":
        with open(path) as f:
            return SyncConfig.from_yaml(f.read())
