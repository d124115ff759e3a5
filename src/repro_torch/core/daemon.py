# Copy of repro/core/daemon.py; the port imports nothing of repro.
"""Continuous-sync daemon: watch -> replan -> drain cycles.

The paper's promise — a table written in one format is readable in any
other "with negligible overhead" — only holds in practice if translation
runs *continuously* as writers append, not as one-shot batch jobs.  This
module turns the batch pipeline (``SyncPlanner`` / ``MetadataCache`` /
``SyncExecutor``) into that always-on companion process:

1. **Watch** — every cycle probes each source table's head with ONE cheap
   storage request (``handle.head_token()``: delta log-tail listing,
   iceberg ``version-hint`` read, hudi newest-instant listing — never a
   replay).  A quiet table costs exactly its head probe and nothing else:
   no planning, no target reads.
2. **Replan** — only datasets whose token moved (or that still carry a
   capped/failed backlog) are re-planned, through the shared
   :class:`~repro_torch.core.metadata_cache.MetadataCache` held across cycles, so
   a cycle with N new commits costs O(N) source reads (the tail-only index
   refresh) plus O(1) target reads per drained unit.
3. **Drain** — the changed units run through the normal transactional /
   coalescing executor path; ``maxCommitsPerSync`` bounds each cycle's
   drain (backpressure), and the leftover backlog keeps the dataset marked
   *pending* so the next cycle continues from the recorded sync token even
   if the source head did not move again.

Scheduling is deterministic: the clock is injected (``ManualClock`` in
tests and benchmarks — nothing ever wall-sleeps), the poll interval comes
from the config's ``daemon:`` block, and a table whose probe or drain hits
a storage error backs off individually with seeded, jittered exponential
delays — one throttled table never stalls the fleet.

Every cycle emits a :class:`DaemonCycleReport`: tables probed / quiet /
changed / backed-off, units planned / drained / skipped / errored, commits
applied, remaining lag in commits per (dataset, target), and the cycle's
exact storage-request census when the filesystem is instrumented.

``stop()`` is graceful: the in-flight cycle always completes (every target
commit is an atomic put-if-absent, so there is no torn state to clean up).
``stop(drain=True)`` keeps cycling without poll sleeps until no table has a
pending backlog, then stops — call ``stop()`` again to give up on a
persistently failing table and exit immediately.

Robustness and publishing companions (all opt-in through the config):

* **Durable checkpoints** (``checkpoint:`` block, ``core/checkpoint.py``) —
  every non-idle cycle persists the watch state, a metadata-index tail
  seed, breaker states and commit-rate estimates as one conditionally-put
  generation; a restarted daemon resumes at O(new commits) instead of a
  cold O(history) rebuild.  The checkpoint is *advisory*: the first
  cycle's probes re-verify every table against its live head, which
  always wins.
* **Per-table circuit breakers** (``health:`` block, ``core/health.py``) —
  repeated failures open a breaker (the table is skipped outright, not
  even probed, until a cooldown), repeated opens quarantine the table;
  quarantined backlogs are excluded from ``stop(drain=True)`` so one
  poisoned table cannot hold shutdown hostage.
* **Catalog group publish** (``catalog:`` block, ``lst/catalog/``) —
  every cycle's cleanly drained tables register in the catalog as ONE
  atomic generation post-drain (a *group commit*), so cross-table
  readers pinning through the catalog
  (``SnapshotServer.read_group``) observe either all of a cycle's
  publish or none of it; the catalog generation rides the checkpoint.

Facade: ``run_daemon(config, cycles=N)`` for scripts and operators;
``examples/continuous_sync.py`` drives it against an ``s3sim://`` store.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from repro_torch.core.checkpoint import CheckpointStore, decode_seed, encode_seed
from repro_torch.core.config import DatasetConfig, FleetOptions, SyncConfig
from repro_torch.core.executor import SyncExecutor
from repro_torch.core.fleet import SyncFleet
from repro_torch.core.health import ALLOW, PARKED, HealthTracker
from repro_torch.core.metadata_cache import MetadataCache
from repro_torch.core.plan import ERROR, SKIP, SyncPlan, SyncPlanner
from repro_torch.core.telemetry import Telemetry
from repro_torch.lst.catalog import Catalog, TablePointer, ViewRef
from repro_torch.lst.storage.base import join

__all__ = ["SystemClock", "ManualClock", "DaemonCycleReport", "SyncDaemon",
           "run_daemon"]

# unbounded run(): rolling window of retained per-cycle reports (an
# always-on daemon at 1s polls produces ~86k cycles/day; keeping them all
# would grow memory with uptime)
MAX_RETAINED_REPORTS = 1000


class SystemClock:
    """Wall clock (monotonic) — the default outside tests."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)

    def wait(self, event: threading.Event, seconds: float) -> bool:
        """Sleep up to ``seconds`` but wake immediately if ``event`` sets —
        this is what makes ``stop()`` interrupt a long poll interval."""
        if seconds > 0:
            return event.wait(seconds)
        return event.is_set()


class ManualClock:
    """Deterministic clock: ``sleep`` advances ``now`` instantly.

    Injected into the daemon by tests and benchmarks so poll intervals and
    backoff windows are exercised without ever wall-sleeping.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self._t += seconds

    def wait(self, event: threading.Event, seconds: float) -> bool:
        self.sleep(seconds)
        return event.is_set()

    def advance(self, seconds: float) -> None:
        self._t += float(seconds)


@dataclass
class _TableWatch:
    """Per-dataset watch state carried across cycles."""
    token: str | None = None   # head token as of the last clean drain
    pending: bool = False      # bounded/failed drain left commits behind
    failures: int = 0          # consecutive probe/drain errors
    not_before: float = 0.0    # backoff window end (clock time)
    lag: int = 0               # commits still behind after the last cycle
                               # (feeds the fleet's commit-rate estimator)


@dataclass
class DaemonCycleReport:
    """What one watch -> replan -> drain cycle saw and did."""
    cycle: int
    started_at: float = 0.0        # clock time at cycle start
    elapsed_s: float = 0.0
    probed: int = 0                # tables head-probed this cycle
    quiet: int = 0                 # probed, head unchanged, no backlog
    changed: int = 0               # probed, head moved or backlog pending
    backed_off: int = 0            # skipped: inside a backoff window
    table_errors: int = 0          # probe/plan/drain blew up for the table
    units_planned: int = 0
    units_drained: int = 0         # FULL / INCREMENTAL executed ok
    units_skipped: int = 0
    units_errored: int = 0
    commits_applied: int = 0       # source commits applied across all units
    units_deferred: int = 0        # fleet drain budget pushed these to the
                                   # next cycle (maxUnitsPerCycle)
    workers: int = 1               # fleet width this cycle (1 = serial path)
    steals: int = 0                # cells drained off their home shard
    breaker_open: int = 0          # skipped: circuit breaker open (cooling)
    quarantined: int = 0           # skipped: quarantined (given up on)
    checkpoint_gen: int | None = None  # generation saved this cycle
    catalog_generation: int | None = None  # catalog generation this cycle's
                                           # group publish landed (or the
                                           # already-converged generation)
    health: dict = field(default_factory=dict)  # path -> breaker state
    lag: dict = field(default_factory=dict)   # (dataset, target) -> commits
                                              # still behind after the cycle
    failures: list = field(default_factory=list)  # (dataset, phase, error)
    storage_ops: dict | None = None    # cycle's storage-request census delta
                                       # (instrumented filesystems only)
    results: list = field(default_factory=list)   # SyncResults, plan order

    @property
    def idle(self) -> bool:
        """Nothing to do and nothing in the way: every table quiet.

        An open (cooling-down) breaker counts as "in the way" — the table
        will be retried — but a *quarantined* table does not: the daemon
        has given up on it, and it must not keep an idle-bounded run
        alive.
        """
        return (self.changed == 0 and self.backed_off == 0
                and self.table_errors == 0 and self.breaker_open == 0)

    @property
    def total_lag(self) -> int:
        return sum(self.lag.values())

    def summary(self) -> str:
        return (f"cycle {self.cycle}: probed={self.probed} "
                f"quiet={self.quiet} changed={self.changed} "
                f"backed_off={self.backed_off} "
                f"drained={self.units_drained} skipped={self.units_skipped} "
                f"errored={self.units_errored + self.table_errors} "
                f"commits={self.commits_applied} lag={self.total_lag}")


class SyncDaemon:
    """Always-on continuous sync over one :class:`SyncConfig`.

    Holds the shared filesystem, metadata cache, telemetry and per-table
    watch state across cycles; ``run_cycle()`` is one deterministic watch ->
    replan -> drain pass, ``run()`` loops cycles on the injected clock.
    Thread-safety: ``run()`` / ``run_cycle()`` belong to one driving thread;
    ``stop()`` may be called from any thread.
    """

    def __init__(self, config: SyncConfig, fs=None,
                 telemetry: Telemetry | None = None,
                 cache: MetadataCache | None = None, *,
                 max_workers: int | None = None, clock=None,
                 fleet: FleetOptions | None = None, read_plane=None):
        self.config = config
        self.telemetry = telemetry or Telemetry()
        self.clock = clock or SystemClock()
        # thread the injected clock into the retry layer's backoff sleeper,
        # so a ManualClock daemon never wall-sleeps even through storage
        # retries (a passed-in fs keeps whatever sleeper it was built with)
        self.fs = fs or config.build_fs(self.telemetry,
                                        sleep=self.clock.sleep)
        self.cache = cache or MetadataCache(self.fs)
        self.max_workers = max_workers
        self.opts = config.daemon
        self.fleet_opts = fleet if fleet is not None else config.fleet
        self._fleet: SyncFleet | None = None
        # the fleet path engages for real width OR a drain budget (the
        # budget/scheduler only exist there — a budgeted single worker
        # still needs the urgency ordering to pick WHICH cells drain)
        if self.fleet_opts.workers > 1 or \
                self.fleet_opts.max_units_per_cycle is not None:
            if self.fleet_opts.mode == "process":
                self._check_process_mode_fs()
            self._fleet = SyncFleet(self.fleet_opts, self.clock)
        # optional co-located SnapshotServer (serve/read_plane.py): every
        # clean drain publishes the fresh source head token post-drain,
        # while the cycle hint is still installed — co-located readers
        # then skip even the per-TTL-window head probe
        self.read_plane = read_plane
        self.cycles_run = 0
        self._rng = random.Random(self.opts.seed)
        self._watch: dict[str, _TableWatch] = {}
        self._stop_event = threading.Event()
        self._drain_on_stop = False
        self.health: HealthTracker | None = \
            HealthTracker(config.health) if config.health.enabled else None
        # optional catalog (lst/catalog/): every cycle's cleanly drained
        # tables publish as ONE atomic group generation post-drain, so
        # cross-table readers pinning through the catalog never observe a
        # half-published cycle
        self.catalog: Catalog | None = None
        self._group_stage: set[str] = set()
        if config.catalog.enabled and (config.catalog.path or config.datasets):
            cat_path = config.catalog.path
            if cat_path is None:
                ds0 = config.datasets[0].path
                parent = ds0.rsplit("/", 1)[0] if "/" in ds0 else ds0
                cat_path = join(parent, "_xtable", "catalog")
            self.catalog = Catalog(self.fs, cat_path,
                                   retain=config.catalog.retain)
            # stage every configured dataset up front: a restarted daemon
            # re-resolves each table once and converges (identical pointers
            # publish nothing) instead of leaving gaps
            self._group_stage = {ds.path for ds in config.datasets}
        self._ckpt: CheckpointStore | None = None
        self._cycles_since_save = 0
        self.restored_from_checkpoint = False
        if config.checkpoint.enabled and \
                (config.checkpoint.path or config.datasets):
            path = config.checkpoint.path or \
                join(config.datasets[0].path, "_xtable", "checkpoint")
            self._ckpt = CheckpointStore(self.fs, path,
                                         retain=config.checkpoint.retain)
            self._restore_checkpoint()

    def _check_process_mode_fs(self) -> None:
        """Process mode ships picklable units to child processes that
        reopen the store themselves — only a plain local filesystem
        satisfies that (simulated/instrumented layers live in this
        process's memory and would silently not be exercised)."""
        from repro_torch.lst.storage.local import LocalFS
        base = self.fs
        while hasattr(base, "inner"):
            base = base.inner
        if not isinstance(base, LocalFS):
            raise ValueError("fleet mode 'process' requires local storage "
                             "(file:// or plain paths)")

    # ------------------------------------------------------------------ api
    def close(self) -> None:
        """Release fleet worker pools (no-op for the serial path)."""
        if self._fleet is not None:
            self._fleet.close()

    def run_cycle(self) -> DaemonCycleReport:
        """One watch -> replan -> drain pass over every dataset."""
        if self._fleet is not None:
            return self._run_fleet_cycle()
        rep = DaemonCycleReport(cycle=self.cycles_run,
                                started_at=self.clock.now())
        t0 = time.perf_counter()
        stats_fn = getattr(self.fs, "stats", None)
        before = stats_fn().as_dict() if stats_fn is not None else None

        for ds in self.config.datasets:
            w = self._watch.setdefault(ds.path, _TableWatch())
            if self.clock.now() < w.not_before:
                rep.backed_off += 1
                continue
            if not self._admit(ds, rep):
                continue
            try:
                # the probe doubles as this cycle's head hint: the planner's
                # current_commit() and the index refresh consume the SAME
                # one-request probe instead of re-reading the source head
                token = self._probe(ds)
            except Exception as e:
                self._table_failed(ds, w, rep, "probe", e)
                self._end_cycle(ds)
                continue
            rep.probed += 1
            if token == w.token and not w.pending:
                rep.quiet += 1
                self._end_cycle(ds)
                continue
            rep.changed += 1
            try:
                self._drain(ds, w, token, rep)
            except Exception as e:
                self._table_failed(ds, w, rep, "drain", e)
            finally:
                # the hint is scoped to THIS cycle: a lingering hint would
                # pin refresh() to a past head forever
                self._end_cycle(ds)

        self._finish_cycle(rep)
        if before is not None:
            after = stats_fn().as_dict()
            rep.storage_ops = {k: after[k] - before[k] for k in after}
        rep.elapsed_s = time.perf_counter() - t0
        self.cycles_run += 1
        self.telemetry.bump("daemon.cycles")
        self.telemetry.record("daemon", "*", "cycle", rep.summary(),
                              rep.elapsed_s)
        return rep

    def run(self, cycles: int | None = None,
            max_cycles_idle: int | None = None) -> list[DaemonCycleReport]:
        """Loop cycles on the injected clock until a bound or a stop.

        ``cycles`` caps the number of cycles this call runs (None = no
        cap); ``max_cycles_idle`` (default: the config's ``maxCyclesIdle``)
        stops after that many *consecutive* idle cycles.  A pending
        ``stop()`` wins over everything — including an in-progress poll
        sleep, which it wakes immediately; ``stop(drain=True)`` keeps
        cycling — skipping poll sleeps while progress is being made —
        until no table has a pending backlog.

        Returns the per-cycle reports; an *unbounded* run retains only the
        newest ``MAX_RETAINED_REPORTS`` so service-mode memory stays flat.
        """
        if max_cycles_idle is None:
            max_cycles_idle = self.opts.max_cycles_idle
        poll_s = self.opts.poll_interval_ms / 1000.0
        reports: list[DaemonCycleReport] = []
        ran = 0
        idle = 0
        while True:
            if self._stop_event.is_set() and \
                    not (self._drain_on_stop and self._pending()):
                break
            rep = self.run_cycle()
            reports.append(rep)
            ran += 1
            if cycles is None and len(reports) > MAX_RETAINED_REPORTS:
                # unbounded service mode must not grow memory with uptime:
                # keep a rolling window of the newest reports
                del reports[0]
            idle = idle + 1 if rep.idle else 0
            if cycles is not None and ran >= cycles:
                break
            if max_cycles_idle is not None and idle >= max_cycles_idle:
                break
            if self._stop_event.is_set():
                if rep.units_drained == 0:
                    # only backed-off stragglers remain: wait the poll out
                    # instead of hot-looping on their closed windows (a
                    # plain clock sleep — the stop-event wait would return
                    # instantly here, the stop is already set)
                    self.clock.sleep(poll_s)
                continue
            if self._wait(poll_s):
                continue        # stop() during the sleep: re-check at the top
        return reports

    def stop(self, *, drain: bool = False) -> None:
        """Request a graceful stop (thread-safe).

        The in-flight cycle always completes — every target commit is an
        atomic put-if-absent, so stopping between cycles never leaves torn
        state.  With ``drain=True`` the daemon keeps cycling until no table
        has a pending backlog before it stops (repeating ``stop(drain=True)``
        is idempotent); a plain ``stop()`` downgrades a draining stop to an
        immediate one — the escape hatch when a pending table fails
        persistently.  A stop during the poll sleep wakes it immediately.
        """
        if self._stop_event.is_set():
            self._drain_on_stop = self._drain_on_stop and drain
        else:
            self._drain_on_stop = drain
            self._stop_event.set()

    def lag(self) -> dict:
        """Last known (dataset path) -> pending flag, for monitoring."""
        return {p: w.pending for p, w in self._watch.items()}

    def _wait(self, seconds: float) -> bool:
        """Poll-interval wait, woken early by ``stop()``; returns whether a
        stop is pending.  Falls back to a plain sleep for injected clocks
        without a ``wait``."""
        wait = getattr(self.clock, "wait", None)
        if wait is not None:
            return bool(wait(self._stop_event, seconds))
        self.clock.sleep(seconds)
        return self._stop_event.is_set()

    # ---------------------------------------------------------- fleet cycle
    def _run_fleet_cycle(self) -> DaemonCycleReport:
        """One watch -> replan -> drain pass across the sharded fleet.

        Same contract as the serial cycle — one head probe per eligible
        table, per-table error isolation and backoff, ``maxCommitsPerSync``
        backpressure — but the probe and plan phases fan out over the
        worker pool (they are RTT-bound), and the planned cells drain
        through per-worker shard queues: most-urgent-first per the
        lag-aware scheduler, with idle workers stealing from the longest
        queue, and ``maxUnitsPerCycle`` bounding the whole pass.
        """
        fleet = self._fleet
        rep = DaemonCycleReport(cycle=self.cycles_run,
                                started_at=self.clock.now(),
                                workers=fleet.opts.workers)
        t0 = time.perf_counter()
        stats_fn = getattr(self.fs, "stats", None)
        before = stats_fn().as_dict() if stats_fn is not None else None

        now = self.clock.now()
        eligible = []
        for ds in self.config.datasets:
            w = self._watch.setdefault(ds.path, _TableWatch())
            if now < w.not_before:
                rep.backed_off += 1
                continue
            if not self._admit(ds, rep):
                continue
            eligible.append((ds, w))

        # every eligible table's cycle hint must be cleared exactly once,
        # whatever phase it leaves the cycle in
        ended: set[str] = set()

        def end(ds: DatasetConfig) -> None:
            if ds.path not in ended:
                ended.add(ds.path)
                self._end_cycle(ds)

        try:
            # watch: still exactly ONE head request per table, overlapped
            # across the pool instead of serialized
            probes = fleet.map(lambda e: self._probe(e[0]), eligible)
            changed = []
            for (ds, w), (token, err) in zip(eligible, probes):
                if err is not None:
                    self._table_failed(ds, w, rep, "probe", err)
                    end(ds)
                    continue
                rep.probed += 1
                if token == w.token and not w.pending:
                    rep.quiet += 1
                    end(ds)
                    continue
                rep.changed += 1
                changed.append((ds, w, token))

            # replan: per-dataset planning (source tail refresh + target
            # state reads) is RTT-bound too — same pool
            planned = fleet.map(lambda c: self._plan_ds(c[0], c[2]), changed)
            work = []
            writers: dict = {}
            for (ds, w, token), (res, err) in zip(changed, planned):
                if err is not None:
                    self._table_failed(ds, w, rep, "plan", err)
                    end(ds)
                    continue
                units, ds_writers = res
                writers.update(ds_writers)
                rep.units_planned += len(units)
                # feed the commit-rate EWMA with how far the head moved
                # past what was already pending after the last cycle
                backlog = max((u.backlog for u in units), default=0)
                fleet.scheduler.observe(ds.path, max(0, backlog - w.lag),
                                        now)
                work.append((ds, w, token, units))

            # drain: one global urgency ordering across datasets, sharded
            # over the worker queues, stolen when a shard stalls
            all_units = fleet.scheduler.order(
                [u for _, _, _, units in work for u in units], now)
            executor = SyncExecutor(
                self.fs, self.cache, self.telemetry, 1,
                manifest_compaction_threshold=self.config
                .manifest_compaction_threshold)
            executor.prepare(writers)
            outcome = fleet.drain(all_units, executor,
                                  budget=fleet.opts.max_units_per_cycle)
            rep.steals = outcome.steals
            by_unit = {id(u): r
                       for u, r in zip(all_units, outcome.results)}
            for ds, w, token, units in work:
                self._account(ds, w, token, units,
                              [by_unit.get(id(u)) for u in units], rep)
                end(ds)
        finally:
            for ds, _w in eligible:
                end(ds)

        self._finish_cycle(rep)
        if before is not None:
            after = stats_fn().as_dict()
            rep.storage_ops = {k: after[k] - before[k] for k in after}
        rep.elapsed_s = time.perf_counter() - t0
        self.cycles_run += 1
        self.telemetry.bump("daemon.cycles")
        self.telemetry.record("daemon", "*", "cycle", rep.summary(),
                              rep.elapsed_s)
        return rep

    def _plan_ds(self, ds: DatasetConfig, token: str) -> tuple:
        """Plan one dataset's cells (fleet plan phase); returns the units
        plus the planner's opened target writers for the executor."""
        planner = SyncPlanner(self.config, self.fs, self.cache,
                              self.telemetry)
        units = planner.plan_dataset(ds, head_hint=token)
        return units, planner.writers

    # ------------------------------------------------------------- internals
    def _admit(self, ds: DatasetConfig, rep: DaemonCycleReport) -> bool:
        """Circuit-breaker gate: may this table take a cycle?  An open
        breaker skips the table entirely (not even a probe); a quarantined
        one is parked until its (long) cooldown."""
        if self.health is None:
            return True
        verdict = self.health.admit(ds.path, self.clock.now())
        if verdict == ALLOW:
            return True
        if verdict == PARKED:
            rep.quarantined += 1
        else:
            rep.breaker_open += 1
        self.telemetry.bump("daemon.breaker_skips")
        return False

    def _finish_cycle(self, rep: DaemonCycleReport) -> None:
        """End-of-cycle bookkeeping shared by the serial and fleet paths:
        publish breaker states into the report, group-publish the cycle's
        drained tables into the catalog, and save a checkpoint generation
        if this cycle changed anything.  The catalog publish runs BEFORE
        the checkpoint so the new generation rides the same save."""
        if self.health is not None:
            rep.health = self.health.states()
        self._publish_catalog(rep)
        self._maybe_checkpoint(rep)

    def _maybe_checkpoint(self, rep: DaemonCycleReport) -> None:
        if self._ckpt is None or (rep.changed == 0 and rep.table_errors == 0):
            return              # nothing enabled / an idle cycle: no save
        self._cycles_since_save += 1
        if self._cycles_since_save < self.config.checkpoint.interval_cycles:
            return
        try:
            rep.checkpoint_gen = self._ckpt.save(self._capture_checkpoint())
            self._cycles_since_save = 0
            self.telemetry.bump("daemon.checkpoints")
        except Exception as e:
            # the checkpoint is advisory: a failed save costs the NEXT
            # restart some warmth, never this daemon its cycle
            self.telemetry.bump("daemon.checkpoint_errors")
            self.telemetry.record("daemon", "*", "checkpoint_error", str(e))

    def _publish_catalog(self, rep: DaemonCycleReport) -> None:
        """Group-publish every staged cleanly-drained table as ONE catalog
        generation (the atomic multi-table registration of ISSUE/ROADMAP
        open item 2).

        Staged tables that are still pending, backed off, or mid-failure
        stay staged — they join a later cycle's group instead of splitting
        this one.  Tables whose resolved pointer matches the published one
        are dropped from the stage without minting a generation (a
        restarted daemon converges instead of publishing per boot).  The
        publish is best-effort, exactly like the checkpoint: a failure
        keeps the stage intact for the next cycle and never fails the
        cycle that drained the data.
        """
        if self.catalog is None or not self._group_stage:
            return
        try:
            current = self.catalog.snapshot()
        except Exception as e:
            self.telemetry.bump("daemon.catalog_errors")
            self.telemetry.record("daemon", "*", "catalog_error", str(e))
            return
        staged: list[tuple[str, TablePointer]] = []
        for ds in self.config.datasets:
            if ds.path not in self._group_stage:
                continue
            w = self._watch.get(ds.path)
            if w is None or w.token is None or w.pending or \
                    self.clock.now() < w.not_before:
                continue        # not cleanly drained yet / mid-backoff:
                                # stays staged for a later cycle's group
            try:
                staged.append((ds.path, self._pointer_for(ds, w)))
            except Exception as e:
                self.telemetry.bump("daemon.catalog_errors")
                self.telemetry.record(ds.name, "*", "catalog_error",
                                      f"resolve: {e}")
        if not staged:
            return
        fresh = [(p, ptr) for p, ptr in staged
                 if current.tables.get(ptr.name) != ptr]
        if not fresh:
            self._group_stage.difference_update(p for p, _ in staged)
            rep.catalog_generation = current.generation
            return
        try:
            with self.catalog.transaction() as txn:
                for _path, ptr in fresh:
                    txn.put(ptr)
                txn.add_to_group(self.config.catalog.group,
                                 *[ptr.name for _path, ptr in fresh])
            snap = txn.published
        except Exception as e:
            self.telemetry.bump("daemon.catalog_errors")
            self.telemetry.record("daemon", "*", "catalog_error",
                                  f"publish: {e}")
            return
        self._group_stage.difference_update(p for p, _ in staged)
        rep.catalog_generation = snap.generation
        self.telemetry.bump("daemon.catalog_publishes")
        self.telemetry.record("daemon", "*", "catalog_publish",
                              f"generation {snap.generation}: "
                              f"{sorted(ptr.name for _p, ptr in fresh)}")

    def _pointer_for(self, ds: DatasetConfig, w: _TableWatch) -> TablePointer:
        """Resolve one cleanly drained dataset's catalog pointer.

        The source view is free: after a clean drain the index was
        refreshed against exactly ``w.token``, so ``refresh_to`` is a
        lock-only no-op and ``pinned_state`` answers from the memo.
        Target views (``publishViews: all``) each cost one O(1) head
        probe plus at most a tail-only refresh — the drain itself just
        wrote those heads, so the replay tail is the cycle's own commits.
        """
        src = self.config.source_format
        views: dict[str, ViewRef] = {}
        idx = self.cache.index(src, ds.path)
        try:
            idx.refresh_to(w.token)
            head, _state = idx.pinned_state()
        finally:
            idx.end_cycle()
        views[src] = ViewRef(token=w.token, commit=head)
        if self.config.catalog.publish_views == "all":
            for fmt in self.config.target_formats:
                if fmt == src:
                    continue
                tidx = self.cache.index(fmt, ds.path)
                try:
                    token = tidx.probe()
                    tidx.refresh_to(token)
                    thead, _tstate = tidx.pinned_state()
                finally:
                    tidx.end_cycle()
                views[fmt] = ViewRef(token=token, commit=thead)
        return TablePointer(name=ds.name, base_path=ds.path,
                            source_format=src, views=views)

    def _capture_checkpoint(self) -> dict:
        """One JSON-ready document of everything a restart can reuse."""
        ck = self.config.checkpoint
        tables = {}
        for path, w in self._watch.items():
            idx = self.cache.peek(self.config.source_format, path)
            seed = None
            if idx is not None:
                # the seed window must reach back past the laggiest
                # target's token, or the restarted planner would go FULL
                seed = idx.snapshot_seed(w.lag + ck.min_window)
            tables[path] = {
                "watch": {"token": w.token, "pending": w.pending,
                          "lag": w.lag},
                "seed": encode_seed(seed)}
        payload = {"sourceFormat": self.config.source_format,
                   "savedAt": self.clock.now(), "tables": tables}
        if self._fleet is not None:
            payload["rates"] = self._fleet.scheduler.rates.export()
        if self.health is not None:
            payload["health"] = self.health.snapshot()
        if self.catalog is not None:
            payload["catalog"] = {
                "generation": self.catalog.last_generation}
        return payload

    def _restore_checkpoint(self) -> None:
        """Seed watch state, index tails, rates and breaker states from the
        newest readable checkpoint generation.  Everything restored here is
        advisory — the first cycle's head probes re-verify against the live
        tables, and a head the seeded index cannot splice to forces a
        scoped rebuild of just that table."""
        try:
            loaded = self._ckpt.load()
        except Exception:
            loaded = None
        if not loaded:
            return
        _gen, payload = loaded
        if payload.get("sourceFormat") != self.config.source_format:
            return      # some other pipeline's checkpoint prefix
        try:
            tables = payload.get("tables", {})
            for ds in self.config.datasets:
                t = tables.get(ds.path)
                if not t:
                    continue
                wd = t.get("watch", {})
                # backoff windows are clock-relative and the clock restarted
                # with the process: resume with a clean slate (the breaker
                # snapshot below carries the memory of repeated failures)
                self._watch[ds.path] = _TableWatch(
                    token=wd.get("token"),
                    pending=bool(wd.get("pending", False)),
                    lag=int(wd.get("lag", 0)))
                seed = decode_seed(t.get("seed"))
                if seed is not None:
                    self.cache.index(self.config.source_format,
                                     ds.path).restore_seed(*seed)
            if self._fleet is not None:
                self._fleet.scheduler.rates.restore(payload.get("rates"))
            if self.health is not None:
                self.health.restore(payload.get("health"))
            cat = payload.get("catalog")
            if cat and self.catalog is not None:
                # advisory generation cursor — never trusted over a LIST
                self.catalog.seed_generation(int(cat.get("generation", 0)))
            self.restored_from_checkpoint = True
            self.telemetry.bump("daemon.checkpoint_restores")
        except Exception as e:
            # a malformed checkpoint must degrade to a cold start, never
            # block the daemon
            self._watch.clear()
            self.telemetry.bump("daemon.checkpoint_errors")
            self.telemetry.record("daemon", "*", "checkpoint_restore_error",
                                  str(e))

    def _probe(self, ds: DatasetConfig) -> str:
        """One cheap head probe, memoized on the index as the cycle's head
        hint; the index handle is cached across cycles."""
        return self.cache.index(self.config.source_format, ds.path).probe()

    def _end_cycle(self, ds: DatasetConfig) -> None:
        idx = self.cache.peek(self.config.source_format, ds.path)
        if idx is not None:
            idx.end_cycle()

    def _drain(self, ds: DatasetConfig, w: _TableWatch, token: str,
               rep: DaemonCycleReport) -> None:
        """Replan this dataset's cells and drain the actionable units."""
        planner = SyncPlanner(self.config, self.fs, self.cache,
                              self.telemetry)
        units = planner.plan_dataset(ds, head_hint=token)
        rep.units_planned += len(units)
        executor = SyncExecutor(
            self.fs, self.cache, self.telemetry, self.max_workers,
            manifest_compaction_threshold=self.config
            .manifest_compaction_threshold)
        results = executor.execute(SyncPlan(units, planner.writers))
        self._account(ds, w, token, units, results, rep)

    def _account(self, ds: DatasetConfig, w: _TableWatch, token: str,
                 units: list, results: list,
                 rep: DaemonCycleReport) -> None:
        """Fold one dataset's unit results into the report and its watch
        state (shared by the serial and fleet paths).  A ``None`` result
        is a cell the fleet's drain budget deferred: it counts as lag and
        keeps the dataset pending, but is no error."""
        pending = False
        failed = False
        deferred = False
        lag_left = 0
        for u, r in zip(units, results):
            key = (u.dataset, u.target_format)
            if r is None:
                rep.units_deferred += 1
                deferred = True
                if u.backlog:
                    rep.lag[key] = u.backlog
                    lag_left = max(lag_left, u.backlog)
                continue
            rep.results.append(r)
            if r.mode == SKIP:
                rep.units_skipped += 1
            elif r.mode == ERROR:
                rep.units_errored += 1
                failed = True
                if u.backlog:
                    rep.lag[key] = u.backlog
                    lag_left = max(lag_left, u.backlog)
            else:
                rep.units_drained += 1
                rep.commits_applied += r.commits_synced
                left = max(0, u.backlog - r.commits_synced)
                if left:
                    rep.lag[key] = left
                    pending = True
                    lag_left = max(lag_left, left)

        if failed:
            # keep the old token so the next eligible cycle replans, and
            # back the table off — target errors here include storage
            # retry exhaustion, and hot-looping on them helps nobody
            w.pending = True
            self._backoff(ds, w, rep)
            if self.health is not None:
                self.health.record_failure(ds.path, self.clock.now())
        else:
            w.token = token
            w.pending = pending or deferred
            w.failures = 0
            w.not_before = 0.0
            if self.health is not None:
                self.health.record_success(ds.path)
            if self.read_plane is not None:
                # the cycle hint is still installed here (_end_cycle runs
                # after accounting), so the eager snapshot build inside
                # publish() reuses this cycle's replay at zero requests
                self.read_plane.publish(ds.path,
                                        self.config.source_format, token)
            if self.catalog is not None:
                # stage for this cycle's post-drain group publish; the
                # whole cycle's stage becomes visible as ONE catalog
                # generation in _publish_catalog
                self._group_stage.add(ds.path)
        w.lag = lag_left

    def _table_failed(self, ds: DatasetConfig, w: _TableWatch,
                      rep: DaemonCycleReport, phase: str,
                      err: Exception) -> None:
        rep.table_errors += 1
        rep.failures.append((ds.name, phase, str(err)))
        self.telemetry.bump("daemon.table_errors")
        self.telemetry.record(ds.name, "*", "error", f"{phase}: {err}")
        self._backoff(ds, w, rep)
        if self.health is not None:
            self.health.record_failure(ds.path, self.clock.now())

    def _backoff(self, ds: DatasetConfig, w: _TableWatch,
                 rep: DaemonCycleReport) -> None:
        w.failures += 1
        delay = self.opts.backoff_delay_s(w.failures)
        delay *= 1.0 + self.opts.backoff_jitter * self._rng.random()
        w.not_before = self.clock.now() + delay
        self.telemetry.bump("daemon.backoffs")
        self.telemetry.record(ds.name, "*", "backoff",
                              f"attempt {w.failures}, retry in {delay:.3f}s")

    def _pending(self) -> bool:
        """A quarantined table's backlog must not hold ``stop(drain=True)``
        hostage — the daemon has explicitly given up on it."""
        return any(w.pending and not (self.health is not None and
                                      self.health.is_quarantined(p))
                   for p, w in self._watch.items())


def run_daemon(config: SyncConfig, fs=None,
               telemetry: Telemetry | None = None, *,
               cycles: int | None = None,
               max_cycles_idle: int | None = None,
               max_workers: int | None = None,
               cache: MetadataCache | None = None,
               clock=None,
               fleet: FleetOptions | None = None) -> list[DaemonCycleReport]:
    """Run a continuous-sync daemon to completion (the CLI / service body).

    ``cycles`` bounds the run for scripts and tests; an unbounded call
    relies on the config's ``maxCyclesIdle`` or an external ``stop()``.
    ``fleet`` overrides the config's ``fleet:`` block (workers > 1 runs
    the sharded fleet cycle path).  Returns the per-cycle reports.
    """
    daemon = SyncDaemon(config, fs, telemetry, cache,
                        max_workers=max_workers, clock=clock, fleet=fleet)
    try:
        return daemon.run(cycles=cycles, max_cycles_idle=max_cycles_idle)
    finally:
        daemon.close()
