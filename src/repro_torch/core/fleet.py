# Copy of repro/core/fleet.py; the port imports nothing of repro.
# One difference: process mode's pool starts its children with ``spawn``,
# not the platform's ``fork`` (forking a process that runs torch's thread
# pools, or has initialised CUDA, can deadlock the child).
"""Sharded sync fleet: N workers over the (dataset, target) cell space.

The paper's pitch — translation overhead stays negligible as tables and
targets multiply — breaks down for a single-threaded daemon long before
the 10k-table regime the comparative studies describe: one slow table's
round trips serialize behind every other table's.  This module shards the
work across a fleet of workers while keeping every correctness property of
the serial daemon (one probe per table per cycle, shared metadata cache,
per-table backoff, atomic per-cell commits):

* **Sharding** — each planned (dataset, target) cell is assigned to a
  worker's queue by ``shardStrategy``: ``hash`` (stable across cycles, so
  a table's cells keep hitting the same worker and its warm caches) or
  ``round_robin`` (uniform spread for pathological key distributions).
* **Work stealing** — a worker whose queue runs dry pops cells from the
  *tail* of the longest remaining queue (the victim keeps its most urgent
  head), so one shard stalling on a throttled store never idles the rest
  of the fleet.  ``stealThresholdMs`` sets the minimum time a cell must
  have sat queued before it may be stolen.
* **Lag-aware scheduling** — cells drain most-urgent-first, where
  urgency = backlog-in-commits x observed commit rate.  The rate is a
  per-table exponentially-weighted moving average (half-life
  ``urgencyHalfLifeMs``) fed each cycle from what the daemon's watch
  phase observed, so under a ``maxUnitsPerCycle`` drain budget or
  ``maxCommitsPerSync`` backpressure the hot tables are always first in
  line and cold tables cannot crowd them out.
* **Worker modes** — ``thread`` (the default) overlaps the round trips
  that dominate incremental drains against object stores; ``process``
  routes FULL bootstraps through a process pool for CPU-bound translation
  work.  Process mode requires a plain local filesystem (the work items
  must be picklable and the store reachable from a child process), and
  only pays off when cores are actually available — on a small container
  the thread mode measures faster, which is why it is the default.

The daemon (``core/daemon.py``) owns watch state, backoff and reporting;
:class:`SyncFleet` owns the pool, the queues, the scheduler, and the drain
loop.  Determinism: the scheduler's ordering is a pure function of the
observed trace with lexicographic tie-breaks, and the idle-cycle cost pin
(exactly one probe request per table) holds for every worker count.
"""

from __future__ import annotations

import threading
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from repro_torch.core.config import FleetOptions
from repro_torch.core.plan import FULL, SyncUnit

__all__ = ["FleetOptions", "CommitRateEstimator", "LagAwareScheduler",
           "SyncFleet", "FleetDrainOutcome"]

# floor for the per-table commit rate inside the urgency product: a table
# never observed committing still ranks by backlog instead of dropping to
# urgency 0 (which would starve FULL bootstraps under a drain budget)
MIN_RATE = 1e-6
# guards the instantaneous-rate division when two observations land on the
# same clock reading (ManualClock cycles that never advance time)
_MIN_DT_S = 1e-3


class CommitRateEstimator:
    """Per-table EWMA of the observed commit rate, in commits/second.

    ``observe(key, commits, now)`` is called once per cycle per table with
    the number of *new* source commits the watch phase saw.  The previous
    estimate decays by ``0.5 ** (dt / half_life)`` and the instantaneous
    rate ``commits / dt`` is blended in with the complementary weight, so
    a table that goes quiet halves its rate every half-life and a burst
    moves the estimate quickly without erasing history.  Thread-safe;
    deterministic given the same observation trace.
    """

    def __init__(self, half_life_s: float):
        if half_life_s <= 0:
            raise ValueError("half_life_s must be > 0")
        self.half_life_s = float(half_life_s)
        self._lock = threading.Lock()
        self._rates: dict[str, tuple[float, float]] = {}  # key -> (rate, t)

    def observe(self, key: str, commits: int, now: float) -> float:
        with self._lock:
            prev = self._rates.get(key)
            if prev is None:
                # first sighting: this cycle's burst is the best guess
                rate = float(commits)
            else:
                rate0, last = prev
                dt = max(now - last, _MIN_DT_S)
                decay = 0.5 ** (dt / self.half_life_s)
                rate = decay * rate0 + (1.0 - decay) * (commits / dt)
            self._rates[key] = (rate, now)
            return rate

    def rate(self, key: str, now: float) -> float:
        """Current estimate, decayed to ``now`` (0.0 for unseen tables)."""
        with self._lock:
            prev = self._rates.get(key)
            if prev is None:
                return 0.0
            rate, last = prev
            return rate * 0.5 ** (max(now - last, 0.0) / self.half_life_s)

    # ----------------------------------------------------- checkpointing
    def export(self) -> dict:
        """JSON-ready ``key -> [rate, observed_at]`` for the daemon
        checkpoint (observed_at is injected-clock time)."""
        with self._lock:
            return {k: [r, t] for k, (r, t) in self._rates.items()}

    def restore(self, rates: dict) -> None:
        """Install checkpointed rates for tables not yet observed live
        (fresh observations always win over the checkpoint)."""
        with self._lock:
            for k, v in (rates or {}).items():
                self._rates.setdefault(k, (float(v[0]), float(v[1])))


class LagAwareScheduler:
    """Orders sync cells most-urgent-first: urgency = backlog x commit rate.

    ``backlog`` is the unit's full commits-behind count (pre
    ``maxCommitsPerSync`` cap; FULL bootstraps count as 1), and the rate
    comes from :class:`CommitRateEstimator` floored at ``MIN_RATE`` so
    never-observed tables still rank by backlog.  Ties break
    lexicographically on (dataset, target) — the ordering is a pure
    function of the observed trace.  ``kind="fifo"`` preserves plan order
    (the comparison arm benchmarks and tests use).
    """

    def __init__(self, half_life_s: float, kind: str = "urgency"):
        if kind not in ("urgency", "fifo"):
            raise ValueError("scheduler kind must be 'urgency' or 'fifo'")
        self.kind = kind
        self.rates = CommitRateEstimator(half_life_s)

    def observe(self, key: str, commits: int, now: float) -> float:
        return self.rates.observe(key, commits, now)

    def urgency(self, unit: SyncUnit, now: float) -> float:
        backlog = max(unit.backlog, len(unit.commits),
                      1 if unit.mode == FULL else 0)
        rate = max(self.rates.rate(unit.base_path, now), MIN_RATE)
        return backlog * rate

    def order(self, units: list, now: float) -> list:
        if self.kind == "fifo":
            return list(units)
        return sorted(units, key=lambda u: (-self.urgency(u, now),
                                            u.dataset, u.target_format))


def _process_run_unit(payload):
    """Process-pool entry point: run one picklable FULL unit against a
    fresh local filesystem in the child (no shared cache — the CPU-bound
    translation is the point, and a FULL bootstrap replays the source
    once either way)."""
    unit, mct = payload
    from repro_torch.core.executor import SyncExecutor
    from repro_torch.lst.storage.local import LocalFS
    ex = SyncExecutor(LocalFS(), max_workers=1,
                      manifest_compaction_threshold=mct)
    return ex.execute_unit(unit)


@dataclass
class _Cell:
    """One queued (dataset, target) drain item."""
    idx: int                 # position in the ordered dispatch list
    unit: SyncUnit
    enqueued_at: float = 0.0


class _ShardQueue:
    """One worker's deque: the owner pops the urgent head, thieves take
    the tail (the victim keeps its hottest work)."""

    def __init__(self):
        self._dq: deque = deque()
        self._lock = threading.Lock()

    def push(self, cell: _Cell) -> None:
        with self._lock:
            self._dq.append(cell)

    def pop_front(self):
        with self._lock:
            return self._dq.popleft() if self._dq else None

    def steal_back(self, now: float, threshold_s: float):
        with self._lock:
            if not self._dq:
                return None
            if now - self._dq[-1].enqueued_at < threshold_s:
                return None
            return self._dq.pop()

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def drain_remaining(self) -> list:
        with self._lock:
            left, self._dq = list(self._dq), deque()
            return left


@dataclass
class FleetDrainOutcome:
    """What one fleet drain pass did."""
    results: list = field(default_factory=list)   # SyncResult | None, aligned
                                                  # with the ordered units
    deferred: list = field(default_factory=list)  # units the budget cut
    steals: int = 0                               # cells run off-shard


class SyncFleet:
    """The worker pool + shard queues + scheduler behind a fleet daemon.

    Owns no watch state: the daemon hands it callables to fan out (probe /
    plan phases) and ordered units to drain; the fleet returns aligned
    results.  The pool is lazy and persistent across cycles; ``close()``
    (also called by ``__del__``) releases it.
    """

    def __init__(self, opts: FleetOptions, clock):
        self.opts = opts
        self.clock = clock
        self.scheduler = LagAwareScheduler(
            opts.urgency_half_life_ms / 1000.0, opts.scheduler)
        self.steals = 0              # lifetime, across cycles
        self._rr = 0                 # round-robin cursor
        self._lock = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None
        self._procs = None           # lazy ProcessPoolExecutor (process mode)

    # ---------------------------------------------------------------- pool
    def _thread_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.opts.workers,
                    thread_name_prefix="xtable-fleet")
            return self._pool

    def _process_pool(self):
        with self._lock:
            if self._procs is None:
                import multiprocessing
                from concurrent.futures import ProcessPoolExecutor
                self._procs = ProcessPoolExecutor(
                    max_workers=self.opts.workers,
                    mp_context=multiprocessing.get_context("spawn"))
            return self._procs

    def close(self) -> None:
        """Release the worker pools (recreated lazily on next use)."""
        with self._lock:
            pool, self._pool = self._pool, None
            procs, self._procs = self._procs, None
        if pool is not None:
            pool.shutdown(wait=True)
        if procs is not None:
            procs.shutdown(wait=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ----------------------------------------------------------- fan-out
    def map(self, fn, items: list) -> list:
        """Run ``fn`` over ``items`` on the pool; returns aligned
        ``(result, error)`` pairs — a failing item never poisons the rest
        (the per-table error isolation the serial daemon has)."""
        def one(item):
            try:
                return fn(item), None
            except Exception as e:
                return None, e
        if not items:
            return []
        if self.opts.workers <= 1 or len(items) == 1:
            return [one(it) for it in items]
        return list(self._thread_pool().map(one, items))

    # ---------------------------------------------------------- sharding
    def shard_of(self, unit: SyncUnit) -> int:
        if self.opts.shard_strategy == "round_robin":
            with self._lock:
                shard = self._rr % self.opts.workers
                self._rr += 1
            return shard
        key = f"{unit.base_path}\x00{unit.target_format}".encode()
        return zlib.crc32(key) % self.opts.workers  # stable across processes

    # ------------------------------------------------------------- drain
    def drain(self, units: list, executor, *,
              budget: int | None = None) -> FleetDrainOutcome:
        """Drain ordered ``units`` through the shard queues.

        ``units`` must already be in scheduler order (most urgent first);
        each worker consumes its own queue front-to-back, stealing from
        the longest other queue when dry.  ``budget`` caps how many cells
        the whole fleet executes this pass (``maxUnitsPerCycle``); cells
        past the budget come back in ``deferred``.  Results align with
        ``units`` (``None`` for deferred cells).
        """
        out = FleetDrainOutcome(results=[None] * len(units))
        if not units:
            return out
        if budget is None:
            budget = len(units)
        # the budget decides WHICH cells run by the *global* ordering,
        # not just how many: trim to the top-``budget`` before sharding,
        # so an urgent cell can never lose its slot to a colder one that
        # happened to land on a less-contended shard queue
        run_units = units[:budget]
        out.deferred.extend(units[budget:])
        queues = [_ShardQueue() for _ in range(self.opts.workers)]
        now = self.clock.now()
        for i, u in enumerate(run_units):
            queues[self.shard_of(u)].push(_Cell(i, u, enqueued_at=now))

        state_lock = threading.Lock()
        state = {"budget": budget, "steals": 0}

        def take_budget() -> bool:
            with state_lock:
                if state["budget"] <= 0:
                    return False
                state["budget"] -= 1
                return True

        def give_back() -> None:
            with state_lock:
                state["budget"] += 1

        def steal(wid: int):
            # richest victim first; the tail steal leaves the victim its
            # most urgent head
            order = sorted((q for i, q in enumerate(queues) if i != wid),
                           key=len, reverse=True)
            thr = self.opts.steal_threshold_ms / 1000.0
            for q in order:
                cell = q.steal_back(self.clock.now(), thr)
                if cell is not None:
                    return cell
            return None

        def worker(wid: int) -> None:
            while True:
                if not take_budget():
                    return
                cell = queues[wid].pop_front()
                stolen = False
                if cell is None:
                    cell = steal(wid)
                    stolen = cell is not None
                if cell is None:
                    give_back()
                    return
                if stolen:
                    with state_lock:
                        state["steals"] += 1
                out.results[cell.idx] = self._run_cell(cell.unit, executor)

        if self.opts.workers <= 1:
            worker(0)
        else:
            futs = [self._thread_pool().submit(worker, wid)
                    for wid in range(self.opts.workers)]
            for f in futs:
                f.result()

        out.steals = state["steals"]
        with self._lock:
            self.steals += out.steals
        for q in queues:
            out.deferred.extend(c.unit for c in q.drain_remaining())
        return out

    def _run_cell(self, unit: SyncUnit, executor):
        """Execute one cell: FULL bootstraps route through the process
        pool in ``process`` mode (CPU-bound translation on real cores),
        everything else runs on this worker thread.  A broken child pool
        falls back to in-thread execution rather than failing the cell."""
        if self.opts.mode == "process" and unit.mode == FULL:
            try:
                return self._process_pool().submit(
                    _process_run_unit,
                    (unit, executor.manifest_compaction_threshold)).result()
            except Exception:
                pass  # pool died / not picklable: the thread path is correct
        return executor.execute_unit(unit)
