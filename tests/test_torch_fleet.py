"""Port copy of ``tests/test_fleet.py``: the same tests and bounds,
run against ``repro_torch`` (only the import prefix differs).

``test_fleet_scales_and_urgency_beats_fifo_at_1k_tables`` is not
copied: it is a wall-clock scaling bound that the reference's own
copy misses under a loaded 6-worker test run (ROADMAP C-e).

Sharded sync fleet: scheduler, sharding, stealing, daemon integration.

What this file pins (all on a fake clock — no test ever wall-sleeps,
except the event-gated stall test, which is timeout-guarded):

* the ``fleet:`` config block parses its camelCase keys and validates its
  knobs;
* the commit-rate EWMA is a deterministic function of the observation
  trace (first sighting, decay blend, quiet-table halving, decayed reads);
* the urgency scheduler orders cells backlog x rate with lexicographic
  tie-breaks, FULL bootstraps rank by rate alone, and FIFO preserves plan
  order;
* hash sharding is stable (same cell -> same shard, across fleets);
  round-robin cycles uniformly;
* an idle fleet cycle costs exactly ONE head probe per table at ANY
  worker count — the serial daemon's cost pin survives the fan-out;
* a fleet cycle reaches the same end state as the serial daemon (same
  commits applied, targets at the same head);
* ``maxUnitsPerCycle`` defers the surplus (reported, counted as lag) and
  the deferred tables drain on later cycles;
* a worker stalled on a throttled store gets its queued cells stolen by
  the rest of the fleet instead of idling it;
* under a drain budget the urgency scheduler keeps a hot table fresh
  while FIFO lets cold tables crowd it out.
"""

import pytest

torch = pytest.importorskip("torch")

import threading  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.core import (FleetOptions, LagAwareScheduler, ManualClock,  # noqa: E402
                              SyncConfig, SyncDaemon)
from repro_torch.core.fleet import CommitRateEstimator, SyncFleet, _ShardQueue, _Cell  # noqa: E402
from repro_torch.core.plan import FULL, INCREMENTAL, SyncUnit  # noqa: E402
from repro_torch.core.targets import make_target  # noqa: E402
from repro_torch.lst import LakeTable  # noqa: E402
from repro_torch.lst.schema import Field, PartitionSpec, Schema  # noqa: E402
from repro_torch.lst.storage import MemoryFS, layer_fs  # noqa: E402
from repro_torch.lst.table import FORMATS  # noqa: E402

torch.set_num_threads(2)

SCHEMA = Schema([Field("k", "int64"), Field("part", "string")])


def _mk_table(fs, base, fmt="delta", n_commits=3):
    t = LakeTable.create(fs, base, SCHEMA, fmt, PartitionSpec(["part"]),
                         {"delta.checkpointInterval": "100000"})
    for i in range(n_commits):
        t.append({"k": np.array([i, i + 100], np.int64),
                  "part": np.array([f"p{i % 2}", "p0"])})
    return t


def _append(t, k=1):
    for i in range(k):
        t.append({"k": np.array([7 + i], np.int64),
                  "part": np.array(["p0"])})


def _cfg(bases, targets=("iceberg",), **kw):
    d = {"sourceFormat": "DELTA",
         "targetFormats": [t.upper() for t in targets],
         "datasets": [{"tableBasePath": b} for b in bases]}
    d.update(kw)
    return SyncConfig.from_dict(d)


def _unit(ds, base, backlog=0, mode=INCREMENTAL, target="iceberg"):
    commits = [str(i) for i in range(backlog)] if mode == INCREMENTAL else []
    return SyncUnit(dataset=ds, base_path=base, source_format="delta",
                    target_format=target, mode=mode, source_head="h",
                    commits=commits, backlog=backlog)


# ------------------------------------------------------------------- config
def test_fleet_config_block_parses_camelcase_keys():
    cfg = SyncConfig.from_dict({
        "sourceFormat": "DELTA", "targetFormats": ["HUDI"],
        "datasets": [{"tableBasePath": "bkt/t"}],
        "fleet": {"workers": 4, "shardStrategy": "roundRobin",
                  "stealThresholdMs": 250, "urgencyHalfLifeMs": 30000,
                  "scheduler": "fifo", "maxUnitsPerCycle": 100,
                  "mode": "thread"}})
    f = cfg.fleet
    assert f.workers == 4
    assert f.shard_strategy == "round_robin"     # camelCase normalized
    assert f.steal_threshold_ms == 250.0
    assert f.urgency_half_life_ms == 30000.0
    assert f.scheduler == "fifo"
    assert f.max_units_per_cycle == 100
    # defaults: serial, hash-sharded, urgency-ordered, unbounded, threads
    d = SyncConfig.from_dict({
        "sourceFormat": "DELTA", "targetFormats": ["HUDI"],
        "datasets": [{"tableBasePath": "bkt/t"}]}).fleet
    assert (d.workers, d.shard_strategy, d.scheduler, d.mode) == \
        (1, "hash", "urgency", "thread")
    assert d.max_units_per_cycle is None


@pytest.mark.parametrize("bad", [
    {"workers": 0}, {"workers": -2}, {"shardStrategy": "random"},
    {"stealThresholdMs": -1}, {"urgencyHalfLifeMs": 0},
    {"scheduler": "lifo"}, {"maxUnitsPerCycle": 0}, {"mode": "fiber"}])
def test_fleet_config_rejects_bad_knobs(bad):
    with pytest.raises(ValueError):
        SyncConfig.from_dict({
            "sourceFormat": "DELTA", "targetFormats": ["HUDI"],
            "datasets": [{"tableBasePath": "bkt/t"}], "fleet": bad})


def test_process_mode_requires_local_storage():
    raw = MemoryFS()
    _mk_table(raw, "bkt/t")
    with pytest.raises(ValueError, match="local storage"):
        SyncDaemon(_cfg(["bkt/t"]), layer_fs(raw), clock=ManualClock(),
                   fleet=FleetOptions(workers=2, mode="process"))


# ---------------------------------------------------------------- estimator
def test_ewma_first_sighting_and_decay_blend():
    est = CommitRateEstimator(half_life_s=10.0)
    assert est.rate("t", now=0.0) == 0.0           # unseen
    assert est.observe("t", 4, now=0.0) == 4.0     # first sighting: the burst
    # 10s later (one half-life): old rate halves, instantaneous 2/10 blends
    r = est.observe("t", 2, now=10.0)
    assert r == pytest.approx(0.5 * 4.0 + 0.5 * (2 / 10.0))
    # a decayed *read* halves again after another half-life, observing nothing
    assert est.rate("t", now=20.0) == pytest.approx(r / 2)


def test_ewma_is_deterministic_and_guards_zero_dt():
    trace = [("a", 3, 0.0), ("b", 1, 0.0), ("a", 0, 5.0), ("a", 7, 5.0)]

    def run():
        est = CommitRateEstimator(half_life_s=60.0)
        return [est.observe(k, c, t) for k, c, t in trace]

    assert run() == run()                          # pure function of the trace
    # two observations on the same ManualClock reading must not divide by 0
    est = CommitRateEstimator(half_life_s=60.0)
    est.observe("t", 1, now=0.0)
    assert np.isfinite(est.observe("t", 1, now=0.0))


# ---------------------------------------------------------------- scheduler
def test_urgency_orders_backlog_times_rate_with_stable_ties():
    sched = LagAwareScheduler(half_life_s=60.0, kind="urgency")
    now = 0.0
    sched.observe("bkt/hot", 8, now)      # rate 8
    sched.observe("bkt/warm", 2, now)     # rate 2
    units = [_unit("cold", "bkt/cold", backlog=9),      # unseen: MIN_RATE
             _unit("warm", "bkt/warm", backlog=4),      # urgency 8
             _unit("hot", "bkt/hot", backlog=2),        # urgency 16
             _unit("boot", "bkt/boot", mode=FULL)]      # backlog floor 1
    got = [u.dataset for u in sched.order(units, now)]
    assert got == ["hot", "warm", "cold", "boot"]

    # ties break lexicographically on (dataset, target): deterministic
    tied = [_unit("b", "bkt/x", backlog=3), _unit("a", "bkt/x", backlog=3)]
    assert [u.dataset for u in sched.order(tied, now)] == ["a", "b"]
    assert [u.dataset for u in sched.order(list(reversed(tied)), now)] == \
        ["a", "b"]


def test_fifo_scheduler_preserves_plan_order():
    sched = LagAwareScheduler(half_life_s=60.0, kind="fifo")
    sched.observe("bkt/hot", 50, 0.0)
    units = [_unit("cold", "bkt/cold", backlog=1),
             _unit("hot", "bkt/hot", backlog=9)]
    assert [u.dataset for u in sched.order(units, 0.0)] == ["cold", "hot"]


# ----------------------------------------------------------------- sharding
def test_hash_sharding_is_stable_and_spreads():
    fleet = SyncFleet(FleetOptions(workers=4), ManualClock())
    units = [_unit(f"t{i}", f"bkt/t{i}", backlog=1) for i in range(64)]
    shards = [fleet.shard_of(u) for u in units]
    assert shards == [fleet.shard_of(u) for u in units]      # stable
    fleet2 = SyncFleet(FleetOptions(workers=4), ManualClock())
    assert shards == [fleet2.shard_of(u) for u in units]     # across fleets
    assert len(set(shards)) == 4                             # all shards used
    # a table's two targets may land apart, but the same cell never moves
    u_ice = _unit("t0", "bkt/t0", backlog=1, target="iceberg")
    assert fleet.shard_of(u_ice) == fleet2.shard_of(u_ice)
    fleet.close(), fleet2.close()


def test_round_robin_sharding_cycles():
    fleet = SyncFleet(FleetOptions(workers=3, shard_strategy="round_robin"),
                      ManualClock())
    units = [_unit(f"t{i}", f"bkt/t{i}", backlog=1) for i in range(7)]
    assert [fleet.shard_of(u) for u in units] == [0, 1, 2, 0, 1, 2, 0]
    fleet.close()


def test_steal_threshold_protects_fresh_cells():
    q = _ShardQueue()
    q.push(_Cell(0, _unit("a", "bkt/a"), enqueued_at=100.0))
    assert q.steal_back(now=100.05, threshold_s=0.25) is None   # too fresh
    assert q.steal_back(now=100.30, threshold_s=0.25) is not None


# --------------------------------------------------------- daemon: cost pins
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_fleet_idle_cycle_costs_one_probe_per_table(workers):
    """The serial daemon's idle-cost pin survives the fan-out: a quiet
    fleet cycle is exactly one head probe per table — no planning reads,
    no target reads — at any worker count."""
    raw = MemoryFS()
    bases = [f"bkt/t{i}" for i in range(6)]
    for b in bases:
        _mk_table(raw, b)
    fs = layer_fs(raw)
    daemon = SyncDaemon(_cfg(bases), fs, clock=ManualClock(),
                        fleet=FleetOptions(workers=workers))
    try:
        rep0 = daemon.run_cycle()                  # bootstrap: 6 FULL syncs
        assert rep0.units_drained == 6 and rep0.workers == workers
        for _ in range(3):
            rep = daemon.run_cycle()
            assert rep.idle and rep.quiet == 6 and rep.probed == 6
            ops = rep.storage_ops
            assert ops["list"] == 6                # one log-tail LIST each
            assert ops["get"] == 0 and ops["head"] == 0
            assert ops["put"] == 0 and ops["requests"] == 6
    finally:
        daemon.close()


def test_fleet_cycle_matches_serial_end_state():
    """Same workload through the serial daemon and a 3-worker fleet: same
    units drained, same commits applied, and every target lands on the
    same source head."""
    def run(workers):
        raw = MemoryFS()
        bases = [f"bkt/t{i}" for i in range(5)]
        tables = [_mk_table(raw, b, n_commits=2) for b in bases]
        daemon = SyncDaemon(_cfg(bases, targets=("iceberg", "hudi")),
                            layer_fs(raw), clock=ManualClock(),
                            fleet=FleetOptions(workers=workers))
        try:
            rep0 = daemon.run_cycle()
            for i, t in enumerate(tables):
                _append(t, i + 1)                  # uneven backlogs
            rep1 = daemon.run_cycle()
        finally:
            daemon.close()
        heads = {b: make_target("iceberg", raw, b).get_sync_token()
                 for b in bases}
        src_heads = {b: FORMATS["delta"].open(raw, b).head() for b in bases}
        assert heads == src_heads                  # every target caught up
        return (rep0.units_drained, rep1.units_drained,
                rep1.commits_applied, rep1.total_lag, heads)

    assert run(1) == run(3)


def test_fleet_error_isolation_backs_off_one_table():
    """A table whose probe 503s is backed off without stalling the rest —
    the serial daemon's isolation contract, through the fan-out path."""
    from repro_torch.lst.storage import TransientStorageError

    class _Flaky:
        def __init__(self, inner, match):
            self.inner, self.match, self.armed = inner, match, False

        def __getattr__(self, name):
            fn = getattr(self.inner, name)
            if not callable(fn):
                return fn

            def wrapped(*args, **kw):
                if self.armed and args and isinstance(args[0], str) \
                        and self.match in args[0]:
                    raise TransientStorageError(f"503 ({args[0]})")
                return fn(*args, **kw)
            return wrapped

    raw = MemoryFS()
    t0, t1 = _mk_table(raw, "bkt/t0"), _mk_table(raw, "bkt/t1")
    flaky = _Flaky(raw, "bkt/t0")
    daemon = SyncDaemon(_cfg(["bkt/t0", "bkt/t1"]), layer_fs(flaky),
                        clock=ManualClock(), fleet=FleetOptions(workers=2))
    try:
        daemon.run_cycle()
        flaky.armed = True
        _append(t0), _append(t1)
        rep = daemon.run_cycle()
        assert rep.table_errors == 1
        assert rep.units_drained == 1 and rep.commits_applied == 1
        rep = daemon.run_cycle()                   # t0 now inside its window
        assert rep.backed_off == 1 and rep.probed == 1
    finally:
        daemon.close()


# -------------------------------------------------------------- drain budget
def test_max_units_per_cycle_defers_and_later_cycles_finish():
    raw = MemoryFS()
    bases = [f"bkt/t{i}" for i in range(6)]
    tables = [_mk_table(raw, b) for b in bases]
    daemon = SyncDaemon(_cfg(bases), layer_fs(raw), clock=ManualClock(),
                        fleet=FleetOptions(workers=2, max_units_per_cycle=4))
    try:
        rep0 = daemon.run_cycle()                  # bootstrap is budgeted too
        assert rep0.units_drained == 4 and rep0.units_deferred == 2
        rep1 = daemon.run_cycle()                  # deferred tables stay pending
        assert rep1.units_drained == 2 and rep1.units_deferred == 0
        assert daemon.run_cycle().idle

        for t in tables:
            _append(t, 2)
        rep = daemon.run_cycle()
        assert rep.units_drained == 4 and rep.units_deferred == 2
        assert rep.commits_applied == 8
        assert rep.total_lag == 4                  # 2 deferred x 2 commits
        rep = daemon.run_cycle()
        assert rep.units_drained == 2 and rep.commits_applied == 4
        assert rep.total_lag == 0
    finally:
        daemon.close()
    for b in bases:                                # nothing lost to deferral
        assert make_target("iceberg", raw, b).get_sync_token() == \
            FORMATS["delta"].open(raw, b).head()


# ------------------------------------------------------------- work stealing
def test_stalled_worker_gets_its_queue_stolen():
    """Worker 0 stalls on its first cell (event-gated, as a throttled
    store would); worker 1 finishes its own shard and steals the rest of
    worker 0's queue instead of idling.  The stall releases only after
    every other cell completed — so without stealing this would deadlock
    (timeout-guarded)."""
    opts = FleetOptions(workers=2, shard_strategy="round_robin")
    fleet = SyncFleet(opts, ManualClock())
    units = [_unit(f"t{i}", f"bkt/t{i}", backlog=1) for i in range(6)]
    # round-robin: evens -> shard 0, odds -> shard 1; unit 0 is the stall
    stall = threading.Event()
    done = []
    lock = threading.Lock()

    class _Executor:
        def execute_unit(self, unit):
            if unit.dataset == "t0":
                assert stall.wait(timeout=30.0), "stall never released"
            with lock:
                done.append(unit.dataset)
                if len(done) == len(units) - 1:
                    stall.set()                    # everyone else finished
            return unit.dataset

    try:
        out = fleet.drain(units, _Executor())
    finally:
        fleet.close()
    assert out.results == [u.dataset for u in units]   # aligned, complete
    assert out.deferred == []
    # worker 1's own shard was 3 cells; it stole worker 0's queued tail
    # (t4, t2 — and t0 itself if worker 0 was slow to start) while t0's
    # stall blocked its home shard
    assert out.steals >= 2
    assert done[-1] == "t0"


# ---------------------------------------------------- urgency vs FIFO (pin)
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("kind,hot_lag_stays_zero", [("urgency", True),
                                                     ("fifo", False)])
def test_urgency_keeps_hot_table_fresh_under_budget(kind, hot_lag_stays_zero,
                                                    workers):
    """8 tables, drain budget 2/cycle, one hot table (4 commits/round,
    listed LAST in the config so FIFO cannot luck into it).  The urgency
    scheduler drains the hot table every cycle; FIFO spends the budget on
    the cold tables in plan order and the hot table starves.  Holds at
    any worker count: the budget trims to the top cells of the *global*
    ordering before sharding, so which cells drain is a pure function of
    the scheduler — never of thread timing or shard placement."""
    raw = MemoryFS()
    cold_bases = [f"bkt/c{i}" for i in range(7)]
    cold = [_mk_table(raw, b) for b in cold_bases]
    hot = _mk_table(raw, "bkt/hot")
    bases = cold_bases + ["bkt/hot"]
    clock = ManualClock()
    daemon = SyncDaemon(_cfg(bases), layer_fs(raw), clock=clock,
                        fleet=FleetOptions(workers=workers, scheduler=kind,
                                           max_units_per_cycle=2))
    try:
        for _ in range(8):                          # budgeted bootstrap
            if daemon.run_cycle().idle:
                break
        else:
            pytest.fail("bootstrap never went idle")
        hot_lag = 0
        for _ in range(3):
            for t in cold:
                _append(t, 1)
            _append(hot, 4)
            rep = daemon.run_cycle()
            assert rep.units_drained == 2
            hot_lag = rep.lag.get(("hot", "iceberg"), 0)
            clock.advance(1.0)
    finally:
        daemon.close()
    if hot_lag_stays_zero:
        assert hot_lag == 0                         # drained every cycle
    else:
        assert hot_lag >= 8                         # starved by cold tables


# ------------------------------------------------------------- process mode
@pytest.mark.slow
def test_process_mode_drains_full_bootstraps(tmp_path):
    """FULL bootstraps route through the process pool on local storage and
    land the same result; incremental cells stay on the worker threads."""
    import tempfile

    from repro_torch.lst import LocalFS

    fs = LocalFS()
    bases = []
    for i in range(2):
        base = tempfile.mkdtemp(dir=tmp_path) + "/t"
        _mk_table(fs, base)
        bases.append(base)
    daemon = SyncDaemon(_cfg(bases), fs, clock=ManualClock(),
                        fleet=FleetOptions(workers=2, mode="process"))
    try:
        rep = daemon.run_cycle()
        assert rep.units_drained == 2
        assert all(r.mode == "FULL" for r in rep.results)
        for b in bases:
            assert make_target("iceberg", fs, b).get_sync_token() == \
                FORMATS["delta"].open(fs, b).head()
    finally:
        daemon.close()


# --------------------------------------------------------------- drain stop
def test_fleet_stop_drain_finishes_backlog_without_losing_cells():
    """``stop(drain=True)`` under fleet mode: a multi-cycle backlog — capped
    by BOTH maxCommitsPerSync and a drain budget that defers cells every
    cycle — must fully drain before the fleet stops, with no cell lost to
    a deferral raced against the stop."""
    raw = MemoryFS()
    bases = [f"bkt/t{i}" for i in range(3)]
    tables = [_mk_table(raw, b, n_commits=6) for b in bases]
    cfg = _cfg(bases, targets=("iceberg", "hudi"), maxCommitsPerSync=1)
    daemon = SyncDaemon(cfg, layer_fs(raw), clock=ManualClock(),
                        fleet=FleetOptions(workers=3, max_units_per_cycle=2))
    try:
        rep = daemon.run_cycle()             # budget: 2 of 6 cells ran
        assert rep.units_deferred == 4 and daemon._pending()
        daemon.stop(drain=True)
        reports = daemon.run()               # keeps cycling past the stop
        assert len(reports) > 1              # ... for as long as it must
        assert not daemon._pending()
        assert sum(r.units_deferred for r in reports) > 0
    finally:
        daemon.close()
    for b, t in zip(bases, tables):
        head = FORMATS["delta"].open(raw, b).head()
        src = sorted(t.read_all()["k"].tolist())
        for fmt in ("iceberg", "hudi"):
            assert make_target(fmt, raw, b).get_sync_token() == head
            got = LakeTable.open(raw, b, fmt).read_all()
            assert sorted(got["k"].tolist()) == src
