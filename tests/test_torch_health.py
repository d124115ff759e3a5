"""Port copy of ``tests/test_health.py``: the same tests and bounds,
run against ``repro_torch`` (only the import prefix differs).

Per-table circuit breakers: state machine + daemon integration.

The breaker sits ON TOP of exponential backoff: backoff spaces retries out,
the breaker *gives up* — ``closed -> open`` after ``failureThreshold``
consecutive failures, one ``half_open`` trial per elapsed cooldown,
``quarantined`` after ``quarantineAfter`` consecutive opens.  Everything
here runs on a manual clock, so every window is crossed by advancing time,
never by sleeping through it.

The daemon half pins the contracts that matter operationally: an open
breaker spends ZERO storage requests on the sick table while healthy
neighbors keep syncing, a recovered table walks back to ``closed`` through
a half-open trial, a quarantined backlog cannot hold ``stop(drain=True)``
hostage, and breaker states ride the durable checkpoint across restarts.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import ManualClock, SyncConfig, SyncDaemon  # noqa: E402
from repro_torch.core.health import (ALLOW, CLOSED, COOLING, HALF_OPEN, OPEN,  # noqa: E402
                                     PARKED, HealthTracker)
from repro_torch.core.config import HealthOptions  # noqa: E402
from repro_torch.lst import LakeTable  # noqa: E402
from repro_torch.lst.schema import Field, PartitionSpec, Schema  # noqa: E402
from repro_torch.lst.storage import MemoryFS, TransientStorageError, layer_fs  # noqa: E402

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


def _cfg(bases, **kw):
    d = {"sourceFormat": "DELTA", "targetFormats": ["ICEBERG"],
         "datasets": [{"tableBasePath": b} for b in bases],
         "backoff": {"baseDelayMs": 1.0, "maxDelayMs": 2.0, "jitter": 0.0}}
    d.update(kw)
    return SyncConfig.from_dict(d)


def _opts(**kw):
    base = dict(failure_threshold=2, open_cooldown_ms=10_000.0,
                half_open_probes=1, quarantine_after=3,
                quarantine_cooldown_ms=100_000.0)
    base.update(kw)
    return HealthOptions(**base)


class _SickPrefixFS:
    """Delegating FS that fails requests under ``prefix`` while ``sick``.

    ``writes_only=True`` scopes the failure to puts (the probe still sees
    the table; the drain dies), which is how a table gets a *pending*
    backlog and a tripped breaker at the same time.
    """

    def __init__(self, inner, prefix, *, writes_only=False):
        self.inner = inner
        self.prefix = prefix
        self.writes_only = writes_only
        self.sick = True
        self.attempts = 0           # requests that reached the sick prefix

    def _check(self, path, *, write):
        if path.startswith(self.prefix):
            self.attempts += 1
            if self.sick and (write or not self.writes_only):
                raise TransientStorageError(f"503 injected ({path})")

    def read_bytes(self, path):
        self._check(path, write=False)
        return self.inner.read_bytes(path)

    def read_bytes_range(self, path, offset, length):
        self._check(path, write=False)
        return self.inner.read_bytes_range(path, offset, length)

    def read_many(self, paths):
        return [self.read_bytes(p) for p in paths]

    def read_many_ranges(self, requests):
        return [self.read_bytes_range(p, o, n) for p, o, n in requests]

    def write_bytes(self, path, data, *, overwrite=False):
        self._check(path, write=True)
        self.inner.write_bytes(path, data, overwrite=overwrite)

    def write_many(self, items, *, overwrite=False):
        for p, data in items:
            self.write_bytes(p, data, overwrite=overwrite)

    def exists(self, path):
        self._check(path, write=False)
        return self.inner.exists(path)

    def list_dir(self, path):
        self._check(path, write=False)
        return self.inner.list_dir(path)

    def size(self, path):
        self._check(path, write=False)
        return self.inner.size(path)

    def delete(self, path):
        self._check(path, write=True)
        self.inner.delete(path)


# ---------------------------------------------------------- state machine
def test_breaker_opens_after_consecutive_failures():
    h = HealthTracker(_opts())
    assert h.admit("t", 0.0) == ALLOW
    h.record_failure("t", 0.0)
    assert h.state("t") == CLOSED           # 1 < threshold
    h.record_failure("t", 1.0)
    assert h.state("t") == OPEN
    assert h.admit("t", 2.0) == COOLING     # cooldown (10s) still running
    assert h.admit("t", 11.5) == ALLOW      # elapsed: half-open trial
    assert h.state("t") == HALF_OPEN


def test_success_resets_the_consecutive_counter():
    h = HealthTracker(_opts())
    for t in range(10):                     # fail, heal, fail, heal ...
        h.record_failure("t", float(t))
        h.record_success("t")
    assert h.state("t") == CLOSED


def test_half_open_success_closes_failure_reopens():
    h = HealthTracker(_opts())
    h.record_failure("t", 0.0)
    h.record_failure("t", 0.0)              # -> open
    assert h.admit("t", 11.0) == ALLOW      # trial 1
    h.record_failure("t", 11.0)             # ONE failure in half_open trips
    assert h.state("t") == OPEN
    assert h.admit("t", 22.0) == ALLOW      # trial 2
    h.record_success("t")
    assert h.state("t") == CLOSED
    # a full close resets the opens streak: the quarantine counter restarts
    assert h.admit("t", 23.0) == ALLOW


def test_quarantine_after_consecutive_opens_then_parole():
    h = HealthTracker(_opts(quarantine_after=2, open_cooldown_ms=1000.0,
                            quarantine_cooldown_ms=50_000.0))
    now = 0.0
    h.record_failure("t", now)
    h.record_failure("t", now)              # open #1
    now += 2.0
    assert h.admit("t", now) == ALLOW       # half-open trial
    h.record_failure("t", now)              # open #2 -> quarantined
    assert h.is_quarantined("t")
    assert h.admit("t", now + 10.0) == PARKED    # 50s cooldown: parked
    now += 51.0
    assert h.admit("t", now) == ALLOW       # parole trial
    h.record_success("t")
    assert h.state("t") == CLOSED


def test_states_reports_only_interesting_tables():
    h = HealthTracker(_opts())
    h.admit("quiet", 0.0)                   # seen but never failed
    h.record_failure("sick", 0.0)
    h.record_failure("sick", 0.0)
    assert h.states() == {"sick": OPEN}


def test_snapshot_restore_round_trip_live_wins():
    h = HealthTracker(_opts())
    h.record_failure("a", 0.0)
    h.record_failure("a", 0.0)
    snap = h.snapshot()

    h2 = HealthTracker(_opts())
    h2.record_success("a")                  # live observation before restore
    h2.restore(snap)
    assert h2.state("a") == CLOSED          # live wins over the checkpoint

    h3 = HealthTracker(_opts())
    h3.restore(snap)
    assert h3.state("a") == OPEN
    assert h3.snapshot()["a"] == snap["a"]


# ----------------------------------------------------------------- daemon
def test_open_breaker_spends_zero_requests_and_spares_neighbors():
    raw = MemoryFS()
    good = _mk_table(raw, "bkt/good", n_commits=2)
    _mk_table(raw, "bkt/bad", n_commits=2)
    sick = _SickPrefixFS(raw, "bkt/bad")
    clock = ManualClock()
    cfg = _cfg(["bkt/good", "bkt/bad"],
               health={"failureThreshold": 2, "openCooldownMs": 1e9})
    d = SyncDaemon(cfg, layer_fs(sick), clock=clock)

    rep = d.run_cycle()                     # bad probe fails (1/2)
    assert rep.table_errors == 1 and rep.units_drained == 1
    clock.advance(1.0)                      # past backoff, cooldown forever
    rep = d.run_cycle()                     # bad probe fails (2/2) -> OPEN
    assert rep.table_errors == 1 and d.health.state("bkt/bad") == OPEN

    frozen = sick.attempts
    _append(good, 2)
    for _ in range(3):
        clock.advance(1.0)
        rep = d.run_cycle()
        assert rep.breaker_open == 1        # skipped, not even probed
        assert rep.table_errors == 0
        assert rep.health == {"bkt/bad": OPEN}
        assert not rep.idle                 # an open breaker is not "done"
    assert sick.attempts == frozen          # ZERO requests while open
    got = LakeTable.open(raw, "bkt/good", "iceberg").read_all()
    assert sorted(got["k"].tolist()) == sorted(good.read_all()["k"].tolist())


def test_breaker_recovers_through_half_open_trial():
    raw = MemoryFS()
    _mk_table(raw, "bkt/t", n_commits=2)
    sick = _SickPrefixFS(raw, "bkt/t")
    clock = ManualClock()
    cfg = _cfg(["bkt/t"], health={"failureThreshold": 1,
                                  "openCooldownMs": 5000.0,
                                  "quarantineAfter": 100})
    d = SyncDaemon(cfg, layer_fs(sick), clock=clock)
    d.run_cycle()                           # fails -> open immediately
    assert d.health.state("bkt/t") == OPEN

    clock.advance(1.0)
    assert d.run_cycle().breaker_open == 1  # still cooling

    sick.sick = False                       # the table heals
    clock.advance(6.0)                      # cooldown elapsed
    rep = d.run_cycle()                     # half-open trial: full sync
    assert rep.units_drained == 1 and rep.breaker_open == 0
    assert d.health.state("bkt/t") == CLOSED


def test_quarantined_backlog_does_not_hold_drain_stop_hostage():
    raw = MemoryFS()
    good = _mk_table(raw, "bkt/good", n_commits=2)
    _mk_table(raw, "bkt/bad", n_commits=2)
    # probe sees bkt/bad fine; every write dies -> pending backlog + trips
    sick = _SickPrefixFS(raw, "bkt/bad", writes_only=True)
    clock = ManualClock()
    cfg = _cfg(["bkt/good", "bkt/bad"],
               health={"failureThreshold": 1, "quarantineAfter": 1,
                       "quarantineCooldownMs": 1e12})
    d = SyncDaemon(cfg, layer_fs(sick), clock=clock)
    rep = d.run_cycle()
    assert rep.units_errored == 1 and d.health.is_quarantined("bkt/bad")
    assert d.lag()["bkt/bad"] is True       # the backlog is real ...
    assert not d._pending()                 # ... but quarantine waives it

    clock.advance(1.0)
    assert d.run_cycle().quarantined == 1   # parked, not probed

    d.stop(drain=True)                      # must NOT spin on bkt/bad
    reports = d.run()
    assert len(reports) <= 2
    got = LakeTable.open(raw, "bkt/good", "iceberg").read_all()
    assert sorted(got["k"].tolist()) == sorted(good.read_all()["k"].tolist())


def test_breaker_state_rides_the_checkpoint_across_restarts():
    raw = MemoryFS()
    _mk_table(raw, "bkt/good", n_commits=2)
    _mk_table(raw, "bkt/bad", n_commits=2)
    sick = _SickPrefixFS(raw, "bkt/bad", writes_only=True)
    clock = ManualClock()
    cfg = _cfg(["bkt/good", "bkt/bad"],
               health={"failureThreshold": 1, "quarantineAfter": 1,
                       "quarantineCooldownMs": 1e12},
               checkpoint={"enabled": True})
    d1 = SyncDaemon(cfg, layer_fs(sick), clock=clock)
    rep = d1.run_cycle()
    assert d1.health.is_quarantined("bkt/bad") and rep.checkpoint_gen == 1

    # restart: the quarantine survives — the fleet does NOT hammer a table
    # it had already given up on before the crash
    d2 = SyncDaemon(cfg, layer_fs(sick), clock=ManualClock())
    assert d2.restored_from_checkpoint
    assert d2.health.is_quarantined("bkt/bad")
    frozen = sick.attempts
    rep = d2.run_cycle()
    assert rep.quarantined == 1 and sick.attempts == frozen


def test_health_disabled_keeps_probing_forever():
    raw = MemoryFS()
    _mk_table(raw, "bkt/bad", n_commits=2)
    sick = _SickPrefixFS(raw, "bkt/bad")
    clock = ManualClock()
    cfg = _cfg(["bkt/bad"], health={"enabled": False,
                                    "failureThreshold": 1})
    d = SyncDaemon(cfg, layer_fs(sick), clock=clock)
    assert d.health is None
    for _ in range(4):
        rep = d.run_cycle()
        clock.advance(60.0)
    assert rep.breaker_open == 0 and rep.table_errors == 1   # still trying


def test_health_options_parse_and_validate():
    cfg = _cfg(["bkt/t"], health={
        "failureThreshold": 7, "openCooldownMs": 1234.0,
        "halfOpenProbes": 2, "quarantineAfter": 9,
        "quarantineCooldownMs": 7e6})
    h = cfg.health
    assert h.enabled and h.failure_threshold == 7
    assert h.open_cooldown_ms == 1234.0 and h.half_open_probes == 2
    assert h.quarantine_after == 9 and h.quarantine_cooldown_ms == 7e6
    assert _cfg(["bkt/t"]).health.enabled       # breaker is on by default
    with pytest.raises(ValueError):
        _cfg(["bkt/t"], health={"failureThreshold": 0})
