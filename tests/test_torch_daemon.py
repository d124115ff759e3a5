"""Port copy of ``tests/test_daemon.py``: the same tests and bounds,
run against ``repro_torch`` (only the import prefix differs).

Continuous-sync daemon: watch -> replan -> drain cycle behavior.

What this file pins (all on a fake clock — no test ever wall-sleeps):

* ``head_token()`` on every LST handle costs exactly ONE storage request
  and moves iff the table head moved;
* an idle daemon cycle costs exactly one head probe per source table and
  ZERO target reads (counting-FS census);
* a cycle with N new commits costs O(N) source reads — the tail-only index
  refresh — plus O(1) target reads per drained unit;
* an N-commit backlog drains in exactly ceil(N / maxCommitsPerSync)
  cycles under backpressure, with per-cycle lag reported;
* a transient 503 on one table backs that table off (jittered, seeded,
  escalating) without stalling the others, and the table recovers once
  the window passes;
* ``run()`` paces cycles by the configured poll interval on the injected
  clock, stops after ``maxCyclesIdle`` consecutive idle cycles, and
  ``stop(drain=True)`` finishes the backlog before stopping.
"""

import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.core import ManualClock, SyncConfig, SyncDaemon, run_daemon  # noqa: E402
from repro_torch.core.targets import TOKEN_KEY, make_target  # noqa: E402
from repro_torch.lst import LakeTable  # noqa: E402
from repro_torch.lst.schema import Field, PartitionSpec, Schema  # noqa: E402
from repro_torch.lst.storage import MemoryFS, TransientStorageError, layer_fs  # noqa: E402
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


def _cfg(bases, src="delta", targets=("iceberg",), **kw):
    d = {"sourceFormat": src.upper(),
         "targetFormats": [t.upper() for t in targets],
         "datasets": [{"tableBasePath": b} for b in bases]}
    d.update(kw)
    return SyncConfig.from_dict(d)


# --------------------------------------------------------------- head probes
@pytest.mark.parametrize("fmt", ["delta", "iceberg", "hudi"])
def test_head_token_is_one_request_and_tracks_head(fmt):
    raw = MemoryFS()
    t = _mk_table(raw, "bkt/t", fmt, n_commits=2)
    fs = layer_fs(raw)
    handle = FORMATS[fmt].open(fs, "bkt/t")

    before = fs.stats().requests
    tok1 = handle.head_token()
    assert fs.stats().requests - before == 1     # exactly one storage request
    assert tok1 == handle.head_token()           # stable while quiet

    _append(t)                                   # writer moves the head
    tok2 = handle.head_token()
    assert tok2 != tok1


@pytest.mark.parametrize("fmt", ["delta", "iceberg", "hudi"])
def test_head_matches_current_version(fmt):
    raw = MemoryFS()
    _mk_table(raw, "bkt/t", fmt, n_commits=2)
    handle = FORMATS[fmt].open(raw, "bkt/t")
    assert handle.head() == handle.current_version()


# ------------------------------------------------------------- idle steady state
def test_idle_cycle_costs_one_probe_per_table_and_zero_target_reads():
    raw = MemoryFS()
    bases = [f"bkt/t{i}" for i in range(3)]
    for b in bases:
        _mk_table(raw, b)
    fs = layer_fs(raw)
    daemon = SyncDaemon(_cfg(bases, targets=("iceberg", "hudi")), fs,
                        clock=ManualClock())

    rep0 = daemon.run_cycle()                    # bootstrap: 3 x 2 FULL syncs
    assert rep0.units_drained == 6 and not rep0.idle

    for _ in range(3):                           # steady state: quiet tables
        rep = daemon.run_cycle()
        assert rep.idle and rep.quiet == 3 and rep.probed == 3
        ops = rep.storage_ops
        # exactly one head probe per source table (a delta log-tail LIST),
        # and nothing else — no planning reads, no target reads at all
        assert ops["list"] == 3
        assert ops["get"] == 0 and ops["head"] == 0
        assert ops["put"] == 0 and ops["delete"] == 0
        assert ops["requests"] == 3


def test_changed_cycle_costs_o_new_source_reads_o1_target_reads():
    raw = MemoryFS()
    t = _mk_table(raw, "bkt/t")
    fs = layer_fs(raw)
    daemon = SyncDaemon(_cfg(["bkt/t"]), fs, clock=ManualClock())
    daemon.run_cycle()                           # FULL bootstrap
    assert daemon.run_cycle().idle               # cache warm, table quiet

    gets = {}
    for n in (4, 8):
        _append(t, n)
        rep = daemon.run_cycle()
        assert rep.units_drained == 1
        assert rep.results[0].commits_synced == n
        gets[n] = rep.storage_ops["get"]
        # the drained unit itself reads O(1) from the target (txn begin)
        # and nothing from the source (changes served from the warm index)
        assert rep.results[0].storage_ops["get"] <= 6

    # cycle GETs = N tail-refresh source reads + a constant target term:
    # doubling N adds exactly N more reads
    assert gets[8] - gets[4] == 4
    assert gets[4] <= 4 + 8


class _HeadReadCounter:
    """Delegating wrapper counting *head-discovery* requests on one source
    table: log/timeline listings (delta ``_delta_log/``, hudi ``.hoodie/``),
    ``version-hint.text`` reads, and iceberg metadata existence probes —
    the requests a head probe or a head re-read costs, as opposed to
    content reads of log segments / instant payloads / metadata JSONs."""

    def __init__(self, inner, base, fmt):
        self.inner = inner
        self.base = base
        self.fmt = fmt
        self.head_reads = 0

    def list_dir(self, path):
        probe_dir = {"delta": "_delta_log", "iceberg": "metadata",
                     "hudi": ".hoodie"}[self.fmt]
        if path.startswith(self.base) and path.rstrip("/").endswith(probe_dir):
            self.head_reads += 1
        return self.inner.list_dir(path)

    def read_bytes(self, path):
        if path.startswith(self.base) and self.fmt == "iceberg" and \
                path.endswith("version-hint.text"):
            self.head_reads += 1
        return self.inner.read_bytes(path)

    def exists(self, path):
        if path.startswith(self.base) and self.fmt == "iceberg" and \
                ("version-hint" in path or ".metadata.json" in path):
            self.head_reads += 1
        return self.inner.exists(path)

    def __getattr__(self, name):
        return getattr(self.inner, name)


@pytest.mark.parametrize("fmt,targets", [("delta", ("iceberg",)),
                                         ("iceberg", ("delta",)),
                                         ("hudi", ("delta",))])
def test_changed_cycle_reads_source_head_exactly_once(fmt, targets):
    """The daemon's probe doubles as the cycle's head hint: planner
    ``current_commit()`` and the index tail refresh consume that one probe,
    so a CHANGED cycle costs exactly ONE source-head read per table —
    previously ~3 (probe, planner head, refresh head)."""
    raw = MemoryFS()
    t = _mk_table(raw, "bkt/src", fmt)
    counter = _HeadReadCounter(raw, "bkt/src", fmt)
    fs = layer_fs(counter)
    daemon = SyncDaemon(_cfg(["bkt/src"], src=fmt, targets=targets), fs,
                        clock=ManualClock())
    daemon.run_cycle()                           # FULL bootstrap
    assert daemon.run_cycle().idle               # warm + quiet

    _append(t, 3)
    counter.head_reads = 0
    rep = daemon.run_cycle()
    assert rep.changed == 1 and rep.units_drained == len(targets)
    assert rep.results[0].commits_synced == 3
    assert counter.head_reads == 1, counter.head_reads

    # and the hint is scoped to the cycle: the NEXT cycle's probe is a
    # fresh head read (one), not a stale cache hit
    counter.head_reads = 0
    assert daemon.run_cycle().idle
    assert counter.head_reads == 1


def test_hinted_refresh_detects_head_behind_anchor():
    """A probed head BEHIND the index anchor (restore / divergent rewrite)
    must trigger a full rebuild, not silently splice an empty tail and keep
    serving the vanished head."""
    from repro_torch.core import MetadataCache

    raw = MemoryFS()
    _mk_table(raw, "bkt/t", "delta", n_commits=6)       # v0 .. v6
    idx = MetadataCache(raw).index("delta", "bkt/t")
    idx.ensure_built()
    assert idx.head() == "6"
    for v in range(4, 7):                               # rewind to v3
        raw.delete(f"bkt/t/_delta_log/{v:020d}.json")
    token = idx.probe()
    assert token == "3"
    idx.refresh()
    try:
        assert idx.head() == "3"
        assert idx.versions()[-1] == "3"
    finally:
        idx.end_cycle()


# ----------------------------------------------------- bounded drain backpressure
def test_backlog_drains_in_ceil_n_over_k_cycles():
    raw = MemoryFS()
    t = _mk_table(raw, "bkt/t")
    fs = layer_fs(raw)
    n, k = 7, 3
    daemon = SyncDaemon(_cfg(["bkt/t"], maxCommitsPerSync=k), fs,
                        clock=ManualClock())
    daemon.run_cycle()                           # FULL bootstrap
    _append(t, n)

    lags, applied, drain_cycles = [], 0, 0
    while True:
        rep = daemon.run_cycle()
        if rep.idle:
            break
        drain_cycles += 1
        applied += rep.commits_applied
        lags.append(rep.total_lag)
        assert drain_cycles <= n                 # safety against livelock

    assert drain_cycles == math.ceil(n / k)      # 3 cycles for 7 commits
    assert applied == n
    assert lags == [4, 1, 0]                     # backlog shrinks by k a cycle

    # the target genuinely caught up to the source head
    target = make_target("iceberg", raw, "bkt/t")
    assert target.get_sync_token() == \
        FORMATS["delta"].open(raw, "bkt/t").head()


def test_pending_backlog_survives_quiet_head():
    """A capped drain keeps the dataset pending: the next cycle continues
    from the sync token even though the source head did not move again."""
    raw = MemoryFS()
    t = _mk_table(raw, "bkt/t")
    fs = layer_fs(raw)
    daemon = SyncDaemon(_cfg(["bkt/t"], maxCommitsPerSync=2), fs,
                        clock=ManualClock())
    daemon.run_cycle()
    _append(t, 4)

    rep1 = daemon.run_cycle()
    assert rep1.commits_applied == 2 and rep1.total_lag == 2
    rep2 = daemon.run_cycle()                    # head token unchanged...
    assert rep2.changed == 1                     # ...but the backlog drains
    assert rep2.commits_applied == 2 and rep2.total_lag == 0


# -------------------------------------------------------------- fault isolation
class _FlakyFS:
    """Delegating wrapper that 503s every request touching ``match``."""

    def __init__(self, inner, match):
        self.inner = inner
        self.match = match
        self.armed = False

    def _guard(self, path):
        if self.armed and self.match in path:
            raise TransientStorageError(f"503 SlowDown ({path})")

    def __getattr__(self, name):
        fn = getattr(self.inner, name)
        if not callable(fn):
            return fn

        def wrapped(*args, **kw):
            if args and isinstance(args[0], str):
                self._guard(args[0])
            return fn(*args, **kw)
        return wrapped


def test_transient_503_backs_off_one_table_without_stalling_others():
    raw = MemoryFS()
    t0 = _mk_table(raw, "bkt/t0")
    t1 = _mk_table(raw, "bkt/t1")
    flaky = _FlakyFS(raw, "bkt/t0")
    fs = layer_fs(flaky)
    clock = ManualClock()
    cfg = _cfg(["bkt/t0", "bkt/t1"],
               daemon={"backoff": {"baseDelayMs": 1000, "jitter": 0.0,
                                   "multiplier": 2.0}})
    daemon = SyncDaemon(cfg, fs, clock=clock)
    daemon.run_cycle()                           # both bootstrap FULL

    flaky.armed = True
    _append(t0), _append(t1)
    rep = daemon.run_cycle()
    # t0's probe 503s and is backed off; t1 drains normally in the SAME cycle
    assert rep.table_errors == 1
    assert rep.failures[0][0] == "t0" and rep.failures[0][1] == "probe"
    assert rep.units_drained == 1 and rep.commits_applied == 1

    # inside the backoff window t0 is not even probed
    rep = daemon.run_cycle()
    assert rep.backed_off == 1 and rep.probed == 1 and rep.quiet == 1

    # still failing after the window: the backoff escalates (1s -> 2s)
    clock.advance(1.5)
    rep = daemon.run_cycle()
    assert rep.table_errors == 1
    w = daemon._watch["bkt/t0"]
    assert w.failures == 2
    assert w.not_before - clock.now() == pytest.approx(2.0)

    # recovery: disarm, let the window pass, and t0 catches up
    flaky.armed = False
    clock.advance(2.5)
    rep = daemon.run_cycle()
    assert rep.table_errors == 0 and rep.units_drained == 1
    assert rep.commits_applied == 1 and rep.total_lag == 0
    assert daemon._watch["bkt/t0"].failures == 0


def test_backoff_jitter_is_seeded_and_bounded():
    opts_cfg = _cfg(["bkt/t"], daemon={
        "backoff": {"baseDelayMs": 1000, "maxDelayMs": 4000,
                    "multiplier": 2.0, "jitter": 0.25, "seed": 42}})
    opts = opts_cfg.daemon
    assert opts.backoff_delay_s(1) == 1.0
    assert opts.backoff_delay_s(2) == 2.0
    assert opts.backoff_delay_s(5) == 4.0        # capped at maxDelayMs

    def delays():
        raw = MemoryFS()
        _mk_table(raw, "bkt/t")
        flaky = _FlakyFS(raw, "bkt/t")
        flaky.armed = True
        daemon = SyncDaemon(opts_cfg, layer_fs(flaky), clock=ManualClock())
        daemon.run_cycle()
        w = daemon._watch["bkt/t"]
        return w.not_before

    d1, d2 = delays(), delays()
    assert d1 == d2                              # seeded == reproducible
    assert 1.0 <= d1 <= 1.25                     # jitter within +25%


# ------------------------------------------------------------- run() scheduling
def test_run_paces_cycles_by_poll_interval_on_injected_clock():
    raw = MemoryFS()
    _mk_table(raw, "bkt/t")
    clock = ManualClock()
    cfg = _cfg(["bkt/t"], daemon={"pollIntervalMs": 250})
    daemon = SyncDaemon(cfg, layer_fs(raw), clock=clock)
    reports = daemon.run(cycles=5)
    assert len(reports) == 5
    # 4 sleeps between 5 cycles, each exactly the poll interval — and the
    # ManualClock means none of them were wall sleeps
    assert clock.now() == pytest.approx(4 * 0.25)
    assert [r.started_at for r in reports] == \
        pytest.approx([0.0, 0.25, 0.5, 0.75, 1.0])


def test_run_stops_after_max_cycles_idle():
    raw = MemoryFS()
    t = _mk_table(raw, "bkt/t")
    cfg = _cfg(["bkt/t"], daemon={"pollIntervalMs": 10, "maxCyclesIdle": 3})
    reports = run_daemon(cfg, layer_fs(raw), clock=ManualClock())
    # cycle 0 drains (FULL), then exactly 3 consecutive idle cycles
    assert len(reports) == 4
    assert [r.idle for r in reports] == [False, True, True, True]

    # the idle counter is *consecutive*: new commits reset it
    daemon = SyncDaemon(cfg, layer_fs(raw), clock=ManualClock())
    daemon.run_cycle()
    daemon.run_cycle()                           # idle 1
    _append(t)
    reports = daemon.run(max_cycles_idle=2)
    assert [r.idle for r in reports] == [False, True, True]


def test_stop_drain_finishes_backlog_then_stops():
    raw = MemoryFS()
    t = _mk_table(raw, "bkt/t")
    fs = layer_fs(raw)
    daemon = SyncDaemon(_cfg(["bkt/t"], maxCommitsPerSync=2), fs,
                        clock=ManualClock())
    daemon.run_cycle()
    _append(t, 6)
    daemon.run_cycle()                           # first bounded drain: 2 of 6
    assert daemon.lag() == {"bkt/t": True}

    daemon.stop(drain=True)
    reports = daemon.run()                       # drains 4 more, then stops
    assert sum(r.commits_applied for r in reports) == 4
    assert daemon.lag() == {"bkt/t": False}
    target = make_target("iceberg", raw, "bkt/t")
    assert target.get_sync_token() == \
        FORMATS["delta"].open(raw, "bkt/t").head()

    daemon2 = SyncDaemon(_cfg(["bkt/t"]), fs, clock=ManualClock())
    daemon2.stop()                               # hard stop before any cycle
    assert daemon2.run() == []


def test_repeated_stop_drain_keeps_draining_plain_stop_downgrades():
    raw = MemoryFS()
    t = _mk_table(raw, "bkt/t")
    fs = layer_fs(raw)

    def backlogged_daemon():
        daemon = SyncDaemon(_cfg(["bkt/t"], maxCommitsPerSync=1), fs,
                            clock=ManualClock())
        daemon.run_cycle()
        _append(t, 3)
        daemon.run_cycle()                       # 1 of 3 drained -> pending
        return daemon

    d = backlogged_daemon()
    d.stop(drain=True)
    d.stop(drain=True)                           # idempotent: still draining
    assert sum(r.commits_applied for r in d.run()) == 2
    assert d.lag() == {"bkt/t": False}

    d = backlogged_daemon()
    d.stop(drain=True)
    d.stop()                                     # downgrade: stop NOW
    assert d.run() == []
    assert d.lag() == {"bkt/t": True}


def test_stop_interrupts_system_clock_poll_sleep():
    import threading
    import time as _time

    raw = MemoryFS()
    _mk_table(raw, "bkt/t")
    # a poll interval far longer than the test: without the interruptible
    # wait, stop() would strand run() inside time.sleep for 60s
    daemon = SyncDaemon(_cfg(["bkt/t"], daemon={"pollIntervalMs": 60_000}),
                        layer_fs(raw))
    threading.Timer(0.05, daemon.stop).start()
    t0 = _time.monotonic()
    reports = daemon.run()
    assert _time.monotonic() - t0 < 10.0
    assert len(reports) >= 1


def test_unbounded_run_retains_a_bounded_report_window():
    from repro_torch.core import daemon as daemon_mod

    raw = MemoryFS()
    _mk_table(raw, "bkt/t")
    cfg = _cfg(["bkt/t"], daemon={"pollIntervalMs": 1})
    d = SyncDaemon(cfg, layer_fs(raw), clock=ManualClock())
    want = daemon_mod.MAX_RETAINED_REPORTS
    # stop once enough cycles have run to overflow the retention window
    orig = d.run_cycle

    def counted():
        rep = orig()
        if d.cycles_run >= want + 50:
            d.stop()
        return rep

    d.run_cycle = counted
    reports = d.run()                            # unbounded: rolling window
    assert d.cycles_run == want + 50
    assert len(reports) == want
    assert reports[-1].cycle == want + 49        # newest kept, oldest dropped


# ------------------------------------------------------------------- config
def test_daemon_config_block_parses():
    cfg = SyncConfig.from_dict({
        "sourceFormat": "DELTA", "targetFormats": ["HUDI"],
        "datasets": [{"tableBasePath": "bkt/t"}],
        "daemon": {"pollIntervalMs": 500, "maxCyclesIdle": 7,
                   "backoff": {"baseDelayMs": 25, "maxDelayMs": 800,
                               "multiplier": 3.0, "jitter": 0.5, "seed": 9}}})
    o = cfg.daemon
    assert o.poll_interval_ms == 500 and o.max_cycles_idle == 7
    assert o.backoff_base_delay_ms == 25 and o.backoff_max_delay_ms == 800
    assert o.backoff_multiplier == 3.0 and o.backoff_jitter == 0.5
    assert o.seed == 9

    with pytest.raises(ValueError):
        SyncConfig.from_dict({
            "sourceFormat": "DELTA", "targetFormats": ["HUDI"],
            "datasets": [], "daemon": {"maxCyclesIdle": 0}})


def test_daemon_multi_format_matrix_round_trip():
    """End to end on a hudi source: the daemon keeps BOTH targets fresh
    through several writer rounds, and every format reads the same rows."""
    raw = MemoryFS()
    t = _mk_table(raw, "bkt/sales", "hudi", n_commits=2)
    fs = layer_fs(raw)
    daemon = SyncDaemon(_cfg(["bkt/sales"], src="hudi",
                             targets=("delta", "iceberg")), fs,
                        clock=ManualClock())
    daemon.run_cycle()
    for _ in range(3):
        _append(t, 2)
        rep = daemon.run_cycle()
        assert rep.units_drained == 2 and rep.total_lag == 0
        want = t.state().total_records()
        for fmt in ("delta", "iceberg"):
            got = LakeTable.open(raw, "bkt/sales", fmt).state().total_records()
            assert got == want, fmt
    # sync state rides in the targets' own metadata
    tgt = make_target("delta", raw, "bkt/sales")
    assert tgt._read_state()[TOKEN_KEY] == t.handle.head()
