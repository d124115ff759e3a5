"""Port copy of the daemon-driven tests of ``tests/test_catalog.py`` and
``tests/test_read_plane.py``: the same tests and bounds, run against
``repro_torch`` (only the import prefix differs; the read plane's helpers
carry an ``_rp`` prefix here, since both files name theirs alike).

From ``test_catalog.py``: the daemon group-publishes each cycle's drained
tables as ONE catalog generation, converges on restart without minting
generations, carries the generation cursor in its checkpoint and keeps a
backed-off table's last pointer; group reads pin every member at one
generation and a warm group read is ONE request; a crash at EVERY
request index of a 3-table group publish leaves readers at the full
previous or the full next generation.  From ``test_read_plane.py``: a
snapshot stays immutable while the daemon commits, and the daemon's
publish makes co-located reads free.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import (ManualClock, MetadataCache,  # noqa: E402
                              SyncConfig, SyncDaemon)
from repro_torch.lst import LakeTable  # noqa: E402
from repro_torch.lst.catalog import Catalog, UnknownTableError  # noqa: E402
from repro_torch.lst.schema import Field, PartitionSpec, Schema  # noqa: E402
from repro_torch.lst.storage import (CrashSchedule, MemoryFS,  # noqa: E402
                                     SimulatedCrash, SimulatedObjectStore,
                                     StorageProfile, layer_fs)
from repro_torch.serve.read_plane import (NOT_MODIFIED, OK,  # noqa: E402
                                          SnapshotServer)

torch.set_num_threads(2)

SCHEMA = Schema([Field("k", "int64"), Field("part", "string")])


def _mk_table(fs, base, fmt="delta", n_commits=3, start=0):
    t = LakeTable.create(fs, base, SCHEMA, fmt, PartitionSpec(["part"]),
                         {"delta.checkpointInterval": "100000"})
    for i in range(start, start + n_commits):
        t.append({"k": np.array([i, i + 100], np.int64),
                  "part": np.array([f"p{i % 2}", "p0"])})
    return t


def _cfg(bases, *, targets=("iceberg",), **catalog_kw):
    cat = {"enabled": True}
    cat.update(catalog_kw)
    return SyncConfig.from_dict({
        "sourceFormat": "DELTA",
        "targetFormats": [t.upper() for t in targets],
        "datasets": [{"tableBasePath": b} for b in bases],
        "catalog": cat,
    })


RP_SCHEMA = Schema([Field("k", "int64"), Field("v", "float64"),
                    Field("s", "string")])


def _rp_mk_table(fs, base, fmt="delta", n_commits=3, rows=20, seed=0):
    """Each commit's ``k`` lives in a disjoint [c*1000, c*1000+rows) band,
    so value predicates are selective per chunk."""
    t = LakeTable.create(fs, base, RP_SCHEMA, fmt)
    rng = np.random.default_rng(seed)
    for c in range(n_commits):
        t.append({"k": np.arange(c * 1000, c * 1000 + rows),
                  "v": rng.normal(size=rows),
                  "s": np.array([f"s{c:02d}_{i:03d}" for i in range(rows)])})
    return t


def _rp_cfg(base, src="delta", targets=("iceberg",)):
    return SyncConfig.from_dict({
        "sourceFormat": src.upper(),
        "targetFormats": [t.upper() for t in targets],
        "datasets": [{"tableBasePath": base}]})


# ------------------------------------------------------------------- daemon
def test_daemon_group_publishes_each_cycle_and_converges_on_restart():
    fs = MemoryFS()
    orders = _mk_table(fs, "bkt/orders")
    _mk_table(fs, "bkt/customers")
    cfg = _cfg(["bkt/orders", "bkt/customers"], group="sales")
    d = SyncDaemon(cfg, fs, clock=ManualClock())
    rep = d.run_cycle()
    assert rep.catalog_generation == 1           # BOTH tables in ONE publish
    snap = d.catalog.snapshot()
    assert snap.group("sales") == ("orders", "customers")
    for name in ("orders", "customers"):
        ptr = snap.resolve(name)
        assert ptr.formats == ("delta", "iceberg")

    assert d.run_cycle().catalog_generation is None     # idle: no publish
    orders.append({"k": np.array([999], np.int64), "part": np.array(["p0"])})
    assert d.run_cycle().catalog_generation == 2

    # a restarted daemon re-resolves everything, finds identical pointers
    # and converges WITHOUT minting a generation per boot
    d2 = SyncDaemon(cfg, fs, clock=ManualClock())
    assert d2.run_cycle().catalog_generation == 2
    assert d2.catalog.store.publishes == 0
    assert d2.catalog.store.head_generation() == 2


def test_daemon_publish_views_source_skips_target_views():
    fs = MemoryFS()
    _mk_table(fs, "bkt/orders")
    cfg = _cfg(["bkt/orders"], publishViews="source")
    d = SyncDaemon(cfg, fs, clock=ManualClock())
    d.run_cycle()
    ptr = d.catalog.resolve("orders")
    assert ptr.formats == ("delta",)


def test_catalog_generation_rides_the_checkpoint():
    fs = MemoryFS()
    _mk_table(fs, "bkt/orders")
    cfg = SyncConfig.from_dict({
        "sourceFormat": "DELTA", "targetFormats": ["ICEBERG"],
        "datasets": [{"tableBasePath": "bkt/orders"}],
        "catalog": {"enabled": True},
        "checkpoint": {"enabled": True},
    })
    d = SyncDaemon(cfg, fs, clock=ManualClock())
    rep = d.run_cycle()
    assert rep.checkpoint_gen is not None and rep.catalog_generation == 1
    _gen, payload = d._ckpt.load()
    assert payload["catalog"]["generation"] == 1
    d2 = SyncDaemon(cfg, fs, clock=ManualClock())
    assert d2.restored_from_checkpoint
    assert d2.catalog.store._gen_hint == 1       # advisory cursor seeded


def test_backed_off_table_keeps_its_last_published_pointer():
    """A table mid-backoff must not block the healthy table's group — and
    until it drains cleanly again the catalog keeps serving its LAST
    cleanly published pointer, never a half-synced head."""
    fs = MemoryFS()
    orders = _mk_table(fs, "bkt/orders")
    customers = _mk_table(fs, "bkt/customers")
    cfg = _cfg(["bkt/orders", "bkt/customers"], group="sales")
    clock = ManualClock()
    d = SyncDaemon(cfg, fs, clock=clock)
    assert d.run_cycle().catalog_generation == 1
    old_ref = d.catalog.resolve("customers").view()

    orders.append({"k": np.array([7], np.int64), "part": np.array(["p0"])})
    customers.append({"k": np.array([8], np.int64), "part": np.array(["p0"])})
    # customers enters a backoff window (as a failed probe/drain would
    # leave it): skipped this cycle, excluded from this cycle's group
    d._watch["bkt/customers"].not_before = clock.now() + 100.0
    rep2 = d.run_cycle()
    assert rep2.backed_off == 1 and rep2.catalog_generation == 2
    snap = d.catalog.snapshot()
    assert snap.group("sales") == ("orders", "customers")   # still grouped
    assert snap.resolve("customers").view() == old_ref      # old pointer
    assert snap.resolve("orders").view().token != old_ref.token

    clock.advance(200.0)          # window passes: customers drains and
    rep3 = d.run_cycle()          # joins a LATER group generation
    assert rep3.catalog_generation == 3
    assert d.catalog.resolve("customers").view() != old_ref


# -------------------------------------------------- read plane: group reads
def _serving_stack(bases, **catalog_kw):
    raw = MemoryFS()
    tables = [_mk_table(raw, b) for b in bases]
    fs = layer_fs(raw)
    cfg = _cfg(bases, group="sales", **catalog_kw)
    clock = ManualClock()
    d = SyncDaemon(cfg, fs, clock=clock)
    server = SnapshotServer(fs, cache=d.cache, clock=clock)
    d.read_plane = server
    assert d.run_cycle().catalog_generation == 1
    return raw, fs, cfg, d, server, tables


def test_read_group_pins_every_member_at_one_generation():
    _raw, _fs, _cfg_, d, server, (orders, _customers) = \
        _serving_stack(["bkt/orders", "bkt/customers"])
    g1 = server.read_group(d.catalog, group="sales")
    assert g1.generation == 1 and len(g1) == 2
    rows1 = sorted(server.scan_snapshot(g1["orders"]).rows["k"].tolist())

    orders.append({"k": np.array([999], np.int64), "part": np.array(["p0"])})
    assert d.run_cycle().catalog_generation == 2
    g2 = server.read_group(d.catalog, group="sales")
    assert g2.generation == 2
    assert 999 in server.scan_snapshot(g2["orders"]).rows["k"].tolist()
    # the held group snapshot stays pinned at its OWN generation's rows
    again = sorted(server.scan_snapshot(g1["orders"]).rows["k"].tolist())
    assert again == rows1 and 999 not in again


def test_read_group_by_view_format_and_unknowns():
    _raw, _fs, _cfg_, d, server, _tables = \
        _serving_stack(["bkt/orders", "bkt/customers"])
    gi = server.read_group(d.catalog, group="sales", fmt="iceberg")
    assert all(s.view_format == "iceberg" for s in gi.snapshots.values())
    # the iceberg view serves the same rows as the source view
    gd = server.read_group(d.catalog, tables=["orders"])
    assert sorted(server.scan_snapshot(gi["orders"]).rows["k"].tolist()) == \
        sorted(server.scan_snapshot(gd["orders"]).rows["k"].tolist())
    with pytest.raises(UnknownTableError):
        server.read_group(d.catalog, tables=["nope"])
    with pytest.raises(KeyError):
        _serving_stack(["bkt/solo"], publishViews="source")[4].read_group(
            SyncDaemon(_cfg(["bkt/solo"]), _fs).catalog, fmt="hudi")


def test_census_warm_group_read_is_one_request_total():
    """The O(1) pin: beyond the read plane's existing floors, a warm
    catalog-pinned group read costs exactly ONE storage request — the
    catalog freshness LIST — and zero per table."""
    _raw, fs, _cfg_, d, server, _tables = \
        _serving_stack(["bkt/orders", "bkt/customers", "bkt/parts"])
    server.read_group(d.catalog, group="sales")      # prime the memo
    for _ in range(3):
        before = fs.stats().requests
        g = server.read_group(d.catalog, group="sales")
        assert fs.stats().requests - before == 1     # catalog LIST only
        assert len(g) == 3
    # a COLD reader process: catalog resolution (LIST + GET) plus the
    # normal one-replay-per-table floor, amortized across later reads
    cold_cache = MetadataCache(fs)
    cold_server = SnapshotServer(fs, cache=cold_cache)
    cold_catalog = Catalog(fs, d.catalog.store.base_path)
    cold_server.read_group(cold_catalog, group="sales")
    before = fs.stats().requests
    cold_server.read_group(cold_catalog, group="sales")
    assert fs.stats().requests - before == 1


# ------------------------------------------- chaos: binary group atomicity
def _group_digest(fs, catalog_path, bases):
    """(generation, rows-per-table) as one pinned read through a COLD
    reader stack — what any external reader would observe."""
    server = SnapshotServer(fs, cache=MetadataCache(fs))
    group = server.read_group(Catalog(fs, catalog_path))
    rows = {}
    for name in group.table_names():
        got = server.scan_snapshot(group[name]).rows
        rows[name] = sorted(zip(got["k"].tolist(), got["part"].tolist()))
    return group.generation, rows


def _publish_campaign_base():
    """Pre-crash store: 3 tables synced + group-published at generation 1,
    then fresh commits land on ALL of them while the daemon is down."""
    bases = ["bkt/orders", "bkt/customers", "bkt/parts"]
    raw = MemoryFS()
    tables = [_mk_table(raw, b, n_commits=2) for b in bases]
    cfg = _cfg(bases, group="sales")
    d = SyncDaemon(cfg, layer_fs(raw), clock=ManualClock())
    assert d.run_cycle().catalog_generation == 1
    for i, t in enumerate(tables):
        t.append({"k": np.array([50 + i], np.int64),
                  "part": np.array(["p1"])})
    catalog_path = d.catalog.store.base_path
    return raw, cfg, bases, catalog_path


def _crash_sweep(*, after_apply):
    base, cfg, bases, catalog_path = _publish_campaign_base()
    serial = StorageProfile(pipeline_depth=1)

    # golden arm: the same cycle, no crash -> the full next generation
    golden = SimulatedObjectStore(base.clone(), serial)
    d = SyncDaemon(cfg, layer_fs(golden), clock=ManualClock())
    assert d.run_cycle().catalog_generation == 2
    prev_digest = _group_digest(base, catalog_path, bases)
    next_digest = _group_digest(golden.inner, catalog_path, bases)
    assert prev_digest[0] == 1 and next_digest[0] == 2
    assert prev_digest[1] != next_digest[1]
    total = golden.requests
    assert total > 30            # the sweep covers a real drain + publish

    mixed_seen = 0
    for n in range(1, total + 1):
        sim = SimulatedObjectStore(base.clone(), serial)
        sim.arm_crash(CrashSchedule(n, after_apply=after_apply))
        daemon = SyncDaemon(cfg, layer_fs(sim), clock=ManualClock())
        with pytest.raises(SimulatedCrash):
            daemon.run_cycle()
        assert sim.crashed, f"crash at request {n} never fired"
        sim.arm_crash(None)
        got = _group_digest(sim.inner, catalog_path, bases)
        if got == prev_digest:
            continue
        if got == next_digest:
            mixed_seen += 1      # fine: the publish PUT landed before n
            continue
        raise AssertionError(
            f"crash at request {n} left a MIXED catalog view: "
            f"generation {got[0]}")
    # the torn-write arm must actually exercise the published-next case
    if after_apply:
        assert mixed_seen >= 1
    return total


def test_crash_at_every_request_index_leaves_binary_catalog_view():
    """The acceptance gate: a crash at EVERY request index of a 3-table
    group publish leaves ``read_group`` observing either the full
    previous or the full next catalog generation — byte-identical rows,
    never a mix."""
    _crash_sweep(after_apply=False)


@pytest.mark.slow
def test_crash_torn_publish_put_leaves_full_next_generation():
    _crash_sweep(after_apply=True)


# ------------------------------------------------- read plane: the daemon
def test_snapshot_immutable_while_daemon_commits_mid_read():
    raw = MemoryFS()
    t = _rp_mk_table(raw, "bkt/t", n_commits=2)
    fs = layer_fs(raw)
    clock = ManualClock()
    cache = MetadataCache(fs)
    server = SnapshotServer(fs, cache=cache, clock=clock)
    daemon = SyncDaemon(_rp_cfg("bkt/t"), fs, cache=cache, clock=clock,
                        read_plane=server)
    daemon.run_cycle()

    pinned = server.read("bkt/t", "delta").snapshot
    files_before = dict(pinned.files)
    # the daemon lands two more commits while the reader holds `pinned`
    t.append({"k": np.arange(5), "v": np.zeros(5), "s": np.array(["a"] * 5)})
    t.append({"k": np.arange(5), "v": np.ones(5), "s": np.array(["b"] * 5)})
    clock.advance(2.0)
    daemon.run_cycle()

    fresh = server.read("bkt/t", "delta").snapshot
    assert len(fresh.files) == 4 and fresh.token != pinned.token
    # the pinned snapshot did not move underneath the reader
    assert pinned.files == files_before
    assert len(pinned.files) == 2
    assert pinned.head_commit != fresh.head_commit


def test_daemon_publish_makes_co_located_reads_free():
    raw = MemoryFS()
    t = _rp_mk_table(raw, "bkt/t", n_commits=2)
    fs = layer_fs(raw)
    clock = ManualClock()
    cache = MetadataCache(fs)
    server = SnapshotServer(fs, cache=cache, clock=clock)
    daemon = SyncDaemon(_rp_cfg("bkt/t"), fs, cache=cache, clock=clock,
                        read_plane=server)
    daemon.run_cycle()
    assert server.stats.published == 1

    # post-drain reads of the source view: no probe, no replay, nothing
    before = fs.stats().requests
    res = server.read("bkt/t", "delta")
    assert res.status == OK and len(res.snapshot.files) == 2
    assert server.read("bkt/t", "delta",
                       if_token=res.token).status == NOT_MODIFIED
    assert fs.stats().requests == before
    assert server.stats.probes == 0

    # the next cycle's publish refreshes the token — readers see the new
    # head, still without a single probe of their own
    t.append({"k": np.arange(4), "v": np.zeros(4), "s": np.array(["y"] * 4)})
    clock.advance(2.0)
    daemon.run_cycle()
    before = fs.stats().requests
    res2 = server.read("bkt/t", "delta", if_token=res.token)
    assert res2.status == OK and len(res2.snapshot.files) == 3
    assert fs.stats().requests == before
    assert server.stats.probes == 0
