"""The port's continuous-sync daemon against the reference's.

* **Parity.** One seeded, scripted history (Hudi-source and Delta-source
  tables, commits landing between cycles, ``maxCommitsPerSync`` leaving a
  backlog) runs through the reference's ``SyncDaemon`` and the port's,
  each on its own ``MemoryFS`` holding the same source bytes.  Every
  cycle's report must be equal (units, commits, lag per (dataset,
  target), the storage-request census), and so must every target view's
  files, their stats and sync token at the end: serially and with four
  fleet workers.
* **Cross.** A daemon checkpoint written by either package warm-restarts
  the other's daemon (first cycle idle at one request per table, no
  target rewritten), and a catalog generation published by either
  package's daemon resolves in the other's ``Catalog``.
* **Process mode.** The port's fleet starts its process-pool children
  with ``spawn`` (the reference forks), and a child that ran a FULL
  bootstrap has not imported ``torch``.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.lst as ref_lst  # noqa: E402
import repro.lst.catalog as ref_catalog  # noqa: E402
import repro.lst.schema as ref_schema  # noqa: E402
import repro.lst.storage as ref_storage  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.lst as port_lst  # noqa: E402
import repro_torch.lst.catalog as port_catalog  # noqa: E402
import repro_torch.lst.schema as port_schema  # noqa: E402
import repro_torch.lst.storage as port_storage  # noqa: E402
from repro_torch.core.fleet import SyncFleet, _process_run_unit  # noqa: E402

torch.set_num_threads(2)

PKG = {
    "ref": (ref_core, ref_lst, ref_catalog, ref_schema, ref_storage),
    "port": (port_core, port_lst, port_catalog, port_schema, port_storage),
}
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# source format -> (tables, target formats)
PIPELINES = {"hudi": (("bkt/h0", "bkt/h1"), ("iceberg", "delta")),
             "delta": (("bkt/d0", "bkt/d1"), ("iceberg", "hudi"))}
CYCLES = 6
OPS = ("get", "put", "list", "head", "delete", "requests")


def _schema(pkg):
    s = PKG[pkg][3]
    return s.Schema([s.Field("k", "int64"), s.Field("v", "float64"),
                     s.Field("part", "string")]), s.PartitionSpec(["part"])


def _cfg(pkg, src, root=None, **extra):
    """``src``'s pipeline as ``pkg``'s config (tables under ``root``)."""
    bases, targets = PIPELINES[src]
    d = {"sourceFormat": src.upper(),
         "targetFormats": [t.upper() for t in targets],
         "datasets": [{"tableBasePath": f"{root}/{b}" if root else b}
                      for b in bases]}
    d.update(extra)
    return PKG[pkg][0].SyncConfig.from_dict(d)


def _rows(rng, n):
    return {"k": rng.integers(0, 10_000, n).astype(np.int64),
            "v": rng.standard_normal(n),
            "part": np.array([f"p{i}" for i in rng.integers(0, 3, n)])}


class _Mirror:
    """Writes the source history once, with the reference's ``LakeTable``,
    and copies each new object into the port's store: both daemons then
    translate byte-identical sources (file ids are random, so two writers
    would not)."""

    def __init__(self):
        self.ref = ref_storage.MemoryFS()
        self.port = port_storage.MemoryFS()
        self.tables = {}
        schema, spec = _schema("ref")
        for src, (bases, _targets) in PIPELINES.items():
            for b in bases:
                self.tables[b] = self._sync(
                    lambda b=b, src=src: ref_lst.LakeTable.create(
                        self.ref, b, schema, src, spec))

    def _sync(self, write):
        before = dict(self.ref._objects)
        out = write()
        for k, v in self.ref._objects.items():
            if before.get(k) != v:
                self.port.write_bytes(k, v, overwrite=True)
        return out

    def append(self, base, rows):
        self._sync(lambda: self.tables[base].append(rows))


def _report(rep):
    return {
        "counts": (rep.probed, rep.quiet, rep.changed, rep.backed_off,
                   rep.table_errors, rep.units_planned, rep.units_drained,
                   rep.units_skipped, rep.units_errored,
                   rep.commits_applied, rep.units_deferred, rep.workers,
                   rep.breaker_open, rep.quarantined, rep.checkpoint_gen,
                   rep.catalog_generation),
        "lag": dict(rep.lag),
        "health": dict(rep.health),
        "requests": {k: rep.storage_ops[k] for k in OPS},
        "results": sorted((r.dataset, r.target_format, r.mode,
                           r.commits_synced, r.source_commit, r.error)
                          for r in rep.results),
    }


def _view(pkg, fs, base, fmt):
    core, lst = PKG[pkg][0], PKG[pkg][1]
    st = lst.LakeTable.open(fs, base, fmt).state()
    files = {p: (f.size_bytes, f.record_count,
                 sorted(f.partition_values.items()), f.stats_dict())
             for p, f in st.files.items()}
    token = core.make_target(fmt, fs, base).get_sync_token()
    return files, [(f.name, f.type) for f in st.schema.fields], token


@pytest.mark.parametrize("workers", [1, 4])
def test_scripted_history_gives_equal_reports_and_views(workers):
    mirror = _Mirror()
    daemons = {}
    for pkg, fs in (("ref", mirror.ref), ("port", mirror.port)):
        core, storage = PKG[pkg][0], PKG[pkg][4]
        fleet = core.FleetOptions(workers=workers) if workers > 1 else None
        daemons[pkg] = {src: core.SyncDaemon(_cfg(pkg, src,
                                                  maxCommitsPerSync=2),
                                             storage.layer_fs(fs),
                                             clock=core.ManualClock(),
                                             fleet=fleet)
                        for src in PIPELINES}
    rng = np.random.default_rng(21)
    applied, lagged = 0, 0
    try:
        for cycle in range(CYCLES):
            # the writer lands 0-3 commits on each table between cycles
            for base in mirror.tables:
                for _ in range(int(rng.integers(0, 4))):
                    mirror.append(base, _rows(rng, int(rng.integers(1, 6))))
            for src in PIPELINES:
                got = {pkg: _report(daemons[pkg][src].run_cycle())
                       for pkg in daemons}
                assert got["port"] == got["ref"], (cycle, src)
                assert got["port"]["counts"][11] == workers
                applied += got["port"]["counts"][9]
                lagged += sum(got["port"]["lag"].values()) > 0
        drained = 0
        while any(d._pending() for d in daemons["ref"].values()):
            for src in PIPELINES:
                assert _report(daemons["port"][src].run_cycle()) == \
                    _report(daemons["ref"][src].run_cycle())
            drained += 1
            assert drained < 10
        assert not any(d._pending() for d in daemons["port"].values())
        # the history is not trivial: commits drain and backlogs carry over
        assert applied >= 40 and lagged >= 3 and drained >= 1
    finally:
        for per in daemons.values():
            for d in per.values():
                d.close()
    for src, (bases, targets) in PIPELINES.items():
        for base in bases:
            head = ref_lst.LakeTable.open(mirror.ref, base, src).state()
            for fmt in targets:
                ref_view = _view("ref", mirror.ref, base, fmt)
                assert _view("port", mirror.port, base, fmt) == ref_view
                assert ref_view[2] == head.version
                assert set(ref_view[0]) == set(head.files)


# -------------------------------------------------------------- cross
def _drained_lake(pkg, root, **extra):
    """Write the Hudi pipeline's tables with ``pkg``'s writer and drain
    them with ``pkg``'s daemon over a plain local directory."""
    core, lst, storage = PKG[pkg][0], PKG[pkg][1], PKG[pkg][4]
    fs = storage.LocalFS()
    schema, spec = _schema(pkg)
    rng = np.random.default_rng(5)
    for base in PIPELINES["hudi"][0]:
        t = lst.LakeTable.create(fs, f"{root}/{base}", schema, "hudi", spec)
        for _ in range(3):
            t.append(_rows(rng, 4))
    d = core.SyncDaemon(_cfg(pkg, "hudi", root, **extra),
                        storage.layer_fs(fs), clock=core.ManualClock())
    rep = d.run_cycle()
    d.close()
    assert rep.units_drained == 4 and rep.total_lag == 0


def _target_files(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            if "_xtable" not in p:
                out[p] = os.path.getmtime(p)
    return out


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_daemon_checkpoint_warm_restarts_the_other_package(tmp_path, writer,
                                                           reader):
    root = str(tmp_path)
    _drained_lake(writer, root, checkpoint={"enabled": True})
    before = _target_files(root)
    core, storage = PKG[reader][0], PKG[reader][4]
    d = core.SyncDaemon(_cfg(reader, "hudi", root,
                             checkpoint={"enabled": True}),
                        storage.layer_fs(storage.LocalFS()),
                        clock=core.ManualClock())
    try:
        assert d.restored_from_checkpoint
        rep = d.run_cycle()
    finally:
        d.close()
    n_tables = len(PIPELINES["hudi"][0])
    assert rep.idle and rep.quiet == n_tables
    assert rep.storage_ops["requests"] == n_tables      # one probe a table
    assert rep.storage_ops["put"] == 0 and rep.checkpoint_gen is None
    assert _target_files(root) == before                # nothing rewritten


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_catalog_publish_resolves_in_the_other_package(tmp_path, writer,
                                                       reader):
    root = str(tmp_path)
    _drained_lake(writer, root, catalog={"enabled": True, "group": "g"})
    cat_path = f"{root}/bkt/_xtable/catalog"
    w_cat = PKG[writer][2].Catalog(PKG[writer][4].LocalFS(), cat_path)
    r_cat = PKG[reader][2].Catalog(PKG[reader][4].LocalFS(), cat_path)
    w_snap, r_snap = w_cat.snapshot(), r_cat.snapshot()
    assert r_snap.generation == w_snap.generation == 1
    assert r_snap.group("g") == w_snap.group("g") == ("h0", "h1")
    for name in ("h0", "h1"):
        w_ptr, r_ptr = w_cat.resolve(name), r_cat.resolve(name)
        assert PKG[reader][2].pointer_to_json(r_ptr) == \
            PKG[writer][2].pointer_to_json(w_ptr)
        assert r_ptr.formats == ("hudi", "delta", "iceberg")
        # the reader's Iceberg view is the table the daemon wrote
        ice = PKG[reader][1].LakeTable.open(PKG[reader][4].LocalFS(),
                                            r_ptr.base_path, "iceberg")
        src = PKG[reader][1].LakeTable.open(PKG[reader][4].LocalFS(),
                                            r_ptr.base_path, "hudi")
        assert sorted(ice.read_all()["k"].tolist()) == \
            sorted(src.read_all()["k"].tolist())


# -------------------------------------------------------- process mode
def test_process_pool_spawns_and_children_skip_torch(tmp_path):
    """The port's one deliberate difference from ``repro/core/fleet.py``:
    process mode spawns its children (the reference forks), and a child
    that ran a FULL bootstrap imported the lake layer and not torch."""
    fs = port_storage.LocalFS()
    fresh = f"{tmp_path}/fresh"
    schema, spec = _schema("port")
    port_lst.LakeTable.create(fs, fresh, schema, "hudi", spec).append(
        _rows(np.random.default_rng(2), 4))
    cfg = port_core.SyncConfig.from_dict({
        "sourceFormat": "HUDI", "targetFormats": ["ICEBERG"],
        "datasets": [{"tableBasePath": fresh}]})
    (unit,) = port_core.SyncPlanner(cfg, fs).plan().units
    assert unit.mode == "FULL"
    fleet = SyncFleet(port_core.FleetOptions(workers=2, mode="process"),
                      port_core.ManualClock())
    try:
        pool = fleet._process_pool()
        assert pool._mp_context.get_start_method() == "spawn"
        res = pool.submit(_process_run_unit, (unit, None)).result()
        assert res.ok and res.mode == "FULL"
        child = pool.submit(eval, "(__import__('os').getpid(), "
                            "'torch' in __import__('sys').modules)").result()
        assert child[0] != os.getpid() and child[1] is False
    finally:
        fleet.close()
    ice = port_lst.LakeTable.open(fs, fresh, "iceberg").read_all()
    assert len(ice["k"]) == 4


def test_lake_layer_and_daemon_import_without_torch():
    probe = ("import sys; import repro_torch.core, repro_torch.lst.catalog; "
             "print('torch' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    r = subprocess.run([sys.executable, "-c", probe], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"


def test_port_core_exports_the_reference_names():
    assert sorted(port_core.__all__) == sorted(ref_core.__all__)
    for name in port_core.__all__:
        assert getattr(port_core, name).__module__.startswith("repro_torch.")
