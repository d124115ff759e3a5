"""Port copy of ``tests/test_checkpoint.py``: the same tests and bounds,
run against ``repro_torch`` (only the import prefix differs).

Durable daemon checkpoints: crash-safe warm restarts.

What this file pins (all on a fake clock — no test ever wall-sleeps):

* the checkpoint codecs round-trip real replayed ``CommitEntry`` /
  ``TableState`` objects byte-for-byte for all three formats;
* ``CheckpointStore`` generations are atomic conditional puts: racing
  writers take distinct generations, a corrupt newest generation falls
  back to the previous one, and retention prunes old generations;
* ``snapshot_seed`` / ``restore_seed`` rebuild a working index tail with
  ZERO storage reads, and a later ``refresh()`` replays only new commits;
* a seeded index whose anchor the live log no longer reaches (divergent
  rewrite) falls back to a full rebuild — never a wrong splice;
* a restarted daemon resumes from the checkpoint at O(new commits): its
  first-cycle request census is INDEPENDENT of history length, while a
  cold restart's census grows with it;
* the ``checkpoint:`` config block parses and validates.
"""

import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.core import ManualClock, SyncConfig, SyncDaemon  # noqa: E402
from repro_torch.core.checkpoint import (CheckpointStore, decode_seed, encode_seed,  # noqa: E402
                                         entry_from_json, entry_to_json,
                                         state_from_json, state_to_json)
from repro_torch.core.metadata_cache import TableMetadataIndex  # noqa: E402
from repro_torch.core.targets import make_target  # noqa: E402
from repro_torch.lst import LakeTable  # noqa: E402
from repro_torch.lst.schema import Field, PartitionSpec, Schema  # noqa: E402
from repro_torch.lst.storage import MemoryFS, PutIfAbsentError, layer_fs  # noqa: E402
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


# ------------------------------------------------------------------- codecs
@pytest.mark.parametrize("fmt", ["delta", "iceberg", "hudi"])
def test_codecs_round_trip_replayed_entries_and_states(fmt):
    raw = MemoryFS()
    _mk_table(raw, "bkt/t", fmt, n_commits=3)
    handle = FORMATS[fmt].open(raw, "bkt/t")
    base, entries = handle.replay()

    for e in entries:
        blob = json.dumps(entry_to_json(e), sort_keys=True)
        assert entry_from_json(json.loads(blob)) == e

    st = handle.snapshot()
    blob = json.dumps(state_to_json(st), sort_keys=True)
    back = state_from_json(json.loads(blob))
    assert back.version == st.version and back.files == st.files
    assert back.schema == st.schema and back.properties == st.properties

    if base is not None:
        again = state_from_json(json.loads(
            json.dumps(state_to_json(base), sort_keys=True)))
        assert again == base


def test_seed_encode_decode_round_trip():
    raw = MemoryFS()
    _mk_table(raw, "bkt/t", "delta", n_commits=4)
    idx = TableMetadataIndex(FORMATS["delta"].open(raw, "bkt/t"))
    idx.ensure_built()
    seed = idx.snapshot_seed(2)
    assert seed is not None
    back = decode_seed(json.loads(json.dumps(encode_seed(seed))))
    assert back[0] == seed[0] and back[1] == seed[1]
    assert encode_seed(None) is None and decode_seed(None) is None


# ------------------------------------------------------------ durable store
def test_checkpoint_store_generations_and_retention():
    fs = MemoryFS()
    store = CheckpointStore(fs, "bkt/ck", retain=2)
    assert store.load() is None                       # cold start
    assert store.save({"n": 1}) == 1
    assert store.save({"n": 2}) == 2
    assert store.save({"n": 3}) == 3                  # gen 1 pruned
    assert fs.list_dir("bkt/ck") == ["gen-0000000002.json",
                                     "gen-0000000003.json"]
    gen, payload = CheckpointStore(fs, "bkt/ck").load()
    assert gen == 3 and payload["n"] == 3


def test_checkpoint_store_race_takes_distinct_generations():
    fs = MemoryFS()
    a = CheckpointStore(fs, "bkt/ck")
    b = CheckpointStore(fs, "bkt/ck")
    assert a.save({"who": "a"}) == 1
    # b never observed gen 1: its conditional put of gen 1 must LOSE and
    # land on gen 2 instead of clobbering a's document
    assert b.save({"who": "b"}) == 2
    gen, payload = CheckpointStore(fs, "bkt/ck").load()
    assert (gen, payload["who"]) == (2, "b")


def test_checkpoint_store_skips_corrupt_newest_generation():
    fs = MemoryFS()
    store = CheckpointStore(fs, "bkt/ck")
    store.save({"n": 1})
    # a crash mid-save leaves a torn newest generation
    fs.write_bytes("bkt/ck/gen-0000000002.json", b"{torn", overwrite=True)
    fresh = CheckpointStore(fs, "bkt/ck")
    gen, payload = fresh.load()
    assert (gen, payload["n"]) == (1, 1) and fresh.load_fallbacks == 1
    # ... and the next save goes PAST the torn generation, never under it
    assert fresh.save({"n": 3}) == 3


def test_checkpoint_store_put_is_conditional():
    fs = MemoryFS()
    CheckpointStore(fs, "bkt/ck").save({"n": 1})
    with pytest.raises(PutIfAbsentError):
        fs.write_bytes("bkt/ck/gen-0000000001.json", b"{}")


# ------------------------------------------------------------- index seeding
@pytest.mark.parametrize("fmt", ["delta", "iceberg", "hudi"])
def test_restore_seed_serves_states_with_zero_reads_then_tail_refresh(fmt):
    raw = MemoryFS()
    t = _mk_table(raw, "bkt/t", fmt, n_commits=6)
    live = TableMetadataIndex(FORMATS[fmt].open(raw, "bkt/t"))
    live.ensure_built()
    head = live.state_at()
    seed = live.snapshot_seed(3)
    assert seed is not None and len(seed[1]) == 3

    fs = layer_fs(raw)
    idx = TableMetadataIndex(FORMATS[fmt].open(fs, "bkt/t"))
    assert idx.restore_seed(*seed)
    before = fs.stats().requests
    st = idx.state_at(seed[1][-1].version)    # head state from the seed...
    assert fs.stats().requests == before      # ...with ZERO storage reads
    assert st.files == head.files and st.version == head.version

    _append(t, 2)                             # the table moves on
    idx.probe()
    idx.refresh()
    idx.end_cycle()
    assert idx.replays == 0                   # tail-only: never a rebuild
    assert idx.tail_replays >= 1
    assert idx.state_at().total_records() == \
        live.handle.snapshot().total_records()


def test_restore_seed_refuses_live_index_and_empty_seed():
    raw = MemoryFS()
    _mk_table(raw, "bkt/t", "delta", 2)
    idx = TableMetadataIndex(FORMATS["delta"].open(raw, "bkt/t"))
    idx.ensure_built()
    seed = idx.snapshot_seed(1)
    assert not idx.restore_seed(*seed)        # already built: live wins
    fresh = TableMetadataIndex(FORMATS["delta"].open(raw, "bkt/t"))
    assert not fresh.restore_seed(seed[0], [])


def test_divergent_rewrite_forces_rebuild_not_wrong_splice():
    raw = MemoryFS()
    _mk_table(raw, "bkt/t", "delta", n_commits=5)
    live = TableMetadataIndex(FORMATS["delta"].open(raw, "bkt/t"))
    live.ensure_built()
    seed = live.snapshot_seed(2)

    # the table is torn down and rewritten SHORTER while the daemon is off:
    # the checkpointed anchor (commit 3) no longer exists
    for name in list(raw._objects):
        if name.startswith("bkt/t/"):
            raw.delete(name)
    _mk_table(raw, "bkt/t", "delta", n_commits=2)

    idx = TableMetadataIndex(FORMATS["delta"].open(raw, "bkt/t"))
    assert idx.restore_seed(*seed)
    idx.probe()
    idx.refresh()                             # live head behind the anchor
    idx.end_cycle()
    assert idx.replays == 1                   # full rebuild, by design
    assert idx.versions() == ["0", "1", "2"]  # ... to the REAL history
    assert idx.state_at().total_records() == 4


# -------------------------------------------------------- daemon warm restart
def _restart_census(n_commits, *, warm):
    """Request census of the first daemon cycle after a restart, with 2 new
    commits landed while the daemon was down."""
    raw = MemoryFS()
    t = _mk_table(raw, "bkt/t", "delta", n_commits)
    cfg = _cfg(["bkt/t"], targets=("iceberg",),
               checkpoint={"enabled": True})
    d1 = SyncDaemon(cfg, layer_fs(raw), clock=ManualClock())
    rep = d1.run_cycle()                      # FULL bootstrap + checkpoint
    assert rep.units_drained == 1 and rep.checkpoint_gen == 1

    _append(t, 2)                             # lands while the daemon is dead
    cfg2 = cfg if warm else _cfg(["bkt/t"], targets=("iceberg",))
    d2 = SyncDaemon(cfg2, layer_fs(raw), clock=ManualClock())
    assert d2.restored_from_checkpoint is warm
    rep = d2.run_cycle()
    assert rep.units_drained == 1 and rep.commits_applied == 2
    return rep.storage_ops["requests"]


def test_warm_restart_is_o_new_commits_not_o_history():
    # the warm census is a function of the NEW commits only: growing the
    # history 8x must not move it by a single request
    warm_short = _restart_census(8, warm=True)
    warm_long = _restart_census(64, warm=True)
    assert warm_short == warm_long

    # while a cold restart rebuilds O(history) and grows with it
    cold_short = _restart_census(8, warm=False)
    cold_long = _restart_census(64, warm=False)
    assert cold_long > cold_short
    assert cold_long > 3 * warm_long


def test_restarted_daemon_converges_and_idles_cheaply():
    raw = MemoryFS()
    t = _mk_table(raw, "bkt/t", "delta", 3)
    cfg = _cfg(["bkt/t"], targets=("iceberg", "hudi"),
               checkpoint={"enabled": True}, maxCommitsPerSync=2)
    d1 = SyncDaemon(cfg, layer_fs(raw), clock=ManualClock())
    d1.run_cycle()
    _append(t, 3)
    d1.run_cycle()                            # capped: leaves a backlog
    assert d1.lag() == {"bkt/t": True}

    # restart mid-backlog: the pending flag survives, so the first cycle
    # keeps draining even though the head token did not move again
    fs2 = layer_fs(raw)
    d2 = SyncDaemon(cfg, fs2, clock=ManualClock())
    assert d2.restored_from_checkpoint
    for _ in range(4):
        rep = d2.run_cycle()
        if rep.idle:
            break
    assert not d2._pending()
    src_rows = sorted(t.read_all()["k"].tolist())
    for fmt in ("iceberg", "hudi"):
        got = LakeTable.open(raw, "bkt/t", fmt).read_all()
        assert sorted(got["k"].tolist()) == src_rows
        assert make_target(fmt, raw, "bkt/t").get_sync_token() == "6"

    # a quiet restarted table costs exactly its head probe per cycle
    before = fs2.stats().requests
    rep = d2.run_cycle()
    assert rep.quiet == 1
    assert fs2.stats().requests - before == 1


def test_checkpoint_saves_are_skipped_on_idle_cycles():
    raw = MemoryFS()
    _mk_table(raw, "bkt/t", "delta", 2)
    cfg = _cfg(["bkt/t"], checkpoint={"enabled": True})
    d = SyncDaemon(cfg, layer_fs(raw), clock=ManualClock())
    assert d.run_cycle().checkpoint_gen == 1
    for _ in range(3):
        rep = d.run_cycle()
        assert rep.idle and rep.checkpoint_gen is None
    assert d._ckpt.saves == 1


def test_checkpoint_config_block_parses_and_validates():
    cfg = _cfg(["bkt/t"], checkpoint={
        "enabled": True, "path": "bkt/ck", "intervalCycles": 2,
        "retain": 5, "minWindow": 8})
    ck = cfg.checkpoint
    assert ck.enabled and ck.path == "bkt/ck" and ck.interval_cycles == 2
    assert ck.retain == 5 and ck.min_window == 8
    assert not _cfg(["bkt/t"]).checkpoint.enabled
    with pytest.raises(ValueError):
        _cfg(["bkt/t"], checkpoint={"retain": 0})
    d = SyncDaemon(cfg, layer_fs(MemoryFS()), clock=ManualClock())
    assert d._ckpt.base_path == "bkt/ck"


def test_corrupt_checkpoint_degrades_to_cold_start():
    raw = MemoryFS()
    _mk_table(raw, "bkt/t", "delta", 2)
    cfg = _cfg(["bkt/t"], checkpoint={"enabled": True})
    d1 = SyncDaemon(cfg, layer_fs(raw), clock=ManualClock())
    d1.run_cycle()
    # poison the payload *content* (valid JSON, wrong shapes)
    path = d1._ckpt._path(1)
    raw.write_bytes(path, json.dumps(
        {"version": 1, "sourceFormat": "delta",
         "tables": {"bkt/t": {"watch": {"token": "1"},
                              "seed": {"base": {"bogus": 1},
                                       "entries": []}}}}).encode(),
        overwrite=True)
    d2 = SyncDaemon(cfg, layer_fs(raw), clock=ManualClock())
    assert not d2.restored_from_checkpoint
    rep = d2.run_cycle()                      # cold, but correct
    assert rep.table_errors == 0 and rep.quiet + rep.changed == 1
