"""Port copy of ``tests/test_chaos.py``: the same tests and bounds,
run against ``repro_torch`` (only the import prefix differs).

Deterministic crash-point chaos campaign.

A :class:`CrashSchedule` armed on a :class:`SimulatedObjectStore` kills the
"process" at an exact 1-based request index — every later request dies too,
so the store is left holding exactly the applied prefix of the request
stream, like SIGKILL would.  The campaign here:

1. records a *golden* run — a daemon draining a 4-commit backlog into the
   target formats over an unarmed store — and its total request count R;
2. for EVERY request index n in 1..R, replays the same drain on a fresh
   clone of the pre-drain store with a crash armed at n, confirms the
   crash fires, then restarts a fresh daemon (checkpoint restore + live
   head re-verification) over the survivor store and drives it to idle;
3. asserts the recovered targets converge to the golden rows and sync
   token — for every crash point, for all three target formats.

``after_apply=True`` schedules are the torn-write variant: the fatal PUT
*lands* but the caller dies before the response — covering the
crash-between-staged-flush-and-commit-point and crash-after-commit-point
windows explicitly.

Everything runs on ``pipeline_depth=1`` + a manual clock, so the request
stream is fully serial and the sweep is deterministic request-for-request.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import ManualClock, SyncConfig, SyncDaemon  # noqa: E402
from repro_torch.core.targets import make_target  # noqa: E402
from repro_torch.lst import LakeTable  # noqa: E402
from repro_torch.lst.schema import Field, PartitionSpec, Schema  # noqa: E402
from repro_torch.lst.storage import (CrashSchedule, MemoryFS, SimulatedCrash,  # noqa: E402
                                     SimulatedObjectStore, StorageProfile, layer_fs)

torch.set_num_threads(2)

SCHEMA = Schema([Field("k", "int64"), Field("part", "string")])


def _mk_table(fs, base, fmt="delta", n_commits=3):
    t = LakeTable.create(fs, base, SCHEMA, fmt, PartitionSpec(["part"]),
                         {"delta.checkpointInterval": "100000"})
    for i in range(n_commits):
        t.append({"k": np.array([i, i + 100], np.int64),
                  "part": np.array([f"p{i % 2}", "p0"])})
    return t


def _cfg(src, targets):
    return SyncConfig.from_dict({
        "sourceFormat": src.upper(),
        "targetFormats": [t.upper() for t in targets],
        "datasets": [{"tableBasePath": "bkt/t"}],
        "maxCommitsPerSync": 2,          # the drain spans multiple cycles
        "checkpoint": {"enabled": True},
    })


def _serial_store(base):
    return SimulatedObjectStore(base.clone(),
                                StorageProfile(pipeline_depth=1))


def _drive_to_idle(cfg, sim, max_cycles=12):
    d = SyncDaemon(cfg, layer_fs(sim), clock=ManualClock())
    for _ in range(max_cycles):
        if d.run_cycle().idle:
            return d
    raise AssertionError("daemon never idled")


def _target_digest(fs, targets):
    """(rows, sync token) per target — the convergence fingerprint."""
    out = {}
    for fmt in targets:
        rows = LakeTable.open(fs, "bkt/t", fmt).read_all()
        key = sorted(zip(rows["k"].tolist(), rows["part"].tolist()))
        out[fmt] = (key, make_target(fmt, fs, "bkt/t").get_sync_token())
    return out


def _campaign_base(src, targets):
    """Pre-drain store: table pre-synced once (checkpoint gen 1 durable),
    then 4 fresh commits land while the daemon is 'down'."""
    raw = MemoryFS()
    t = _mk_table(raw, "bkt/t", src, n_commits=1)
    cfg = _cfg(src, targets)
    d = SyncDaemon(cfg, layer_fs(raw), clock=ManualClock())
    assert d.run_cycle().units_drained == len(targets)
    for i in range(4):
        t.append({"k": np.array([10 + i], np.int64),
                  "part": np.array(["p1"])})
    return raw, cfg


def _sweep(src, targets, *, after_apply=False):
    base, cfg = _campaign_base(src, targets)

    # golden arm: the same drain, no crash
    golden_sim = _serial_store(base)
    _drive_to_idle(cfg, golden_sim)
    golden = _target_digest(golden_sim.inner, targets)
    total = golden_sim.requests
    assert total > 30        # the sweep actually covers a real drain

    for n in range(1, total + 1):
        sim = _serial_store(base)
        sim.arm_crash(CrashSchedule(n, after_apply=after_apply))
        try:
            _drive_to_idle(cfg, sim)
            died = False
        except SimulatedCrash:
            died = True
        assert died and sim.crashed, f"crash at request {n} never fired"

        # restart over the survivor store: checkpoint restore + live-head
        # re-verification must converge to the golden state, byte for byte
        sim.arm_crash(None)
        recovered = SimulatedObjectStore(sim.inner,
                                         StorageProfile(pipeline_depth=1))
        _drive_to_idle(cfg, recovered)
        got = _target_digest(recovered.inner, targets)
        assert got == golden, f"divergence after crash at request {n}"
    return total


# ------------------------------------------------------------ schedule units
def test_crash_fires_at_exact_request_index():
    sim = SimulatedObjectStore(MemoryFS(), StorageProfile(pipeline_depth=1))
    sim.write_bytes("bkt/a", b"1")
    sim.arm_crash(CrashSchedule(3))           # counter keeps running: dies
    sim.read_bytes("bkt/a")                   # at global request 3
    with pytest.raises(SimulatedCrash):
        sim.read_bytes("bkt/a")
    assert sim.crashed
    # ... and the process STAYS dead: later requests die too
    with pytest.raises(SimulatedCrash):
        sim.exists("bkt/a")
    assert sim.requests == 4


def test_pre_apply_crash_leaves_no_object_torn_write_leaves_one():
    sim = SimulatedObjectStore(MemoryFS(), StorageProfile(pipeline_depth=1))
    sim.arm_crash(CrashSchedule(1))
    with pytest.raises(SimulatedCrash):
        sim.write_bytes("bkt/a", b"1")
    assert not sim.inner.exists("bkt/a")      # rejected before applying

    sim2 = SimulatedObjectStore(MemoryFS(), StorageProfile(pipeline_depth=1))
    sim2.arm_crash(CrashSchedule(1, after_apply=True))
    with pytest.raises(SimulatedCrash):
        sim2.write_bytes("bkt/a", b"1")
    assert sim2.inner.read_bytes("bkt/a") == b"1"   # landed, response lost


def test_disarm_resurrects_the_store():
    sim = SimulatedObjectStore(MemoryFS(), StorageProfile(pipeline_depth=1))
    sim.arm_crash(CrashSchedule(1))
    with pytest.raises(SimulatedCrash):
        sim.exists("x")
    sim.arm_crash(None)
    assert not sim.crashed and sim.exists("x") is False


def test_crash_rips_through_write_many_pipeline():
    sim = SimulatedObjectStore(MemoryFS(), StorageProfile(pipeline_depth=4))
    sim.arm_crash(CrashSchedule(3))
    with pytest.raises(SimulatedCrash):
        sim.write_many([(f"bkt/f{i}", b"x") for i in range(8)])
    # the applied prefix is bounded by the crash point
    assert len([p for p in range(8) if sim.inner.exists(f"bkt/f{p}")]) <= 2


def test_schedule_validates_index():
    with pytest.raises(ValueError):
        CrashSchedule(0)


# -------------------------------------------------------------- the campaign
def test_campaign_delta_to_iceberg_and_hudi_every_crash_point():
    total = _sweep("delta", ("iceberg", "hudi"))
    assert total > 50


def test_campaign_hudi_to_delta_every_crash_point():
    _sweep("hudi", ("delta",))


@pytest.mark.slow
def test_campaign_torn_writes_every_crash_point():
    # the after_apply variant: every PUT in the stream is also exercised as
    # a torn write (applied, response lost) — commit-point and staged-flush
    # objects land without their writer surviving to record them
    _sweep("delta", ("iceberg",), after_apply=True)
    _sweep("hudi", ("delta",), after_apply=True)
