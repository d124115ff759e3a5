"""Continuous sync through the port: a copy of ``examples/continuous_sync.py``
that drives ``repro_torch``'s daemon (only the import prefix differs).

The daemon never touches a tensor, so this runs on the CPU.

A table written in one format is readable in any other "with negligible
overhead" only if translation keeps up with the writer.  This example runs
the :class:`~repro_torch.core.daemon.SyncDaemon` as that companion process: a
scripted Hudi writer appends against an ``s3sim://`` object store while
the daemon's watch -> replan -> drain cycles keep Delta and Iceberg
targets fresh, then the daemon drains the tail gracefully and stops.
Ctrl-C at any point is a *graceful* stop: the daemon finishes the backlog
before exiting instead of dying mid-drain.

Usage::

    PYTHONPATH=src python examples/torch_continuous_sync.py
    PYTHONPATH=src python examples/torch_continuous_sync.py --workers 4
    PYTHONPATH=src python examples/torch_continuous_sync.py --restart

    # the same daemon, driven from your own code:
    from repro_torch.core import SyncConfig, SyncDaemon, run_daemon

    config = SyncConfig.from_yaml('''
    sourceFormat: HUDI
    targetFormats: [DELTA, ICEBERG]
    datasets:
      - tableBasePath: s3sim://warehouse/events
    checkpoint:
      enabled: true               # durable warm-restart state (see --restart)
    daemon:
      pollIntervalMs: 1000        # watch cadence
      maxCyclesIdle: 30           # exit after 30 quiet cycles (omit: forever)
      backoff: {baseDelayMs: 200, maxDelayMs: 30000}   # per-table 503 backoff
    ''')

    reports = run_daemon(config, cycles=100)   # bounded run, or:
    daemon = SyncDaemon(config)                # long-lived service object
    daemon.run()                               # ... until daemon.stop()
    daemon.stop(drain=True)                    # finish the backlog, then stop

Each cycle probes every source head with ONE cheap request (delta log-tail
listing / iceberg version-hint read / hudi newest-instant listing), replans
only tables whose head moved or that still carry a capped backlog, and
drains them through the transactional executor path — a quiet table costs
exactly its head probe.  ``maxCommitsPerSync`` bounds each cycle's drain;
a transient storage error backs off the one affected table with jittered
exponential delays while every other table keeps syncing.

``--workers N`` (N > 1) runs the same cycles through the sharded sync
fleet (``core/fleet.py``): probes and planning fan out over N worker
threads, and the planned (dataset, target) cells drain through per-worker
shard queues — most-urgent-first, with work stealing.  Equivalent to a
``fleet: {workers: N}`` block in the config.

``--restart`` demonstrates crash-safe warm restarts: the daemon is killed
mid-drain (abandoned with a capped backlog, like a power cut), the writer
keeps appending while it is down, and then two restarted daemons race over
clones of the surviving store — one resuming from the durable checkpoint,
one cold — printing the request census of each.  The warm restart replays
only the commits that landed since the last checkpoint (O(new commits));
the cold one rebuilds the whole source index (O(history)).
"""

import argparse
import sys

sys.path.insert(0, "src")

args = argparse.ArgumentParser(description="continuous-sync daemon demo")
args.add_argument("--workers", type=int, default=1,
                  help="fleet width; >1 engages the sharded fleet cycle path")
args.add_argument("--restart", action="store_true",
                  help="kill the daemon mid-drain, then race a checkpoint "
                       "warm restart against a cold one")
args = args.parse_args()

import numpy as np

from repro_torch.core import FleetOptions, SyncConfig, SyncDaemon, Telemetry
from repro_torch.lst import LakeTable
from repro_torch.lst.schema import Field, PartitionSpec, Schema
from repro_torch.lst.storage import layer_fs, shared_store

BASE = "warehouse/events"

# --- the writer's side: a Hudi table on the simulated object store --------
store = shared_store("s3sim")          # the bucket namespace s3sim:// resolves to
schema = Schema([Field("event_id", "int64"), Field("kind", "string")])
events = LakeTable.create(store, BASE, schema, "hudi", PartitionSpec(["kind"]))
events.append({"event_id": np.array([1, 2, 3]),
               "kind": np.array(["view", "view", "buy"])})

# --- the daemon's side: Listing-2 config + a daemon block -----------------
_YAML = """
sourceFormat: HUDI
targetFormats:
  - DELTA
  - ICEBERG
datasets:
  -
    tableBasePath: s3sim://warehouse/events
maxCommitsPerSync: 2
checkpoint:
  enabled: {ckpt}
daemon:
  pollIntervalMs: 50
  backoff: {{baseDelayMs: 100}}
"""
config = SyncConfig.from_yaml(_YAML.format(ckpt="true"))
telemetry = Telemetry()
daemon = SyncDaemon(config, telemetry=telemetry,
                    fleet=FleetOptions(workers=args.workers))
if args.workers > 1:
    print(f"== sharded fleet: {args.workers} workers "
          f"({daemon.fleet_opts.shard_strategy}-sharded, "
          f"{daemon.fleet_opts.scheduler} scheduling)")

rng = np.random.default_rng(0)


def _burst(n, rows=4):
    for _ in range(n):
        events.append({"event_id": rng.integers(100, 1000, rows),
                       "kind": np.array(["view", "buy", "view", "view"][:rows])})


def _verify(fs, label=""):
    want = sorted(events.read_all()["event_id"].tolist())
    for fmt in ("hudi", "delta", "iceberg"):
        got = sorted(LakeTable.open(fs, BASE, fmt).read_all()
                     ["event_id"].tolist())
        marker = "ok" if got == want else "MISMATCH"
        print(f"{fmt:8s} sees {len(got)} rows via shared data files "
              f"[{marker}]{label}")
        assert got == want, fmt


def _drain_to_idle(d):
    """Cycle until idle; returns (cycles, total requests, first report)."""
    reqs = cycles = 0
    first = None
    while True:
        rep = d.run_cycle()
        first = first or rep
        cycles += 1
        reqs += (rep.storage_ops or {}).get("requests", 0)
        if rep.idle:
            return cycles, reqs, first


# --- scripted workload: appends interleaved with daemon cycles ------------
# Ctrl-C anywhere below falls through to the graceful drain-stop: the
# in-flight cycle completes (commits are atomic puts), the backlog drains,
# and only then does the process exit.
interrupted = False
try:
    print("== bootstrap cycle (FULL sync into both targets)")
    print("  ", daemon.run_cycle().summary())

    for round_no in range(3):
        _burst(round_no + 1)                   # growing burst each round
        rep = daemon.run_cycle()
        print(f"== round {round_no}: writer appended {round_no + 1} commits")
        print("  ", rep.summary())
        if rep.lag:
            print("   lag:", {f"{d}->{t}": n for (d, t), n in rep.lag.items()})
except KeyboardInterrupt:
    interrupted = True
    print("\n== SIGINT: draining the backlog before exit (Ctrl-C again to "
          "abort hard)")

print("== graceful stop: drain whatever backlog is left, then halt")
daemon.stop(drain=True)
for rep in daemon.run():
    print("  ", rep.summary())
daemon.close()

# --- proof: all three formats read the same rows --------------------------
_verify(store)

print("\ndaemon telemetry counters:", {
    k: v for k, v in telemetry.summary().items() if k.startswith("daemon.")})

# --- the --restart arm: power cut mid-drain, then warm vs cold restart ----
if args.restart and not interrupted:
    print("\n== restart demo: deepen the history, then cut the power")
    _burst(12)
    d1 = SyncDaemon(config)                    # restores, then drains the 12
    while not d1.run_cycle().idle:
        pass
    _burst(3)
    rep = d1.run_cycle()                       # capped cycle: backlog remains
    print("   mid-drain report:", rep.summary())
    del d1                                     # the power cut: no stop(), no
    _burst(2)                                  # drain; writer keeps going

    snap = store.clone()                       # both arms see the same wreck
    warm_fs, cold_fs = layer_fs(snap.clone()), layer_fs(snap.clone())

    warm = SyncDaemon(config, warm_fs)
    print(f"   warm restart: restored_from_checkpoint="
          f"{warm.restored_from_checkpoint}")
    w_cycles, w_reqs, w_first = _drain_to_idle(warm)

    cold = SyncDaemon(SyncConfig.from_yaml(_YAML.format(ckpt="false")),
                      cold_fs)
    c_cycles, c_reqs, c_first = _drain_to_idle(cold)

    print(f"   warm: {w_cycles} cycles, {w_reqs} storage requests "
          f"(first cycle drained {w_first.commits_applied} commits)")
    print(f"   cold: {c_cycles} cycles, {c_reqs} storage requests "
          f"(rebuilt the whole source index first)")
    print(f"   resumed-vs-cold census: {w_reqs} vs {c_reqs} requests "
          f"({c_reqs / max(1, w_reqs):.1f}x) — O(new commits) vs O(history)")
    assert warm.restored_from_checkpoint and w_reqs < c_reqs
    _verify(warm_fs, label="  (warm-restart arm)")
