# Copy of repro/core/__init__.py; the port imports nothing of repro.
"""XTABLE core: omni-directional, incremental LST metadata translation.

The paper's contribution, implemented as described in §3: source readers and
target writers around a unified internal representation, orchestrated as an
explicit plan -> shared-metadata-cache -> concurrent-execute pipeline (see
``plan.py`` / ``metadata_cache.py`` / ``executor.py``; ``sync.py`` is the
facade with persisted state, caching, and telemetry).

Around that pipeline live the operational layers: the continuous-sync
daemon and sharded fleet (``daemon.py`` / ``fleet.py``), durable warm-
restart checkpoints (``checkpoint.py``), per-table circuit breakers
(``health.py``), and the per-cycle atomic catalog group publish
(``lst/catalog/``, wired through the daemon's ``catalog:`` block).
``docs/config.md`` is the consolidated reference for every config knob.
"""

from repro_torch.core.checkpoint import CheckpointStore
from repro_torch.core.config import (CatalogOptions, CheckpointOptions,
                                     DaemonOptions, DatasetConfig, FleetOptions,
                                     HealthOptions, ReadPlaneOptions,
                                     StorageOptions, SyncConfig)
from repro_torch.core.daemon import (DaemonCycleReport, ManualClock, SyncDaemon,
                                     SystemClock, run_daemon)
from repro_torch.core.executor import SyncExecutor
from repro_torch.core.fleet import (CommitRateEstimator, LagAwareScheduler,
                                    SyncFleet)
from repro_torch.core.health import HealthTracker
from repro_torch.core.ir import (InternalDataFile, InternalSnapshot, InternalTable,
                                 TableChange, fold_changes)
from repro_torch.core.metadata_cache import MetadataCache, TableMetadataIndex
from repro_torch.core.plan import SyncPlan, SyncPlanner, SyncUnit
from repro_torch.core.sources import make_source
from repro_torch.core.sync import SyncResult, XTableSyncer, run_sync
from repro_torch.core.targets import make_target
from repro_torch.core.telemetry import Telemetry

__all__ = ["CatalogOptions", "CheckpointOptions", "CheckpointStore",
           "DaemonOptions",
           "DatasetConfig", "FleetOptions", "HealthOptions",
           "HealthTracker", "ReadPlaneOptions", "StorageOptions",
           "SyncConfig",
           "InternalDataFile", "InternalSnapshot", "InternalTable",
           "TableChange", "fold_changes", "make_source", "make_target",
           "run_sync", "SyncResult", "XTableSyncer", "Telemetry", "SyncPlan",
           "SyncPlanner", "SyncUnit", "SyncExecutor", "MetadataCache",
           "TableMetadataIndex", "DaemonCycleReport", "ManualClock",
           "SyncDaemon", "SystemClock", "run_daemon",
           "CommitRateEstimator", "LagAwareScheduler", "SyncFleet"]
