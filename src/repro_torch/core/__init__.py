# Copy of repro/core/__init__.py, less four modules; the port imports nothing of repro.
"""XTABLE core: omni-directional, incremental LST metadata translation.

The paper's contribution, implemented as described in §3: source readers and
target writers around a unified internal representation, orchestrated as an
explicit plan -> shared-metadata-cache -> concurrent-execute pipeline (see
``plan.py`` / ``metadata_cache.py`` / ``executor.py``; ``sync.py`` is the
facade with persisted state, caching, and telemetry).

The port carries this pipeline, which is what a checkpoint save runs to
translate its commit.  The reference's operational layers around it — the
continuous-sync daemon and sharded fleet (``daemon.py`` / ``fleet.py``),
durable warm-restart checkpoints (``checkpoint.py``) and per-table circuit
breakers (``health.py``) — are not on the serving path and are not copied
yet; their config blocks still parse (``config.py``).
"""

from repro_torch.core.config import (CatalogOptions, CheckpointOptions,
                                     DaemonOptions, DatasetConfig,
                                     FleetOptions, HealthOptions,
                                     ReadPlaneOptions, StorageOptions,
                                     SyncConfig)
from repro_torch.core.executor import SyncExecutor
from repro_torch.core.ir import (InternalDataFile, InternalSnapshot,
                                 InternalTable, TableChange, fold_changes)
from repro_torch.core.metadata_cache import MetadataCache, TableMetadataIndex
from repro_torch.core.plan import SyncPlan, SyncPlanner, SyncUnit
from repro_torch.core.sources import make_source
from repro_torch.core.sync import SyncResult, XTableSyncer, run_sync
from repro_torch.core.targets import make_target
from repro_torch.core.telemetry import Telemetry

__all__ = ["CatalogOptions", "CheckpointOptions", "DaemonOptions",
           "DatasetConfig", "FleetOptions", "HealthOptions",
           "ReadPlaneOptions", "StorageOptions", "SyncConfig",
           "InternalDataFile", "InternalSnapshot", "InternalTable",
           "TableChange", "fold_changes", "make_source", "make_target",
           "run_sync", "SyncResult", "XTableSyncer", "Telemetry", "SyncPlan",
           "SyncPlanner", "SyncUnit", "SyncExecutor", "MetadataCache",
           "TableMetadataIndex"]
