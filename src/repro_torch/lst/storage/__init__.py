# Copy of repro/lst/storage/__init__.py; the port imports nothing of repro.
"""Pluggable storage backends with object-store semantics.

The storage subsystem behind every LST handle (ROADMAP "Storage backends"):

* ``base``         — the widened ``FileSystem`` protocol (batch reads,
                     ranged reads, conditional puts) and the error taxonomy
                     (``PutIfAbsentError`` / ``TransientStorageError``).
* ``local``        — POSIX-backed ``LocalFS`` (atomic staged writes).
* ``memory``       — in-memory ``MemoryFS`` object store.
* ``simulated``    — ``SimulatedObjectStore`` decorator: per-request RTT,
                     probabilistic 503s, pipelined batch reads.
* ``retry``        — ``RetryPolicy`` / ``RetryingFS``: exponential backoff
                     with a retry-safe put-if-absent.
* ``instrumented`` — ``InstrumentedFS``: request/byte/retry counters feeding
                     ``Telemetry``, with per-thread scoping for per-unit
                     request censuses.
* ``registry``     — URI-scheme registry: ``make_fs``, ``resolve_uri``,
                     ``layer_fs`` stack composition.
"""

from repro_torch.lst.storage.base import (FileSystem, PutIfAbsentError,
                                    SequentialBatchMixin, SimulatedCrash,
                                    StorageRetryExhausted,
                                    TransientStorageError, fetch_many,
                                    fetch_many_ranges, flush_many, join,
                                    latency_bound)
from repro_torch.lst.storage.instrumented import InstrumentedFS, StorageStats
from repro_torch.lst.storage.local import LocalFS
from repro_torch.lst.storage.memory import MemoryFS
from repro_torch.lst.storage.registry import (clear_shared_stores, layer_fs,
                                        make_fs, register_scheme,
                                        resolve_uri, scheme_of, shared_store,
                                        split_uri)
from repro_torch.lst.storage.retry import RetryingFS, RetryPolicy
from repro_torch.lst.storage.simulated import (CrashSchedule, SimulatedObjectStore,
                                         StorageProfile)

__all__ = [
    "FileSystem", "PutIfAbsentError", "TransientStorageError",
    "StorageRetryExhausted", "SimulatedCrash", "CrashSchedule",
    "SequentialBatchMixin", "fetch_many",
    "fetch_many_ranges", "flush_many", "join", "latency_bound", "LocalFS",
    "MemoryFS",
    "SimulatedObjectStore", "StorageProfile", "RetryingFS", "RetryPolicy",
    "InstrumentedFS", "StorageStats", "make_fs", "register_scheme",
    "resolve_uri", "scheme_of", "split_uri", "layer_fs", "shared_store",
    "clear_shared_stores",
]
