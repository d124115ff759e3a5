# Copy of repro/lst/__init__.py; the port imports nothing of repro.
"""Log-Structured Table (LST) substrate.

Implements the storage layer the paper's translator operates over:

* ``storage``   — pluggable storage backends with object-store semantics
                  (put-if-absent atomic creates are the commit primitive, as
                  on ABFS/S3/GCS; batched metadata fetch; latency/fault
                  simulation; retry policy; scheme registry).  ``fs`` is the
                  back-compat shim over it.
* ``chunkfile`` — the immutable columnar data-file format (plays the role Parquet
                  plays in the paper: column chunks + footer statistics).
* ``delta``     — Delta-Lake-style JSON action log (``_delta_log/NNNN.json``).
* ``iceberg``   — Iceberg-style snapshot / manifest-list / manifest chain.
* ``hudi``      — Hudi-style timeline of instants (``.hoodie/<ts>.commit``).
* ``table``     — the "engine" role: scan with stats-based file pruning, append,
                  copy-on-write delete, time travel, over any of the formats.
"""

from repro_torch.lst.storage import (FileSystem, LocalFS, MemoryFS, RetryingFS,
                               RetryPolicy, SimulatedObjectStore,
                               StorageProfile, make_fs)
from repro_torch.lst.chunkfile import (write_chunk, read_chunk, read_chunk_stats,
                                 read_chunks_stats, read_chunks_footers,
                                 read_chunks_columns, ChunkFooter,
                                 DataFileMeta)
from repro_torch.lst import delta, iceberg, hudi
from repro_torch.lst.table import LakeTable, FORMATS

__all__ = [
    "LocalFS", "MemoryFS", "SimulatedObjectStore", "StorageProfile",
    "RetryingFS", "RetryPolicy", "FileSystem", "make_fs",
    "write_chunk", "read_chunk", "read_chunk_stats", "read_chunks_stats",
    "read_chunks_footers", "read_chunks_columns", "ChunkFooter",
    "DataFileMeta", "delta", "iceberg", "hudi", "LakeTable", "FORMATS",
]
