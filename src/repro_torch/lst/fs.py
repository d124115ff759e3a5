# Copy of repro/lst/fs.py; the port imports nothing of repro.
"""Back-compat shim over :mod:`repro_torch.lst.storage`.

The storage layer grew from this single module into the ``lst/storage/``
subsystem (protocol + local / memory / simulated backends, retry policy,
instrumentation, URI-scheme registry).  Existing imports keep working from
here; new code should import from ``repro_torch.lst.storage``.
"""

from __future__ import annotations

from repro_torch.lst.storage import (FileSystem, InstrumentedFS, LocalFS, MemoryFS,
                               PutIfAbsentError, RetryingFS, RetryPolicy,
                               SequentialBatchMixin, SimulatedObjectStore,
                               StorageProfile, StorageRetryExhausted,
                               TransientStorageError, fetch_many,
                               fetch_many_ranges, flush_many, join, make_fs,
                               resolve_uri, scheme_of, split_uri)

__all__ = [
    "FileSystem", "LocalFS", "MemoryFS", "SimulatedObjectStore",
    "StorageProfile", "RetryingFS", "RetryPolicy", "InstrumentedFS",
    "PutIfAbsentError", "TransientStorageError", "StorageRetryExhausted",
    "SequentialBatchMixin", "fetch_many", "fetch_many_ranges", "flush_many",
    "join", "make_fs", "resolve_uri", "scheme_of", "split_uri",
    "strip_scheme",
]


def strip_scheme(path: str) -> str:
    """Deprecated alias of :func:`repro_torch.lst.storage.resolve_uri`.

    The old implementation dropped the authority for every scheme, so two
    buckets with the same key path collided; resolution now goes through
    the scheme registry, which keeps the bucket/container as the leading
    path component for object-store schemes.
    """
    return resolve_uri(path)
