# Copy of repro/lst/storage/instrumented.py; the port imports nothing of repro.
"""Instrumented FileSystem: request/byte/retry counters feeding Telemetry.

Outermost wrapper of the storage stack (see ``registry.build_fs``): it
counts *logical* storage requests — what the sync architecture asked the
store for, independent of how many physical attempts the retry layer made —
per category (get/put/list/head/delete) plus bytes moved, and mirrors the
totals into the run's :class:`~repro_torch.core.telemetry.Telemetry` counters
(``storage.get``, ``storage.put``, ...).

Counters are also tracked **per thread**, and one sync unit runs entirely
on one executor thread, so ``scoped()`` gives the executor an exact
per-unit request census — the number the O(1)-target-reads /
O(new-commits)-source-reads guarantees are asserted against in tier-1.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Sequence

from repro_torch.lst.storage.base import flush_many

COUNT_KEYS = ("get", "put", "list", "head", "delete",
              "bytes_read", "bytes_written")


class StorageStats:
    """A plain counter bag; ``requests`` sums the request categories."""

    __slots__ = COUNT_KEYS

    def __init__(self, **kw):
        for k in COUNT_KEYS:
            setattr(self, k, kw.get(k, 0))

    @property
    def requests(self) -> int:
        return self.get + self.put + self.list + self.head + self.delete

    def as_dict(self) -> dict:
        d = {k: getattr(self, k) for k in COUNT_KEYS}
        d["requests"] = self.requests
        return d

    def __repr__(self):
        return f"StorageStats({self.as_dict()})"


class InstrumentedFS:
    """Count every request (and the bytes it moved) on the way through."""

    def __init__(self, inner, telemetry=None):
        self.inner = inner
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._total = StorageStats()
        self._tls = threading.local()

    # -- counting core -----------------------------------------------------
    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            setattr(self._total, key, getattr(self._total, key) + n)
        scope = getattr(self._tls, "scope", None)
        if scope is not None:
            setattr(scope, key, getattr(scope, key) + n)
        if self.telemetry is not None:
            self.telemetry.bump(f"storage.{key}", n)

    def stats(self) -> StorageStats:
        with self._lock:
            snap = StorageStats(**{k: getattr(self._total, k)
                                   for k in COUNT_KEYS})
        return snap

    def retries(self) -> int:
        """Transient failures absorbed by a retry layer below, if any."""
        fs = self.inner
        while fs is not None:
            r = getattr(fs, "retries", None)
            if isinstance(r, int):
                return r
            fs = getattr(fs, "inner", None)
        return 0

    @contextmanager
    def scoped(self):
        """Collect this thread's requests for the duration of the block."""
        prev = getattr(self._tls, "scope", None)
        scope = StorageStats()
        self._tls.scope = scope
        try:
            yield scope
        finally:
            self._tls.scope = prev

    # -- reads ------------------------------------------------------------
    def read_bytes(self, path: str) -> bytes:
        self._bump("get")
        data = self.inner.read_bytes(path)
        self._bump("bytes_read", len(data))
        return data

    def read_bytes_range(self, path: str, offset: int, length: int) -> bytes:
        self._bump("get")
        data = self.inner.read_bytes_range(path, offset, length)
        self._bump("bytes_read", len(data))
        return data

    def read_many(self, paths: Sequence[str]) -> list[bytes]:
        paths = list(paths)
        self._bump("get", len(paths))
        out = self.inner.read_many(paths)
        self._bump("bytes_read", sum(len(b) for b in out))
        return out

    def read_many_ranges(
            self, requests: Sequence[tuple[str, int, int]]) -> list[bytes]:
        requests = list(requests)
        self._bump("get", len(requests))
        out = self.inner.read_many_ranges(requests)
        self._bump("bytes_read", sum(len(b) for b in out))
        return out

    def exists(self, path: str) -> bool:
        self._bump("head")
        return self.inner.exists(path)

    def list_dir(self, path: str) -> list[str]:
        self._bump("list")
        return self.inner.list_dir(path)

    def size(self, path: str) -> int:
        self._bump("head")
        return self.inner.size(path)

    # -- writes -----------------------------------------------------------
    def write_bytes(self, path: str, data: bytes, *, overwrite: bool = False) -> None:
        self._bump("put")
        self._bump("bytes_written", len(data))
        self.inner.write_bytes(path, data, overwrite=overwrite)

    def write_many(self, items: Sequence[tuple[str, bytes]], *,
                   overwrite: bool = False) -> None:
        items = list(items)
        self._bump("put", len(items))
        self._bump("bytes_written", sum(len(d) for _, d in items))
        flush_many(self.inner, items, overwrite=overwrite)

    def delete(self, path: str) -> None:
        self._bump("delete")
        self.inner.delete(path)
