# Copy of repro/lst/storage/retry.py; the port imports nothing of repro.
"""Retry layer: exponential backoff + a retry-safe put-if-absent.

Transient object-store failures (503 SlowDown, dropped responses) are a
fact of life the "negligible overhead" claim has to survive.  Reads and
listings are idempotent — retrying them is trivially safe.  The subtle case
is the conditional put every LST commit is built on: after a transient
failure the request *may have applied* (the response was lost), so a retry
can come back ``PutIfAbsentError`` for one of two very different reasons:

1. **our own earlier attempt landed** — the commit SUCCEEDED; surfacing a
   conflict would make the writer re-commit the same change under a new
   version (duplicate commit);
2. **a concurrent writer actually won the race** — a genuine conflict the
   commit protocol must see so it can re-sync and take the next version.

``RetryingFS.write_bytes`` disambiguates by reading the object back: if the
content equals what we were writing, case 1 — report success; otherwise
case 2 — re-raise the conflict.  (Object payloads embed writer-unique data
— commit timestamps, snapshot UUIDs — so byte-equality identifies the
author, the same trick real lakehouse clients use with ETag comparison.)
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Sequence

from repro_torch.lst.storage.base import (PutIfAbsentError, StorageRetryExhausted,
                                    TransientStorageError)


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: delay(k) = min(max_delay, base * multiplier^k)."""
    max_attempts: int = 5
    base_delay_s: float = 0.01
    multiplier: float = 2.0
    max_delay_s: float = 1.0

    def delay(self, attempt: int) -> float:
        return min(self.max_delay_s,
                   self.base_delay_s * (self.multiplier ** attempt))


class RetryingFS:
    """Wrap a FileSystem so transient failures are retried with backoff.

    ``sleep`` is injectable so tests drive the policy without wall-clock
    waits.  ``retries`` counts the transient failures absorbed (the number
    the instrumented wrapper reports into telemetry).
    """

    def __init__(self, inner, policy: RetryPolicy | None = None,
                 *, sleep: Callable[[float], None] = time.sleep):
        self.inner = inner
        self.policy = policy or RetryPolicy()
        self._sleep = sleep
        self.retries = 0
        self._count_lock = threading.Lock()   # executor threads share this fs

    def _note_retries(self, n: int = 1) -> None:
        with self._count_lock:
            self.retries += n

    # -- core retry loop ---------------------------------------------------
    def _with_retries(self, op: str, fn):
        last: Exception | None = None
        for attempt in range(self.policy.max_attempts):
            try:
                return fn()
            except TransientStorageError as e:
                last = e
                self._note_retries()
                if attempt + 1 < self.policy.max_attempts:
                    self._sleep(self.policy.delay(attempt))
        raise StorageRetryExhausted(
            f"{op} failed after {self.policy.max_attempts} attempts") from last

    # -- reads (idempotent: plain retry) -----------------------------------
    def read_bytes(self, path: str) -> bytes:
        return self._with_retries("GET", lambda: self.inner.read_bytes(path))

    def read_bytes_range(self, path: str, offset: int, length: int) -> bytes:
        return self._with_retries(
            "GET", lambda: self.inner.read_bytes_range(path, offset, length))

    def read_many(self, paths: Sequence[str]) -> list[bytes]:
        return self._batch_with_retries(
            list(paths), getattr(self.inner, "read_many_settled", None),
            self.inner.read_many)

    def read_many_ranges(
            self, requests: Sequence[tuple[str, int, int]]) -> list[bytes]:
        return self._batch_with_retries(
            list(requests),
            getattr(self.inner, "read_many_ranges_settled", None),
            self.inner.read_many_ranges)

    def _batch_with_retries(self, items: list, settled_fn, plain_fn):
        """Batch reads with per-item retries.

        When the backend exposes a *settled* variant (per-item outcomes),
        only the transiently-failed items are refetched each round — a
        throttled 64-object fan-out retries its handful of 503s, not the
        whole batch (whose all-clean probability decays geometrically in
        batch size).  Otherwise the whole batch is retried.
        """
        if settled_fn is None:
            return self._with_retries("GET-batch", lambda: plain_fn(items))
        results: dict[int, bytes] = {}
        pending = list(range(len(items)))
        for attempt in range(self.policy.max_attempts):
            outcomes = settled_fn([items[i] for i in pending])
            still = []
            for i, r in zip(pending, outcomes):
                if isinstance(r, TransientStorageError):
                    still.append(i)
                elif isinstance(r, Exception):
                    raise r
                else:
                    results[i] = r
            if not still:
                return [results[i] for i in range(len(items))]
            self._note_retries(len(still))
            pending = still
            if attempt + 1 < self.policy.max_attempts:
                self._sleep(self.policy.delay(attempt))
        raise StorageRetryExhausted(
            f"GET-batch: {len(pending)} of {len(items)} items failed after "
            f"{self.policy.max_attempts} attempts")

    def exists(self, path: str) -> bool:
        return self._with_retries("HEAD", lambda: self.inner.exists(path))

    def list_dir(self, path: str) -> list[str]:
        return self._with_retries("LIST", lambda: self.inner.list_dir(path))

    def size(self, path: str) -> int:
        return self._with_retries("HEAD", lambda: self.inner.size(path))

    def delete(self, path: str) -> None:
        return self._with_retries("DELETE", lambda: self.inner.delete(path))

    # -- writes (retry-safe conditional put) -------------------------------
    def write_bytes(self, path: str, data: bytes, *, overwrite: bool = False) -> None:
        saw_transient = False
        last: Exception | None = None
        for attempt in range(self.policy.max_attempts):
            try:
                self.inner.write_bytes(path, data, overwrite=overwrite)
                return
            except TransientStorageError as e:
                last = e
                saw_transient = True
                self._note_retries()
                if attempt + 1 < self.policy.max_attempts:
                    self._sleep(self.policy.delay(attempt))
            except PutIfAbsentError:
                if saw_transient and not overwrite and \
                        self._we_already_won(path, data):
                    return          # our earlier (ambiguous) attempt landed
                raise               # a concurrent writer genuinely won
        # the final attempt may itself have applied before its response was
        # lost — same disambiguation before giving up
        if saw_transient and not overwrite and self._we_already_won(path, data):
            return
        raise StorageRetryExhausted(
            f"PUT {path} failed after {self.policy.max_attempts} attempts"
        ) from last

    def write_many(self, items: Sequence[tuple[str, bytes]], *,
                   overwrite: bool = False) -> None:
        """Batch puts with per-item retries.

        When the backend exposes ``write_many_settled`` (per-item
        outcomes), each round re-puts ONLY the failed items of the batch;
        an item that comes back :class:`PutIfAbsentError` after one of its
        own attempts failed transiently runs the same read-back
        disambiguation as ``write_bytes`` — *per item*, so one ambiguous
        put in a 32-object staged flush resolves without disturbing the
        other 31.  A genuine lost race still raises so the commit protocol
        sees the conflict.  Without a settled variant the items are written
        through the (individually retried) single-put path.
        """
        items = list(items)
        if not items:
            return
        settled_fn = getattr(self.inner, "write_many_settled", None)
        if settled_fn is None:
            for p, data in items:
                self.write_bytes(p, data, overwrite=overwrite)
            return
        saw_transient: set[int] = set()
        pending = list(range(len(items)))
        for attempt in range(self.policy.max_attempts):
            outcomes = settled_fn([items[i] for i in pending],
                                  overwrite=overwrite)
            still = []
            for i, r in zip(pending, outcomes):
                if r is None:
                    continue
                if isinstance(r, TransientStorageError):
                    saw_transient.add(i)
                    still.append(i)
                elif isinstance(r, PutIfAbsentError):
                    if i in saw_transient and not overwrite and \
                            self._we_already_won(*items[i]):
                        continue    # our earlier (ambiguous) attempt landed
                    raise r         # a concurrent writer genuinely won
                else:
                    raise r
            if not still:
                return
            self._note_retries(len(still))
            pending = still
            if attempt + 1 < self.policy.max_attempts:
                self._sleep(self.policy.delay(attempt))
        # final attempts may themselves have applied before their responses
        # were lost — same per-item disambiguation before giving up
        if not overwrite:
            pending = [i for i in pending
                       if not (i in saw_transient and
                               self._we_already_won(*items[i]))]
        if pending:
            raise StorageRetryExhausted(
                f"PUT-batch: {len(pending)} of {len(items)} items failed "
                f"after {self.policy.max_attempts} attempts")

    def _we_already_won(self, path: str, data: bytes) -> bool:
        try:
            return self._with_retries(
                "GET", lambda: self.inner.read_bytes(path)) == data
        except FileNotFoundError:
            return False
