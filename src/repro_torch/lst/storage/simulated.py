# Copy of repro/lst/storage/simulated.py; the port imports nothing of repro.
"""Simulated object store: latency + fault injection over any FileSystem.

Decorator that makes a backing store behave like a remote object store:

* every request pays a configurable round-trip time (``rtt_ms``);
* requests fail probabilistically with a 503-style
  :class:`~repro_torch.lst.storage.base.TransientStorageError` — either *before*
  the operation applies (``fault_rate``, a rejected/throttled request) or,
  for writes, *after* it applied (``ambiguous_put_rate``, the response was
  lost on the wire) — the case a retry-safe put-if-absent must disambiguate;
* batch reads (``read_many`` / ``read_many_ranges``) and batch writes
  (``write_many``) are pipelined over ``pipeline_depth`` concurrent
  in-flight requests, so N independent metadata fetches or staged puts
  cost ~ceil(N / depth) RTTs instead of N.  ``pipeline_depth=1`` degrades
  to one round trip per object — the comparison arm of
  ``bench_object_store_sync`` / ``bench_write_pipeline``.

A :class:`CrashSchedule` (``arm_crash``) additionally injects deterministic
*process death* at an exact request index — :class:`~repro_torch.lst.storage.base
.SimulatedCrash` rips through every retry/isolation layer like SIGKILL —
which is what the crash-recovery chaos campaign sweeps over a drain's whole
request stream.

Fault injection is seeded and lock-protected, so a test run is
reproducible; ``injected_faults`` / ``requests`` counters expose what the
simulation actually did, and ``serial_rounds()`` reports how many
*sequential* round-trip slots the request stream occupied (a batch of N
over depth d counts ceil(N / d), not N) — the number the write-pipelining
benchmarks report as "serial RTTs per commit".
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Sequence

from repro_torch.lst.storage.base import (PutIfAbsentError, SimulatedCrash,
                                    TransientStorageError)

_MAX_POOL = 32


@dataclass(frozen=True)
class CrashSchedule:
    """Deterministic process-death injection: die at the Nth request.

    ``at_request`` is 1-based over the store's global request counter, so a
    schedule pins the crash to one exact point of a drain's request stream —
    sweeping N across the whole stream hits every interesting window (mid
    ``write_many`` pipeline, between a staged flush and its commit-point
    put, mid checkpoint save...).  Requests *after* the fatal one also die:
    the process is gone, nothing more lands.

    ``after_apply=True`` makes the fatal request a *torn write*: the PUT
    applies in the store before the crash (the response never reaches the
    caller) — the other half of the ambiguity a crash-safe commit protocol
    must survive.  Non-write requests don't mutate the store, so for them
    ``after_apply`` is indistinguishable from a pre-apply death.
    """
    at_request: int
    after_apply: bool = False

    def __post_init__(self):
        if self.at_request < 1:
            raise ValueError("at_request is 1-based and must be >= 1")


def _raise_first(settled: list) -> list[bytes]:
    for r in settled:
        if isinstance(r, Exception):
            raise r
    return settled


@dataclass(frozen=True)
class StorageProfile:
    """Behavior knobs for a SimulatedObjectStore."""
    rtt_ms: float = 0.0            # per-request round-trip time
    fault_rate: float = 0.0        # P(request rejected before applying)
    ambiguous_put_rate: float = 0.0  # P(write applies but the response is lost)
    pipeline_depth: int = 16       # concurrent in-flight batch reads (1 = serial)
    seed: int = 0


class SimulatedObjectStore:
    """Wrap ``inner`` with object-store latency/fault behavior."""

    def __init__(self, inner, profile: StorageProfile | None = None, **kw):
        self.inner = inner
        self.profile = profile or StorageProfile(**kw)
        if self.profile.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self._rng = random.Random(self.profile.seed)
        self._lock = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None
        self.requests = 0
        self.injected_faults = 0
        self.batch_items = 0     # requests issued through a pipelined batch
        self.batch_rounds = 0    # sequential rounds those batches occupied
        self.crash_schedule: CrashSchedule | None = None
        self.crashed = False     # a schedule fired (at least once)

    def arm_crash(self, schedule: CrashSchedule | None) -> None:
        """Install (or, with ``None``, clear) a crash schedule.  The request
        counter keeps running from where it is — arm before the work whose
        stream the schedule indexes."""
        with self._lock:
            self.crash_schedule = schedule
            self.crashed = False

    @property
    def latency_bound(self) -> bool:
        """Advertises per-request round trips to ``storage.base
        .latency_bound`` (the executor widens its pool only when waiting
        on RTTs actually overlaps)."""
        return self.profile.rtt_ms > 0

    # -- simulation core ---------------------------------------------------
    def _roll(self, rate: float) -> bool:
        if rate <= 0.0:
            return False
        with self._lock:
            hit = self._rng.random() < rate
            if hit:
                self.injected_faults += 1
            return hit

    def _request(self, op: str) -> int:
        """One round trip: pay the RTT, maybe get throttled (pre-apply).
        Returns this request's 1-based index in the store's stream."""
        with self._lock:
            self.requests += 1
            n = self.requests
            cs = self.crash_schedule
            # the fatal PUT of an after-apply schedule passes through here
            # and dies in write_bytes AFTER the store applied it; a fatal
            # non-write has nothing to tear, so it dies pre-apply; every
            # request past the fatal one dies outright — the process is gone
            defer = cs is not None and cs.after_apply and op == "PUT"
            if cs is not None and (n > cs.at_request or
                                   (n == cs.at_request and not defer)):
                self.crashed = True
                raise SimulatedCrash(f"process died at request {n} ({op})")
        if self.profile.rtt_ms > 0:
            time.sleep(self.profile.rtt_ms / 1000.0)
        if self._roll(self.profile.fault_rate):
            raise TransientStorageError(f"503 SlowDown ({op})")
        return n

    def _batch_pool(self, n: int) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=min(self.profile.pipeline_depth, _MAX_POOL),
                    thread_name_prefix="objstore-sim")
            return self._pool

    def close(self) -> None:
        """Release the batch-read thread pool (recreated lazily if the
        store is used again)."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- reads ------------------------------------------------------------
    def read_bytes(self, path: str) -> bytes:
        self._request("GET")
        return self.inner.read_bytes(path)

    def read_bytes_range(self, path: str, offset: int, length: int) -> bytes:
        self._request("GET")
        return self.inner.read_bytes_range(path, offset, length)

    def read_many(self, paths: Sequence[str]) -> list[bytes]:
        return _raise_first(self.read_many_settled(paths))

    def read_many_ranges(
            self, requests: Sequence[tuple[str, int, int]]) -> list[bytes]:
        return _raise_first(self.read_many_ranges_settled(requests))

    # settled variants: per-item outcomes (bytes | TransientStorageError),
    # the contract a retry layer needs to refetch ONLY the throttled items
    # of a batch instead of replaying the whole fan-out
    def read_many_settled(self, paths: Sequence[str]) -> list:
        return self._fan_out([(p, None) for p in paths], self._read_one)

    def read_many_ranges_settled(
            self, requests: Sequence[tuple[str, int, int]]) -> list:
        return self._fan_out([(p, (off, ln)) for p, off, ln in requests],
                             self._read_one)

    def _fan_out(self, items: list, one) -> list:
        n = len(items)
        if n:
            with self._lock:
                self.batch_items += n
                self.batch_rounds += -(-n // self.profile.pipeline_depth)
        if self.profile.pipeline_depth <= 1 or n <= 1:
            return [one(it) for it in items]
        # each in-flight request pays its RTT on a pool thread, so the batch
        # costs ~ceil(N / depth) round trips of wall clock
        return list(self._batch_pool(n).map(one, items))

    def _read_one(self, item):
        path, rng = item
        try:
            if rng is None:
                return self.read_bytes(path)
            return self.read_bytes_range(path, *rng)
        except TransientStorageError as e:
            return e

    def serial_rounds(self) -> int:
        """Sequential round-trip slots the request stream occupied so far:
        every non-batched request is its own round; a pipelined batch of N
        counts ceil(N / pipeline_depth)."""
        with self._lock:
            return self.requests - self.batch_items + self.batch_rounds

    def exists(self, path: str) -> bool:
        self._request("HEAD")
        return self.inner.exists(path)

    def list_dir(self, path: str) -> list[str]:
        self._request("LIST")
        return self.inner.list_dir(path)

    def size(self, path: str) -> int:
        self._request("HEAD")
        return self.inner.size(path)

    # -- writes -----------------------------------------------------------
    def write_bytes(self, path: str, data: bytes, *, overwrite: bool = False) -> None:
        n = self._request("PUT")
        self.inner.write_bytes(path, data, overwrite=overwrite)
        cs = self.crash_schedule
        if cs is not None and cs.after_apply and n == cs.at_request:
            # torn write: the object landed, the process died before the
            # response came back
            with self._lock:
                self.crashed = True
            raise SimulatedCrash(f"process died after request {n} applied "
                                 f"(PUT {path})")
        if self._roll(self.profile.ambiguous_put_rate):
            # the write landed but the caller never hears about it
            raise TransientStorageError("timeout after apply (PUT)")

    def write_many(self, items: Sequence[tuple[str, bytes]], *,
                   overwrite: bool = False) -> None:
        _raise_first(self.write_many_settled(items, overwrite=overwrite))

    def write_many_settled(self, items: Sequence[tuple[str, bytes]], *,
                           overwrite: bool = False) -> list:
        """Pipelined batch puts with per-item *settled* outcomes: ``None``
        on success, :class:`TransientStorageError` (throttled, or applied
        with the response lost) or :class:`PutIfAbsentError` (lost the
        create race) per failed item — the contract the retry layer needs
        to re-put ONLY the failed items and run the ambiguous-put
        disambiguation per item instead of replaying the whole fan-out."""
        def one(item):
            path, data = item
            try:
                self.write_bytes(path, data, overwrite=overwrite)
                return None
            except (TransientStorageError, PutIfAbsentError) as e:
                return e

        return self._fan_out(list(items), one)

    def delete(self, path: str) -> None:
        self._request("DELETE")
        self.inner.delete(path)
