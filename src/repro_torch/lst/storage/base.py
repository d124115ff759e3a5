# Copy of repro/lst/storage/base.py; the port imports nothing of repro.
"""Widened FileSystem protocol + object-store error taxonomy.

The paper's XTable reaches data lakes through a pluggable file system (ABFS
in Listing 2).  Two properties of real object stores shape this protocol:

* **Atomic put-if-absent** — two writers racing to create the same object
  must see exactly one winner (ABFS ETag, S3 If-None-Match, GCS generation
  preconditions).  Every LST commit protocol is built on it; losing the
  race raises :class:`PutIfAbsentError`.
* **Per-request latency and transient throttling** — each call is a network
  round trip that may come back 503 (:class:`TransientStorageError`).
  Independent metadata fetches must therefore be *batched*
  (:meth:`FileSystem.read_many` / :meth:`FileSystem.read_many_ranges`) so a
  log replay is pipelined instead of one RTT per object, and writes must be
  retried with backoff (see ``retry.py``) in a way that distinguishes
  "lost the commit race" from "the store hiccuped".

Range semantics (object-store style, mirrors HTTP Range):

* ``offset < 0`` — suffix read: the last ``length`` bytes (``offset`` is
  ``-length`` by convention, only its sign matters).
* ``length < 0`` — read from ``offset`` to the end of the object.
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable


class PutIfAbsentError(FileExistsError):
    """Raised when an exclusive create loses the race (commit conflict)."""


class TransientStorageError(IOError):
    """A retryable request failure (503 SlowDown / throttle / timeout).

    The request may or may not have been applied by the store — callers
    retrying a put-if-absent must treat a subsequent ``PutIfAbsentError``
    as potentially their own earlier attempt having landed (see
    ``retry.RetryingFS``).
    """


class StorageRetryExhausted(IOError):
    """A transiently-failing request did not succeed within the policy."""


class SimulatedCrash(BaseException):
    """Process death injected by a chaos :class:`~repro_torch.lst.storage
    .simulated.CrashSchedule` — the request (and every request after it)
    dies because *the caller's process* died, not because the store
    hiccuped.

    Deliberately NOT a :class:`TransientStorageError` (retry layers must
    not absorb it) and not even an :class:`Exception` (per-unit / per-table
    error isolation must not contain it): a crash rips straight through
    executor and daemon like ``SIGKILL`` would, which is exactly what the
    crash-recovery tests are simulating.
    """


@runtime_checkable
class FileSystem(Protocol):
    def read_bytes(self, path: str) -> bytes: ...
    def read_bytes_range(self, path: str, offset: int, length: int) -> bytes: ...
    def read_many(self, paths: Sequence[str]) -> list[bytes]: ...
    def read_many_ranges(
        self, requests: Sequence[tuple[str, int, int]]) -> list[bytes]: ...
    def write_bytes(self, path: str, data: bytes, *, overwrite: bool = False) -> None: ...
    def write_many(self, items: Sequence[tuple[str, bytes]], *,
                   overwrite: bool = False) -> None: ...
    def exists(self, path: str) -> bool: ...
    def list_dir(self, path: str) -> list[str]: ...
    def size(self, path: str) -> int: ...
    def delete(self, path: str) -> None: ...


class SequentialBatchMixin:
    """Default (unpipelined) batch reads/writes: one request per object.

    Concrete stores whose requests are local memory/disk operations inherit
    this; the :class:`~repro_torch.lst.storage.simulated.SimulatedObjectStore`
    overrides these methods with a concurrent fan-out so a batch costs
    ~ceil(N / pipeline_depth) round trips instead of N.
    """

    def read_many(self, paths: Sequence[str]) -> list[bytes]:
        return [self.read_bytes(p) for p in paths]

    def read_many_ranges(
            self, requests: Sequence[tuple[str, int, int]]) -> list[bytes]:
        return [self.read_bytes_range(p, off, ln) for p, off, ln in requests]

    def write_many(self, items: Sequence[tuple[str, bytes]], *,
                   overwrite: bool = False) -> None:
        for p, data in items:
            self.write_bytes(p, data, overwrite=overwrite)


def fetch_many(fs, paths: Sequence[str]) -> list[bytes]:
    """``fs.read_many`` with a sequential fallback for minimal FS objects.

    The LST handles funnel every independent multi-object fetch through
    this helper, so any duck-typed FileSystem (test doubles subclassing
    nothing, foreign implementations) keeps working while batching-capable
    stores get the pipelined path.
    """
    paths = list(paths)
    if not paths:
        return []
    rm = getattr(fs, "read_many", None)
    if rm is not None:
        return rm(paths)
    return [fs.read_bytes(p) for p in paths]


def fetch_many_ranges(fs, requests: Sequence[tuple[str, int, int]]) -> list[bytes]:
    """``fs.read_many_ranges`` with a sequential fallback (see fetch_many)."""
    requests = list(requests)
    if not requests:
        return []
    rmr = getattr(fs, "read_many_ranges", None)
    if rmr is not None:
        return rmr(requests)
    return [fs.read_bytes_range(p, off, ln) for p, off, ln in requests]


def coalesce_ranges(requests: Sequence[tuple[str, int, int]], *,
                    max_gap: int = 0):
    """Merge per-path overlapping/adjacent byte ranges into one request each.

    ``requests`` are ``(path, offset, length)`` with non-negative offsets
    and positive lengths (suffix / to-EOF reads cannot be coalesced or
    sliced back without knowing the object size).  Two ranges of the same
    path merge when the gap between them is at most ``max_gap`` bytes —
    the columnar projection path uses ``0`` so adjacent column blobs
    become a single ranged GET without ever fetching an unrequested byte.

    Returns ``(merged, slices)``: ``merged`` is the deduplicated request
    list to hand to :func:`fetch_many_ranges`, and ``slices[i] =
    (merged_index, offset, length)`` locates original request ``i``
    inside its merged range (slice the reply with
    ``blob[offset - merged_offset:][:length]``).
    """
    by_path: dict[str, list[tuple[int, int, int]]] = {}
    for i, (path, off, ln) in enumerate(requests):
        if off < 0 or ln < 0:
            raise ValueError("coalesce_ranges needs explicit offset+length "
                             f"ranges, got ({path!r}, {off}, {ln})")
        by_path.setdefault(path, []).append((off, ln, i))
    merged: list[list] = []          # [path, offset, end]
    slices: list = [None] * len(requests)
    for path, items in by_path.items():
        items.sort()
        cur = -1
        for off, ln, i in items:
            if cur >= 0 and off <= merged[cur][2] + max_gap:
                merged[cur][2] = max(merged[cur][2], off + ln)
            else:
                merged.append([path, off, off + ln])
                cur = len(merged) - 1
            slices[i] = (cur, off, ln)
    return [(p, off, end - off) for p, off, end in merged], slices


def fetch_many_ranges_coalesced(
        fs, requests: Sequence[tuple[str, int, int]], *,
        max_gap: int = 0) -> list[bytes]:
    """:func:`fetch_many_ranges` with per-path range coalescing: adjacent
    requested ranges are fetched as single ranged reads (one pipelined
    batch round total) and sliced back per original request."""
    requests = list(requests)
    if not requests:
        return []
    merged, slices = coalesce_ranges(requests, max_gap=max_gap)
    blobs = fetch_many_ranges(fs, merged)
    out = []
    for mi, off, ln in slices:
        start = off - merged[mi][1]
        out.append(blobs[mi][start:start + ln])
    return out


def flush_many(fs, items: Sequence[tuple[str, bytes]], *,
               overwrite: bool = False) -> None:
    """``fs.write_many`` with a sequential fallback (the write-side twin of
    :func:`fetch_many`).

    Target transactions funnel every *staged* (non-commit-point) object —
    iceberg manifests and manifest-lists, hudi requested/inflight markers,
    chunk data files — through this helper, so a pipelining-capable store
    overlaps the puts while any duck-typed FileSystem keeps working.  Staged
    objects must be idempotent (uniquely named, content-deterministic):
    only the commit-point put is ordered, and it never goes through here.
    """
    items = list(items)
    if not items:
        return
    wm = getattr(fs, "write_many", None)
    if wm is not None:
        return wm(items, overwrite=overwrite)
    for p, data in items:
        fs.write_bytes(p, data, overwrite=overwrite)


def latency_bound(fs) -> bool:
    """True when some layer of the storage stack pays a per-request round
    trip (network-style object store), so callers should overlap requests
    with wide I/O concurrency; false for in-memory / local-disk stacks
    where extra threads only fight the GIL over CPU-bound work.

    Layers advertise themselves with a truthy ``latency_bound`` attribute
    (see :class:`~repro_torch.lst.storage.simulated.SimulatedObjectStore`);
    wrappers are unwrapped through their ``inner`` chain.
    """
    hops = 0
    while fs is not None and hops < 16:
        if getattr(fs, "latency_bound", False):
            return True
        fs = getattr(fs, "inner", None)
        hops += 1
    return False


def join(*parts: str) -> str:
    """Join path segments with '/' (object-store style, no os.sep surprises)."""
    cleaned = [p.strip("/") if i else p.rstrip("/") for i, p in enumerate(parts) if p]
    return "/".join(cleaned)
