# Copy of repro/lst/storage/registry.py; the port imports nothing of repro.
"""URI-scheme registry: ``make_fs("file://…" | "mem://…" | "s3sim://…")``.

One place maps URI schemes to FileSystem backends and resolves table URIs
to store-local paths.  Resolution keeps the **authority** (bucket /
container) as the leading path component for object-store schemes, so
``s3sim://bucket-a/sales`` and ``s3sim://bucket-b/sales`` are different
tables — the seed's ``strip_scheme`` discarded the authority and made two
buckets with the same key path collide.  ``file://`` is the exception: its
authority is a host (always localhost here) and its path is absolute on
the local filesystem.

``mem://`` and ``s3sim://`` resolve to process-shared in-memory stores (one
per scheme), so every FileSystem view built from the same URI sees the same
bucket namespace — which is what lets concurrent executors race commits and
crash tests reopen the store.
"""

from __future__ import annotations

import threading
from typing import Callable

from repro_torch.lst.storage.base import FileSystem
from repro_torch.lst.storage.instrumented import InstrumentedFS
from repro_torch.lst.storage.local import LocalFS
from repro_torch.lst.storage.memory import MemoryFS
from repro_torch.lst.storage.retry import RetryingFS, RetryPolicy
from repro_torch.lst.storage.simulated import SimulatedObjectStore, StorageProfile

_lock = threading.Lock()
_SCHEMES: dict[str, Callable[..., FileSystem]] = {}
_LOCAL_PATH_SCHEMES = {"file"}      # authority = host, path absolute locally
_SHARED_STORES: dict[str, MemoryFS] = {}


def register_scheme(scheme: str, factory: Callable[..., FileSystem],
                    *, local_path: bool = False) -> None:
    """Register ``scheme`` -> FileSystem factory (kwargs = backend options)."""
    with _lock:
        _SCHEMES[scheme] = factory
        if local_path:
            _LOCAL_PATH_SCHEMES.add(scheme)


def shared_store(scheme: str) -> MemoryFS:
    """The process-wide in-memory bucket namespace backing ``scheme``."""
    with _lock:
        store = _SHARED_STORES.get(scheme)
        if store is None:
            store = _SHARED_STORES[scheme] = MemoryFS()
        return store


def clear_shared_stores() -> None:
    """Drop every in-memory bucket namespace (test isolation)."""
    with _lock:
        _SHARED_STORES.clear()


# -- URI handling ----------------------------------------------------------
def split_uri(uri: str) -> tuple[str | None, str, str]:
    """``scheme://authority/path`` -> (scheme, authority, path).

    Plain paths come back as ``(None, "", path)``.
    """
    if "://" not in uri:
        return None, "", uri
    scheme, rest = uri.split("://", 1)
    if "/" in rest:
        authority, path = rest.split("/", 1)
    else:
        authority, path = rest, ""
    return scheme, authority, path


def scheme_of(uri: str) -> str | None:
    return split_uri(uri)[0]


def resolve_uri(uri: str) -> str:
    """URI -> store-local path, authority-qualified for bucket schemes."""
    scheme, authority, path = split_uri(uri)
    if scheme is None:
        return uri
    if scheme in _LOCAL_PATH_SCHEMES:
        return "/" + path.lstrip("/")
    if not authority:
        return path
    return f"{authority}/{path}" if path else authority


def make_fs(uri: str, **options) -> FileSystem:
    """Build the backend FileSystem for ``uri``'s scheme.

    Accepts a full URI (``s3sim://bucket/t``), a bare scheme (``s3sim``),
    or a plain path (-> LocalFS).  ``options`` are backend-specific: the
    simulated store takes :class:`StorageProfile` fields.
    """
    scheme = scheme_of(uri) if "://" in uri else (uri if uri in _SCHEMES
                                                  else None)
    if scheme is None:
        return LocalFS(**options)
    with _lock:
        factory = _SCHEMES.get(scheme)
    if factory is None:
        raise ValueError(f"unknown storage scheme {scheme!r}; "
                         f"registered: {sorted(_SCHEMES)}")
    return factory(**options)


def layer_fs(base: FileSystem, *, profile: StorageProfile | None = None,
             retry: RetryPolicy | None = None,
             telemetry=None, sleep=None) -> InstrumentedFS:
    """Compose the standard stack: Instrumented(Retrying(Simulated(base))).

    ``profile`` wraps any backend in latency/fault injection (skip to run
    against the backend's native behavior), ``retry`` adds backoff-retried
    requests, and the instrumented layer always sits outermost so counters
    see logical requests.  ``sleep`` replaces the retry layer's backoff
    sleeper (``time.sleep``) — the daemon threads its injected clock
    through here so retry backoff never wall-sleeps under a fake clock.
    """
    fs = base
    if profile is not None:
        fs = SimulatedObjectStore(fs, profile)
    if retry is not None:
        fs = RetryingFS(fs, retry) if sleep is None \
            else RetryingFS(fs, retry, sleep=sleep)
    return InstrumentedFS(fs, telemetry)


# -- built-in schemes ------------------------------------------------------
register_scheme("file", LocalFS, local_path=True)
register_scheme("mem", lambda **opt: shared_store("mem"))
register_scheme(
    "s3sim",
    lambda **opt: SimulatedObjectStore(shared_store("s3sim"),
                                       StorageProfile(**opt)))
