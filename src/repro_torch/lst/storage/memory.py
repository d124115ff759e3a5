# Copy of repro/lst/storage/memory.py; the port imports nothing of repro.
"""In-memory object store: a flat key -> bytes map with conditional puts.

The reference backend for the simulated-object-store stack: keys are
'/'-separated object names with no real directories (``list_dir`` is a
prefix scan returning immediate children, the way S3 ListObjectsV2 with a
delimiter behaves), every object is written in one shot, and put-if-absent
is atomic under one lock — the conditional-put primitive LST commits rely
on.  State survives across FileSystem *views* of the same store, which is
what lets crash/retry tests reopen "the bucket" after killing a writer.
"""

from __future__ import annotations

import threading

from repro_torch.lst.storage.base import PutIfAbsentError, SequentialBatchMixin


def _norm(path: str) -> str:
    return path.strip("/")


class MemoryFS(SequentialBatchMixin):
    """Thread-safe in-memory object store with object-store semantics."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._objects: dict[str, bytes] = {}

    # -- reads ------------------------------------------------------------
    def read_bytes(self, path: str) -> bytes:
        with self._lock:
            data = self._objects.get(_norm(path))
        if data is None:
            raise FileNotFoundError(path)
        return data

    def read_bytes_range(self, path: str, offset: int, length: int) -> bytes:
        data = self.read_bytes(path)
        if offset < 0:                      # suffix read
            return data[max(0, len(data) - length):]
        if length < 0:                      # to end of object
            return data[offset:]
        return data[offset:offset + length]

    def exists(self, path: str) -> bool:
        key = _norm(path)
        with self._lock:
            if key in self._objects:
                return True
            prefix = key + "/"
            return any(k.startswith(prefix) for k in self._objects)

    def list_dir(self, path: str) -> list[str]:
        prefix = _norm(path) + "/"
        names = set()
        with self._lock:
            for k in self._objects:
                if k.startswith(prefix):
                    names.add(k[len(prefix):].split("/", 1)[0])
        return sorted(names)

    def size(self, path: str) -> int:
        return len(self.read_bytes(path))

    # -- writes -----------------------------------------------------------
    def write_bytes(self, path: str, data: bytes, *, overwrite: bool = False) -> None:
        key = _norm(path)
        with self._lock:
            if not overwrite and key in self._objects:
                raise PutIfAbsentError(path)
            self._objects[key] = bytes(data)

    def delete(self, path: str) -> None:
        with self._lock:
            self._objects.pop(_norm(path), None)

    def clone(self) -> "MemoryFS":
        """Independent snapshot copy of the whole store (objects are
        immutable bytes, so only the key map is copied).  Benchmarks and
        tests use it to run several arms from one identically-built
        starting state."""
        out = MemoryFS()
        with self._lock:
            out._objects = dict(self._objects)
        return out

    # -- introspection (tests / benchmarks) --------------------------------
    def object_count(self) -> int:
        with self._lock:
            return len(self._objects)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._objects.values())
