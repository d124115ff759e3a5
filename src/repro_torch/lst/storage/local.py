# Copy of repro/lst/storage/local.py; the port imports nothing of repro.
"""POSIX-backed FileSystem with object-store commit semantics."""

from __future__ import annotations

import os
import threading

from repro_torch.lst.storage.base import PutIfAbsentError, SequentialBatchMixin


class LocalFS(SequentialBatchMixin):
    """POSIX-backed FileSystem with object-store commit semantics.

    Writes are *atomic at the object level*: data is staged to a temp file and
    linked into place, so readers never observe partial objects — mirroring
    object-store single-shot PUTs (this is what makes LST metadata commits
    atomic, per §2 of the paper).
    """

    def __init__(self, *, fsync: bool = True) -> None:
        """``fsync=False`` skips the per-object fsync: atomicity (staged
        temp file + atomic link) is unchanged, only crash durability is
        relaxed — the knob benchmarks use so metadata-translation work is
        measured instead of disk flushes (object stores own durability and
        expose no fsync)."""
        self._lock = threading.Lock()
        self._fsync = fsync

    # -- reads ------------------------------------------------------------
    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def read_bytes_range(self, path: str, offset: int, length: int) -> bytes:
        """Ranged GET; ``offset < 0`` = suffix read of ``length`` bytes,
        ``length < 0`` = read to end of object (see storage.base)."""
        with open(path, "rb") as f:
            if offset < 0:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - length))
            else:
                f.seek(offset)
            return f.read(None if length < 0 else length)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def list_dir(self, path: str) -> list[str]:
        try:
            return sorted(os.listdir(path))
        except FileNotFoundError:
            return []

    def size(self, path: str) -> int:
        return os.stat(path).st_size

    # -- writes -----------------------------------------------------------
    def write_bytes(self, path: str, data: bytes, *, overwrite: bool = False) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            if self._fsync:
                os.fsync(f.fileno())
        if overwrite:
            os.replace(tmp, path)  # atomic swap
            return
        # put-if-absent: hardlink fails with EEXIST if somebody else won.
        try:
            os.link(tmp, path)
        except FileExistsError:
            raise PutIfAbsentError(path)
        finally:
            os.unlink(tmp)

    def delete(self, path: str) -> None:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
