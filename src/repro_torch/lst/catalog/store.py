# Copy of repro/lst/catalog/store.py; the port imports nothing of repro.
"""Durable catalog manifests: one generation document per publish.

The whole catalog — every table pointer and every group definition — is
one JSON *manifest* object per generation (``gen-NNNNNNNNNN.json``),
persisted through the same :class:`~repro_torch.lst.storage.base.FileSystem`
protocol and with the same single-atomic-commit-point discipline the
target writers and ``core/checkpoint.py`` use: publishing generation
``N+1`` is exactly ONE conditional put (put-if-absent).  That is the
entire atomicity story —

* a crash anywhere before the put leaves readers at generation ``N``;
* a torn put (applied, response lost) leaves a fully durable ``N+1``;
* two publishers racing the same base generation see exactly one winner
  (:class:`CatalogConflict` for the loser, who re-reads and rebases —
  see ``catalog.py``).

Unlike the checkpoint store, the loser must NOT blindly take the next
free slot: a manifest's content depends on the manifest it was derived
from, so the conflict is surfaced to the transaction layer for a
re-read + re-apply instead of being swallowed here.

``load()`` walks generations newest-first and skips unreadable or
unparseable documents, so a corrupted newest generation degrades one
generation instead of poisoning every reader.  Old generations are
pruned best-effort after a successful publish (``retain``).
"""

from __future__ import annotations

import json
import threading

from repro_torch.lst.storage.base import PutIfAbsentError, join

__all__ = ["CATALOG_VERSION", "CatalogConflict", "CatalogStore"]

CATALOG_VERSION = 1

_GEN_PREFIX = "gen-"
_GEN_SUFFIX = ".json"


class CatalogConflict(RuntimeError):
    """A publish lost the generation race (another manifest landed first).

    Carries no partial state by construction: the loser's manifest was
    never written.  Transactions catch this, re-read the winning
    manifest, re-apply their staged updates and publish again.
    """


class CatalogStore:
    """Generation-numbered catalog manifests under one storage prefix."""

    def __init__(self, fs, base_path: str, *, retain: int = 8):
        if retain < 1:
            raise ValueError("retain must be >= 1")
        self.fs = fs
        self.base_path = base_path.rstrip("/")
        self.retain = retain
        self._lock = threading.Lock()
        self._gen_hint: int = 0       # highest generation seen (advisory)
        self.publishes = 0
        self.conflicts = 0
        self.load_fallbacks = 0       # corrupt generations skipped on load

    def _path(self, gen: int) -> str:
        return join(self.base_path, f"{_GEN_PREFIX}{gen:010d}{_GEN_SUFFIX}")

    def _scan(self) -> list[int]:
        """Existing generation numbers, ascending (one LIST request)."""
        try:
            names = self.fs.list_dir(self.base_path)
        except FileNotFoundError:
            return []
        gens = []
        for n in names:
            if n.startswith(_GEN_PREFIX) and n.endswith(_GEN_SUFFIX):
                try:
                    gens.append(int(n[len(_GEN_PREFIX):-len(_GEN_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(gens)

    def seed_generation(self, gen: int) -> None:
        """Advisory warm-start hint (a restarted daemon's checkpoint rides
        this in): primes the generation cursor so freshness checks and
        publish attempts start at the right slot.  Never trusted over a
        live LIST — a wrong seed costs one extra conflict, never a wrong
        manifest."""
        with self._lock:
            self._gen_hint = max(self._gen_hint, int(gen))

    def head_generation(self) -> int:
        """The newest existing generation number (0 = empty catalog); one
        LIST request."""
        gens = self._scan()
        head = gens[-1] if gens else 0
        with self._lock:
            self._gen_hint = max(self._gen_hint, head)
        return head

    # ------------------------------------------------------------------ load
    def load(self) -> tuple[int, dict]:
        """``(generation, manifest)`` of the newest readable+parseable
        generation; ``(0, {})`` for an empty catalog.  Unreadable newest
        generations (crash mid-publish of a non-atomic store, corruption)
        are skipped, not fatal."""
        gens = self._scan()
        with self._lock:
            self._gen_hint = max(self._gen_hint, gens[-1] if gens else 0)
        for gen in reversed(gens):
            payload = self.load_generation(gen)
            if payload is not None:
                return gen, payload
            with self._lock:
                self.load_fallbacks += 1
        return 0, {}

    def load_generation(self, gen: int) -> dict | None:
        """One specific generation's manifest, or None when unreadable."""
        try:
            payload = json.loads(self.fs.read_bytes(self._path(gen)))
            if payload.get("version") != CATALOG_VERSION:
                raise ValueError(f"unknown catalog version "
                                 f"{payload.get('version')!r}")
            return payload
        except Exception:
            return None

    # --------------------------------------------------------------- publish
    def publish(self, manifest: dict, *, base_generation: int) -> int:
        """Publish ``manifest`` as generation ``base_generation + 1``.

        ONE conditional put — the atomic commit point of the whole
        catalog.  Raises :class:`CatalogConflict` when that generation
        already exists (a racing publisher won); the caller re-reads and
        rebases.  On success, prunes the generation that fell off the
        retention window, best-effort.
        """
        gen = int(base_generation) + 1
        manifest = dict(manifest)
        manifest["version"] = CATALOG_VERSION
        manifest["generation"] = gen
        data = json.dumps(manifest, sort_keys=True).encode()
        try:
            self.fs.write_bytes(self._path(gen), data)
        except PutIfAbsentError:
            with self._lock:
                self.conflicts += 1
                self._gen_hint = max(self._gen_hint, gen)
            raise CatalogConflict(
                f"catalog generation {gen} was published concurrently")
        with self._lock:
            self.publishes += 1
            self._gen_hint = max(self._gen_hint, gen)
        stale = gen - self.retain
        if stale >= 1:
            try:
                self.fs.delete(self._path(stale))
            except Exception:
                pass        # retention is best-effort; never fail a publish
        return gen
