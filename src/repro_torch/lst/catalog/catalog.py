# Copy of repro/lst/catalog/catalog.py; the port imports nothing of repro.
"""The catalog facade: consistent multi-table registration and resolution.

A :class:`Catalog` is the single entry point readers discover synced
tables through (ROADMAP open item 2 — the org-scale version of the
paper's interoperability claim: one catalog, any format, consistent
cross-table reads).  It resolves an immutable :class:`CatalogSnapshot`
of the newest generation manifest — every table pointer and every group
in one atomic unit — and publishes changes through
:class:`CatalogTransaction` **group commits**: any number of pointer
updates and group edits staged together become visible in ONE atomic
manifest swap, so a reader can never observe half of a multi-table
publish.

Concurrency is optimistic, the same shape as every LST commit protocol
in this repo: a transaction reads a base generation, stages updates in
memory, and publishes ``base + 1`` with a conditional put.  Losing the
race (:class:`~repro_torch.lst.catalog.store.CatalogConflict`) re-reads the
winning manifest, re-applies the staged updates on top, and tries the
next generation — updates to *different* tables interleave without loss,
updates to the *same* table resolve last-writer-wins at a generation
boundary, and every published generation is internally consistent.

Request economics: resolving a snapshot costs one LIST (freshness) plus
one GET only when the generation actually moved — repeat resolutions of
an unchanged catalog reuse the parsed manifest.  A publish costs the
base resolution plus exactly one PUT.
"""

from __future__ import annotations

import threading

from repro_torch.lst.catalog.pointer import (TablePointer, pointer_from_json,
                                       pointer_to_json)
from repro_torch.lst.catalog.store import CatalogConflict, CatalogStore

__all__ = ["UnknownTableError", "CatalogSnapshot", "Catalog",
           "CatalogTransaction"]


class UnknownTableError(KeyError):
    """The requested table (or group) is not registered in this catalog
    generation."""


class CatalogSnapshot:
    """One immutable generation of the catalog: all pointers, all groups.

    Resolving through a snapshot is what gives cross-table consistency:
    every ``resolve()`` against one snapshot answers from the same
    atomically-published manifest, however many publishes land after it
    was taken.
    """

    def __init__(self, generation: int, tables: dict, groups: dict):
        self.generation = generation
        self._tables = dict(tables)       # name -> TablePointer
        self._groups = {g: tuple(m) for g, m in groups.items()}

    @property
    def tables(self) -> dict:
        return dict(self._tables)

    @property
    def groups(self) -> dict:
        return dict(self._groups)

    def table_names(self) -> list:
        return sorted(self._tables)

    def resolve(self, name: str) -> TablePointer:
        ptr = self._tables.get(name)
        if ptr is None:
            raise UnknownTableError(
                f"table {name!r} is not registered "
                f"(generation {self.generation}; "
                f"registered: {self.table_names()})")
        return ptr

    def group(self, name: str) -> tuple:
        members = self._groups.get(name)
        if members is None:
            raise UnknownTableError(
                f"group {name!r} is not registered "
                f"(generation {self.generation}; "
                f"groups: {sorted(self._groups)})")
        return members

    # ------------------------------------------------------------- manifest
    def to_manifest(self) -> dict:
        return {"tables": {n: pointer_to_json(p)
                           for n, p in sorted(self._tables.items())},
                # membership order is the publisher's (set_group /
                # add_to_group order) — preserved, not sorted, so every
                # reader of a generation sees the same tuple
                "groups": {g: list(m)
                           for g, m in sorted(self._groups.items())}}

    @staticmethod
    def from_manifest(generation: int, manifest: dict) -> "CatalogSnapshot":
        tables = {n: pointer_from_json(d)
                  for n, d in manifest.get("tables", {}).items()}
        groups = {g: tuple(m)
                  for g, m in manifest.get("groups", {}).items()}
        return CatalogSnapshot(generation, tables, groups)


class Catalog:
    """Catalog over one storage prefix (see module doc).

    Thread-safe: snapshots are immutable, the parsed-manifest memo is
    lock-guarded, and publish atomicity comes from the store's
    conditional put — concurrent transactions from any number of threads
    or processes serialize at the generation boundary.
    """

    def __init__(self, fs, base_path: str, *, retain: int = 8):
        self.fs = fs
        self.store = CatalogStore(fs, base_path, retain=retain)
        self._lock = threading.Lock()
        self._cached: CatalogSnapshot | None = None

    # ------------------------------------------------------------ resolution
    def snapshot(self) -> CatalogSnapshot:
        """The newest catalog generation as an immutable snapshot.

        One LIST for freshness; the manifest GET is skipped when the
        generation has not moved since the last resolution (including a
        publish this instance made itself).  An unreadable newest
        generation falls back one generation instead of failing readers.
        """
        head = self.store.head_generation()
        with self._lock:
            cached = self._cached
        if cached is not None and cached.generation == head:
            return cached
        if head == 0:
            snap = CatalogSnapshot(0, {}, {})
        else:
            manifest = self.store.load_generation(head)
            if manifest is None:
                gen, manifest = self.store.load()
                snap = CatalogSnapshot.from_manifest(gen, manifest)
            else:
                snap = CatalogSnapshot.from_manifest(head, manifest)
        with self._lock:
            if self._cached is None or \
                    snap.generation >= self._cached.generation:
                self._cached = snap
        return snap

    def resolve(self, name: str) -> TablePointer:
        """``snapshot().resolve(name)`` — the single-table convenience."""
        return self.snapshot().resolve(name)

    def seed_generation(self, gen: int) -> None:
        """Advisory warm-start hint (see ``CatalogStore.seed_generation``)."""
        self.store.seed_generation(gen)

    @property
    def last_generation(self) -> int:
        """The newest generation this instance has resolved or published
        (no storage requests; 0 before any resolution)."""
        with self._lock:
            return self._cached.generation if self._cached else 0

    # -------------------------------------------------------------- mutation
    def transaction(self) -> "CatalogTransaction":
        """Stage pointer/group updates and publish them as ONE atomic
        generation; usable as a context manager (commits on clean exit)::

            with catalog.transaction() as txn:
                txn.put(pointer_a)
                txn.put(pointer_b)
                txn.set_group("orders", ["a", "b"])
            # <- both pointers + the group are now visible, atomically
        """
        return CatalogTransaction(self)

    def register_table(self, pointer: TablePointer,
                       group: str | None = None) -> CatalogSnapshot:
        """One-pointer convenience transaction (optionally joining a
        group); returns the published snapshot."""
        with self.transaction() as txn:
            txn.put(pointer)
            if group:
                txn.add_to_group(group, pointer.name)
        return txn.published

    # -------------------------------------------------------------- internals
    def _install(self, snap: CatalogSnapshot) -> None:
        with self._lock:
            if self._cached is None or \
                    snap.generation >= self._cached.generation:
                self._cached = snap


class CatalogTransaction:
    """Staged catalog updates published as one atomic generation.

    Staging is pure in-memory bookkeeping; nothing touches storage until
    :meth:`commit`, and commit performs exactly one PUT per attempt — the
    manifest swap IS the commit point.  A conflict (another publisher won
    the generation) re-reads the winning manifest and re-applies the
    staged updates on top; after ``max_attempts`` losses the conflict
    propagates.  A transaction commits at most once.
    """

    def __init__(self, catalog: Catalog, *, max_attempts: int = 16):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.catalog = catalog
        self.max_attempts = max_attempts
        self._puts: dict[str, TablePointer] = {}
        self._drops: set[str] = set()
        self._group_sets: dict[str, tuple] = {}
        self._group_adds: dict[str, list] = {}
        self.published: CatalogSnapshot | None = None

    # -------------------------------------------------------------- staging
    def put(self, pointer: TablePointer) -> "CatalogTransaction":
        """Stage a pointer registration/update (last stage of a name wins)."""
        self._drops.discard(pointer.name)
        self._puts[pointer.name] = pointer
        return self

    def drop(self, name: str) -> "CatalogTransaction":
        """Stage a de-registration (the name also leaves every group)."""
        self._puts.pop(name, None)
        self._drops.add(name)
        return self

    def set_group(self, group: str, members) -> "CatalogTransaction":
        """Stage a group definition (replaces the membership outright)."""
        self._group_sets[group] = tuple(members)
        self._group_adds.pop(group, None)
        return self

    def add_to_group(self, group: str, *members: str) -> "CatalogTransaction":
        """Stage additions to a group (created if absent, merged with the
        base manifest's membership at commit time)."""
        self._group_adds.setdefault(group, []).extend(members)
        return self

    @property
    def empty(self) -> bool:
        return not (self._puts or self._drops or self._group_sets
                    or self._group_adds)

    # --------------------------------------------------------------- commit
    def commit(self) -> CatalogSnapshot:
        """Publish every staged update as ONE new generation (see class
        doc); returns the published snapshot.  An empty transaction is a
        no-op returning the current snapshot."""
        if self.published is not None:
            raise RuntimeError("transaction already committed")
        if self.empty:
            self.published = self.catalog.snapshot()
            return self.published
        last: CatalogConflict | None = None
        for _ in range(self.max_attempts):
            base = self.catalog.snapshot()
            snap = self._apply(base)
            try:
                gen = self.catalog.store.publish(
                    snap.to_manifest(), base_generation=base.generation)
            except CatalogConflict as e:
                last = e
                continue    # rebase on the winner's manifest and retry
            snap.generation = gen
            self.catalog._install(snap)
            self.published = snap
            return snap
        raise last if last is not None else CatalogConflict("publish failed")

    def _apply(self, base: CatalogSnapshot) -> CatalogSnapshot:
        tables = base.tables
        groups = {g: list(m) for g, m in base.groups.items()}
        for name in self._drops:
            tables.pop(name, None)
            for members in groups.values():
                if name in members:
                    members.remove(name)
        tables.update(self._puts)
        for g, members in self._group_sets.items():
            groups[g] = list(members)
        for g, added in self._group_adds.items():
            members = groups.setdefault(g, [])
            members.extend(m for m in added if m not in members)
        # membership is only meaningful over registered tables
        for g in list(groups):
            groups[g] = [m for m in groups[g] if m in tables]
        return CatalogSnapshot(base.generation, tables, groups)

    # ------------------------------------------------------ context manager
    def __enter__(self) -> "CatalogTransaction":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None and self.published is None:
            self.commit()
