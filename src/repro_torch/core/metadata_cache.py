# Copy of repro/core/metadata_cache.py; the port imports nothing of repro.
"""Shared incremental metadata index (the cache stage of plan -> execute).

The seed syncer re-replayed the source log per inspected commit
(``handle.snapshot(commit)`` inside ``get_changes``), making an N-commit
incremental backlog O(N^2) in log-replay work — per *target*.  This module
replaces that with a single-pass index: each table's log is replayed exactly
once (``handle.replay()``), and every ``snapshot(commit)`` / ``changes(commit)``
any planner or executor asks for is served from that one pass.  The index is
shared across all targets of a dataset, and across datasets when they alias
the same table.

Thread-safety: executor workers for the targets of one dataset hit the same
index concurrently; the build happens once under a lock and the built
structures are read-only afterwards (snapshot materializations are memoized
under the same lock).
"""

from __future__ import annotations

import threading

from repro_torch.lst.schema import CommitEntry, TableState
from repro_torch.lst.table import FORMATS


class TableMetadataIndex:
    """One-replay commit index over a single LST handle.

    * ``head()`` is cheap (a directory listing / pointer read) and never
      triggers a replay — SKIP planning stays O(1).
    * ``entry(commit)`` / ``versions()`` / ``state_at(commit)`` build the
      index on first use; ``replays`` counts how many full log replays have
      happened (the instrumentation the O(commits) guarantee is tested by).
    """

    def __init__(self, handle):
        self.handle = handle
        self.replays = 0          # full log replays
        self.tail_replays = 0     # tail-only (since=...) refreshes
        self._lock = threading.RLock()
        self._built_head: str | None = None
        self._base: TableState | None = None
        self._order: list[str] = []
        self._entries: dict[str, CommitEntry] = {}
        self._state_memo: dict[str, TableState] = {}
        # per-cycle head hint (see probe()/hint_head()/end_cycle()):
        # _hint_token/_hint_state hold a just-probed head; _built_token is
        # the token the index was last refreshed AGAINST (None when the
        # index was last refreshed by its own head read)
        self._hint_token: str | None = None
        self._hint_state = None
        self._built_token: str | None = None

    # ------------------------------------------------------------- building
    def head(self) -> str:
        """The head commit id.

        Under a consumed per-cycle hint this is served from the index (the
        hinted refresh already read the log tail); otherwise it is one
        storage probe (``handle.current_version()``) — for iceberg a full
        metadata-discovery round, which is exactly what the hint removes.
        """
        with self._lock:
            hinted = self._hint_token
        if hinted:
            self.refresh()
            with self._lock:
                if self._built_token == hinted and \
                        self._built_head is not None:
                    return self._built_head
        return self.handle.current_version()

    # ------------------------------------------------- per-cycle head hints
    def probe(self) -> str:
        """ONE-request head probe that doubles as this cycle's head hint.

        Returns the opaque head token (what ``head_token()`` returns) and
        memoizes the probe's raw payload — delta: the head version number,
        iceberg: the hinted metadata-file version, hudi: the parsed
        completed-instant listing — so the planner's ``current_commit()``
        and this index's ``refresh()`` consume the SAME probe instead of
        re-reading the source head ~3x per changed cycle.  The hint is
        scoped to one daemon cycle: callers must ``end_cycle()`` when the
        cycle's drain finishes (refresh() is the one staleness point, and
        a lingering hint would pin it to a past head forever).
        """
        probe_fn = getattr(self.handle, "head_probe", None)
        if probe_fn is not None:
            token, state = probe_fn()
        else:
            tok_fn = getattr(self.handle, "head_token", None)
            token = tok_fn() if tok_fn is not None \
                else self.handle.current_version()
            state = None
        with self._lock:
            self._hint_token, self._hint_state = token, state
        return token

    def hint_head(self, token: str | None) -> None:
        """Install an externally probed head token as this cycle's hint
        (planner-facing; a daemon that already ran ``probe()`` on this
        index is a no-op).  Without the probe's raw payload the hinted
        refresh still replays the tail, it just cannot skip the head
        listing — the token alone still collapses the *repeat* head reads.
        """
        with self._lock:
            if token and token != self._hint_token:
                self._hint_token, self._hint_state = token, None

    def end_cycle(self) -> None:
        """Drop the per-cycle head hint (idempotent)."""
        with self._lock:
            self._hint_token = self._hint_state = None

    def ensure_built(self) -> "TableMetadataIndex":
        """Build from ONE log replay; no staleness check once built.

        Per-commit queries during a sync run must not re-read the table head
        (for iceberg that is a full metadata-JSON parse) hundreds of times —
        ``refresh()`` is the explicit staleness point, and a missing commit
        triggers one refresh attempt before failing.
        """
        with self._lock:
            if self._built_head is None:
                if self._hint_token:
                    self._refresh_hinted(self._hint_token, self._hint_state)
                else:
                    self._rebuild()
            return self

    def refresh(self) -> "TableMetadataIndex":
        """Refresh if (and only if) the table head moved since the build.

        A moved head replays only the NEW tail commits
        (``handle.replay(since=built_head, seed=...)``) and appends them to
        the index — O(new commits), not O(history).  A full rebuild happens
        only when there is no index yet, or when the anchor commit vanished
        from the log (vacuum / divergent rewrite).

        Under a per-cycle head hint (``probe()`` / ``hint_head()``) the
        staleness check costs ZERO storage requests: a hint matching the
        token the index was last refreshed against is a no-op, and a moved
        hint feeds the probe's payload straight into ``replay(probe=...)``
        so even the tail replay skips head rediscovery.  The new built head
        comes from the replayed entries themselves — no separate head read.
        """
        with self._lock:
            if self._hint_token:
                if self._built_token == self._hint_token:
                    return self
                return self._refresh_hinted(self._hint_token,
                                            self._hint_state)
            head = self.handle.current_version()
            self._built_token = None
            if self._built_head == head:
                return self
            if self._built_head is None:
                self._rebuild()
                return self
            try:
                _, entries = self.handle.replay(
                    since=self._built_head,
                    seed=self._entries.get(self._built_head))
            except (KeyError, FileNotFoundError, ValueError):
                self._rebuild()
                return self
            self._splice(entries)
            self._built_head = head
            return self

    def refresh_to(self, token: str, state=None) -> "TableMetadataIndex":
        """Single-flight refresh against an already-probed head ``token``.

        The read plane's building block: N concurrent readers who all saw
        the same probed token race here, and the RLock serializes them —
        the first one in pays the (tail-only) replay, every later one
        finds ``_built_token == token`` and returns at ZERO storage
        requests.  ``state`` is the probe's raw payload when the caller
        has it (``head_probe``), letting the replay skip head rediscovery
        exactly like the daemon's hinted refresh.

        The token is left installed as the index's head hint — the probe
        IS the head read, and the next ``refresh_to``/``refresh`` against
        the same token stays free.  A co-located daemon is unaffected:
        its own ``probe()`` overwrites the hint at cycle start and
        ``end_cycle()`` clears it.
        """
        with self._lock:
            if self._built_token == token:
                return self
            if state is None and self._hint_token == token:
                # keep the probe's memoized raw payload — a bare token
                # must not downgrade a richer hint for the same head
                state = self._hint_state
            self._hint_token, self._hint_state = token, state
            return self._refresh_hinted(token, state)

    def pinned_state(self) -> tuple[str, TableState]:
        """``(built_head, state_at(built_head))`` as one atomic pair.

        The snapshot-pinning read: the state is materialized from the
        index's memo under the lock (zero storage requests once built),
        and the returned ``TableState`` is immutable by construction —
        later refreshes append new entries and memoize new states, they
        never mutate one already handed out.
        """
        with self._lock:
            self.ensure_built()
            head = self._built_head
            if head is None:
                raise FileNotFoundError("table has no commits to pin")
            return head, self.state_at(head)

    def _refresh_hinted(self, token: str, state) -> "TableMetadataIndex":
        """Refresh against a probed head: the probe IS the head read."""
        if self._built_head is None:
            self._rebuild(probe=state)
            self._built_token = token
            return self
        try:
            _, entries = self._replay(since=self._built_head,
                                      seed=self._entries.get(self._built_head),
                                      probe=state)
        except (KeyError, FileNotFoundError, ValueError):
            self._rebuild(probe=state)
            self._built_token = token
            return self
        self._splice(entries)
        if entries:
            self._built_head = entries[-1].version
        self._built_token = token
        return self

    def _splice(self, entries) -> None:
        self.tail_replays += 1
        for e in entries:
            if e.version not in self._entries:
                self._order.append(e.version)
            self._entries[e.version] = e

    def _replay(self, *, since=None, seed=None, probe=None):
        if probe is None:   # duck-typed handles need not accept probe=
            return self.handle.replay(since=since, seed=seed)
        return self.handle.replay(since=since, seed=seed, probe=probe)

    def _rebuild(self, probe=None) -> None:
        base, entries = self._replay(probe=probe)
        self.replays += 1
        self._base = base
        self._order = [e.version for e in entries]
        self._entries = {e.version: e for e in entries}
        self._state_memo = {}
        # the head falls out of the replay itself (last entry / the base
        # state) — reading it separately would be one more round trip AND
        # racy against a writer landing between the two reads
        if entries:
            self._built_head = entries[-1].version
        elif base is not None:
            self._built_head = base.version
        else:
            self._built_head = self.handle.current_version()

    # ------------------------------------------------- checkpoint seeding
    def snapshot_seed(self, window: int) -> tuple[TableState, list[CommitEntry]] | None:
        """The warm-restart seed: the folded state at an anchor ``window``
        commits behind the built head, plus the entries from the anchor
        (inclusive) to the head.

        ``restore_seed`` on a fresh index re-installs exactly this — enough
        for a restarted daemon to serve ``state_at(head)`` with zero
        storage reads and ``get_commits_since(token)`` for any token inside
        the window, while the next ``refresh()`` replays only the commits
        that landed *after* the checkpoint (O(new), never O(history)).
        Returns ``None`` when the index was never built or holds no entries
        (a cold build on an empty table is already cheap).
        """
        with self._lock:
            if self._built_head is None or not self._order:
                return None
            k = len(self._order) - min(len(self._order), max(1, window))
            anchor = self._order[k]
            # RLock: state_at's fold happens under this same lock, and the
            # anchor is indexed, so this triggers no storage requests
            base = self.state_at(anchor)
            entries = [self._entries[v] for v in self._order[k:]]
            return base, entries

    def restore_seed(self, base: TableState,
                     entries: list[CommitEntry]) -> bool:
        """Seed a fresh index from a checkpoint (inverse of
        ``snapshot_seed``); refuses on a live index — real replays win.

        ``base`` is the state AT ``entries[0]``'s commit, so the fold in
        ``state_at`` re-applies that entry onto its own resulting state —
        idempotent (adds re-assign the same file by path, removes pop
        already-absent keys).  The seed is advisory: the next ``refresh()``
        replays the tail since the seeded head against the LIVE table, and
        a head the log no longer reaches from our anchor (vacuumed /
        divergent rewrite / behind the anchor) falls back to a full
        rebuild — a stale checkpoint can cost a rebuild, never a wrong
        splice.
        """
        with self._lock:
            if self._built_head is not None or not entries:
                return False
            self._base = base
            self._order = [e.version for e in entries]
            self._entries = {e.version: e for e in entries}
            self._state_memo = {}
            self._built_head = entries[-1].version
            self._built_token = None
            return True

    # -------------------------------------------------------------- queries
    def versions(self) -> list[str]:
        self.refresh()
        return list(self._order)

    def has(self, commit: str) -> bool:
        self.ensure_built()
        if commit in self._entries:
            return True
        return commit in self.refresh()._entries

    def entry(self, commit: str) -> CommitEntry:
        self.ensure_built()
        if commit not in self._entries:
            self.refresh()
        return self._entries[commit]

    def state_at(self, commit: str | None = None) -> TableState:
        """Materialize ``snapshot(commit)`` by folding indexed entries.

        Folds from the nearest earlier memoized state (or the replay base),
        so repeated asks — every target wants the head snapshot — cost one
        dict fold total, and zero further file reads.
        """
        if commit is None:
            self.refresh()
        else:
            self.ensure_built()
        with self._lock:
            if commit is None:
                commit = self._built_head
            if self._base is not None and commit == self._base.version:
                return self._base
            if commit in self._state_memo:
                return self._state_memo[commit]
            if commit not in self._entries:
                self.refresh()
            if commit not in self._entries:
                raise KeyError(f"commit {commit} not in indexed history")
            upto = self._order.index(commit)
            # nearest memoized prefix to fold from
            start, files = -1, dict(self._base.files) if self._base else {}
            for i in range(upto - 1, -1, -1):
                v = self._order[i]
                if v in self._state_memo:
                    start, files = i, dict(self._state_memo[v].files)
                    break
            for i in range(start + 1, upto + 1):
                e = self._entries[self._order[i]]
                for p in e.removes:
                    files.pop(p, None)
                for f in e.adds:
                    files[f.path] = f
            e = self._entries[commit]
            st = TableState(self.handle.format, commit, e.timestamp_ms,
                            e.schema, e.partition_spec, files,
                            dict(e.properties))
            self._state_memo[commit] = st
            return st


class MetadataCache:
    """(format, base_path) -> TableMetadataIndex, shared across a sync run.

    All targets of a dataset (and all datasets of a config) resolve their
    source questions through one cache instance, which is what turns the
    per-target O(commits^2) replay work into one O(commits) pass per table.
    """

    def __init__(self, fs):
        self.fs = fs
        self._lock = threading.Lock()
        self._indexes: dict[tuple[str, str], TableMetadataIndex] = {}

    def index(self, fmt: str, base_path: str) -> TableMetadataIndex:
        key = (fmt, base_path)
        with self._lock:
            idx = self._indexes.get(key)
            if idx is None:
                idx = TableMetadataIndex(FORMATS[fmt].open(self.fs, base_path))
                self._indexes[key] = idx
            return idx

    def peek(self, fmt: str, base_path: str) -> TableMetadataIndex | None:
        """The cached index if one exists — never opens the handle (the
        daemon's end-of-cycle hint cleanup must not fail on a table whose
        probe already failed to open)."""
        with self._lock:
            return self._indexes.get((fmt, base_path))

    def total_replays(self) -> int:
        with self._lock:
            return sum(i.replays for i in self._indexes.values())
