# Copy of repro/serve/read_plane.py; the port imports nothing of repro.
"""Snapshot-serving read plane: memoized head-keyed snapshots over any view.

The paper's interoperability claim is read-side — write once, read in any
format — but the batch pipeline only optimized the *write* path to
O(change).  A naive reader fleet still replays metadata per reader, so
read traffic scales O(readers x history) in storage requests.  This
module is the read-side counterpart (ROADMAP open item 3): a
:class:`SnapshotServer` layered on the shared
:class:`~repro_torch.core.metadata_cache.MetadataCache` that serves
**immutable table snapshots keyed by head token** in any format view,
with HTTP-conditional-GET economics:

* **Not-modified is free.**  A reader presenting its last-seen token gets
  ``not_modified`` for an unchanged table at zero storage requests; the
  server itself spends at most ONE O(1) head probe per table per
  ``ttlMs`` window, amortized across every reader of that table.  A
  co-located daemon removes even that probe: its post-drain
  :meth:`SnapshotServer.publish` hands the just-synced head token over,
  resetting the window.
* **Change is paid once.**  A moved head costs one tail-only index
  refresh (O(new commits)) shared by every waiting reader — the index's
  single-flight :meth:`~repro_torch.core.metadata_cache.TableMetadataIndex
  .refresh_to` serializes racing readers so N concurrent cold readers
  trigger exactly 1 replay, not N.
* **Snapshots are immutable.**  A served :class:`TableSnapshot` never
  changes under the reader, however many commits the daemon lands
  mid-read; new heads become NEW snapshots in a ``maxSnapshots``-bounded
  LRU.

Catalog-pinned reads extend the same machinery across *tables*:
:meth:`SnapshotServer.read_group` resolves every table of a dataset at
ONE catalog generation (``lst/catalog/``) and serves each member pinned
at its published ``(token, commit)`` — the token is the LRU key shared
with the conditional-GET path (a co-located daemon's eager publish means
group members are usually already memoized), and the commit pins the
exact published state via the index's ``state_at`` even after the table
has moved on.  A reader joining orders against customers through a
:class:`GroupSnapshot` can never observe tables from different publish
generations.

On top of snapshots, :meth:`SnapshotServer.scan` adds predicate pushdown
into the chunkfile stats footers: chunks whose min/max/nan_count refute
the predicate are pruned without touching their column data, footers are
fetched through the two-round batched footer read and cached immutably
by chunk path (chunks are write-once — the footer cache never
invalidates), and the surviving bodies come back in one pipelined batch
round.

With the CHK3 column-offset index (which rides for free in the cached
footer entries) the scan also pushes **projection** below the storage
round trip: only the requested + predicate columns' byte ranges are
fetched, adjacent ranges coalesced, all files per phase in one pipelined
``read_many_ranges`` round.  Predicated scans are **late-materializing**
by default (``readPlane.lateMaterialization``): phase 1 fetches just the
predicate columns and evaluates the row masks, chunks whose mask comes
back all-False are dropped before their remaining columns are ever
fetched (the data refutes what the stats could not), and phase 2 fetches
only the surviving chunks' projected columns.  Results stay
byte-identical to a full-body scan; CHK2 files transparently fall back
to full-body reads inside the same batch rounds.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.config import ReadPlaneOptions
from repro_torch.core.metadata_cache import MetadataCache
from repro_torch.lst import chunkfile
from repro_torch.lst.schema import TableState
from repro_torch.lst.table import Predicate

__all__ = ["OK", "NOT_MODIFIED", "TableSnapshot", "ReadResult",
           "ScanResult", "GroupSnapshot", "ReadPlaneStats",
           "SnapshotServer"]

OK = "ok"
NOT_MODIFIED = "not_modified"


@dataclass(frozen=True)
class TableSnapshot:
    """One immutable, head-token-keyed view of a table.

    ``token`` is the opaque head token of the ``view_format`` log at
    serve time (the conditional-GET ETag); ``head_commit`` is the
    format-native commit id the ``state`` was folded at.  The state is
    shared with the metadata index's memo and is never mutated after
    construction — later commits produce new snapshots.
    """
    base_path: str
    view_format: str
    token: str
    head_commit: str
    state: TableState
    created_at: float = 0.0

    @property
    def files(self) -> dict:
        return self.state.files

    @property
    def schema(self):
        return self.state.schema


@dataclass(frozen=True)
class ReadResult:
    """``status == "not_modified"`` carries no snapshot (the reader's own
    copy is current); ``"ok"`` carries the served snapshot."""
    status: str
    token: str
    snapshot: TableSnapshot | None = None


@dataclass(frozen=True)
class GroupSnapshot:
    """A consistent multi-table read: every member resolved at ONE
    catalog generation.

    ``generation`` is the catalog generation every member was resolved
    from; ``snapshots`` maps table name -> pinned :class:`TableSnapshot`.
    Like its members, a group snapshot never changes under the reader —
    later catalog publishes produce new groups.
    """
    generation: int
    snapshots: dict        # table name -> TableSnapshot

    def __getitem__(self, name: str) -> TableSnapshot:
        return self.snapshots[name]

    def __contains__(self, name: str) -> bool:
        return name in self.snapshots

    def __len__(self) -> int:
        return len(self.snapshots)

    def table_names(self) -> list:
        return sorted(self.snapshots)


@dataclass
class ScanResult:
    """Rows + the pruning census of one pushed-down scan.

    ``bytes_scanned`` counts body bytes actually FETCHED — with the CHK3
    column index a projected or late-materialized scan moves only the
    needed columns' ranges, and ``bytes_projected_away`` is what the
    index let it skip (candidate body bytes minus fetched bytes).
    ``files_pruned_late`` counts chunks whose phase-1 predicate columns
    proved no row matches (all-False mask), so their remaining columns
    were never fetched; such chunks were still touched, so they stay in
    ``files_scanned`` and the census invariant ``files_scanned +
    files_pruned_stats + files_pruned_meta == files_total`` is unchanged.
    """
    token: str
    rows: dict = field(default_factory=dict)   # column -> np.ndarray
    files_total: int = 0
    files_pruned_meta: int = 0     # refuted by metadata-layer stats
    files_pruned_stats: int = 0    # refuted by chunk footer stats
    files_pruned_late: int = 0     # all-False phase-1 mask: phase 2 skipped
    files_scanned: int = 0         # chunks whose data was touched
    bytes_scanned: int = 0         # body bytes actually fetched
    bytes_projected_away: int = 0  # candidate body bytes the index skipped
    bytes_skipped: int = 0         # body bytes stats pruning avoided


@dataclass
class ReadPlaneStats:
    """Thread-safe serving counters (the bench/test instrumentation)."""
    reads: int = 0             # read() calls answered
    not_modified: int = 0      # answered "your token is current"
    snapshot_hits: int = 0     # served straight from the snapshot LRU
    snapshot_builds: int = 0   # new snapshot materialized
    probes: int = 0            # head probes actually issued
    published: int = 0         # tokens handed over by a co-located daemon
    evictions: int = 0         # snapshots dropped by the LRU bound
    group_reads: int = 0       # catalog-pinned read_group() calls
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    @property
    def hit_rate(self) -> float:
        """Fraction of reads that cost zero metadata work (not-modified
        answers + LRU snapshot hits)."""
        if not self.reads:
            return 0.0
        return (self.not_modified + self.snapshot_hits) / self.reads


@dataclass
class _TableEntry:
    """Per-(format, table) serving state: the freshest known token and
    when it goes stale."""
    lock: threading.Lock = field(default_factory=threading.Lock)
    token: str | None = None
    fresh_until: float = float("-inf")   # clock time the token expires


class SnapshotServer:
    """Conditional-GET snapshot serving over the shared metadata cache.

    One server instance fronts any number of tables in any format view;
    readers address tables by ``(base_path, fmt)``.  Construction is
    cheap — all state builds lazily on first read.  ``clock`` is any
    object with a ``now() -> float`` (the daemon's injected clocks fit);
    wall time by default.

    Thread-safety: reader calls may come from any thread.  Token
    freshness is guarded per table (so one probe per TTL window is a hard
    bound, not a fast path), snapshot materialization rides the metadata
    index's own single-flight lock, and the snapshot LRU has a server
    lock of its own.  Lock order is entry -> index -> server; no lock is
    held while storage is touched except the index's (which is exactly
    the single-flight contract).
    """

    def __init__(self, fs, *, options: ReadPlaneOptions | None = None,
                 cache: MetadataCache | None = None, clock=None):
        self.fs = fs
        self.options = options or ReadPlaneOptions()
        self.cache = cache or MetadataCache(fs)
        self._now = clock.now if clock is not None else time.monotonic
        self.stats = ReadPlaneStats()
        self._lock = threading.Lock()
        self._tables: dict[tuple[str, str], _TableEntry] = {}
        # (fmt, base_path, token) -> TableSnapshot; end = most recent
        self._snapshots: OrderedDict[tuple[str, str, str], TableSnapshot] = \
            OrderedDict()
        self.stats_cache = chunkfile.ChunkStatsCache(
            self.options.stats_cache_bytes)

    # ------------------------------------------------------------- serving
    def read(self, base_path: str, fmt: str, *,
             if_token: str | None = None) -> ReadResult:
        """Serve the table's current snapshot, conditional-GET style.

        A reader passing its last-seen token as ``if_token`` gets
        ``not_modified`` (no snapshot payload) when the table is
        unchanged — at zero storage requests within the probe window.
        Otherwise the freshest snapshot is served, from the LRU when
        memoized, else materialized once (single-flight) and memoized.
        """
        self.stats.bump("reads")
        token = self._current_token(base_path, fmt)
        if if_token is not None and if_token == token:
            self.stats.bump("not_modified")
            return ReadResult(NOT_MODIFIED, token)
        return ReadResult(OK, token, self._snapshot_for(base_path, fmt,
                                                        token))

    def scan(self, base_path: str, fmt: str,
             predicates: tuple[Predicate, ...] = (), *,
             columns: list[str] | None = None) -> ScanResult:
        """Snapshot-pinned scan with stats pushdown (see module doc).

        Row semantics match ``LakeTable.scan`` exactly — same file order
        (state insertion order), same metadata pruning, same row masks —
        the footer-stats layer only removes chunk-body reads the stats
        *prove* cannot contribute rows, so the result is byte-identical
        to an unpruned scan.
        """
        snap = self.read(base_path, fmt).snapshot
        return self.scan_snapshot(snap, predicates, columns=columns)

    def scan_snapshot(self, snap: TableSnapshot,
                      predicates: tuple[Predicate, ...] = (), *,
                      columns: list[str] | None = None) -> ScanResult:
        """``scan()`` against a snapshot the reader already holds (the
        pinned-view variant: immune to concurrent commits).

        ``columns`` projects the result, pushed below the round trip via
        the CHK3 column index; with predicates and
        ``readPlane.lateMaterialization`` on (default) the fetch is
        two-phase (see module doc).  A no-predicate, no-projection scan
        keeps the single pipelined full-body round.
        """
        predicates = tuple(predicates)
        res = ScanResult(token=snap.token)
        metas = list(snap.state.files.values())
        res.files_total = len(metas)
        candidates = [f for f in metas
                      if all(p.may_match_file(f) for p in predicates)]
        res.files_pruned_meta = len(metas) - len(candidates)
        project = bool(columns)
        late = bool(predicates) and self.options.late_materialization
        want_stats = any(p.column not in f.partition_values
                         for p in predicates for f in candidates)
        footers = None
        # ONE (cached, batched) footer fetch powers BOTH the stats
        # refutation and the column index the projected phases need
        if candidates and (want_stats or project or late):
            footers = self.stats_cache.get_many(
                self.fs, snap.base_path, [f.path for f in candidates])
            if want_stats:
                kept = []
                for f, ftr in zip(candidates, footers):
                    if any(chunkfile.stats_refute(ftr.stats, p.column,
                                                  p.op, p.value)
                           for p in predicates
                           if p.column not in f.partition_values):
                        res.files_pruned_stats += 1
                        res.bytes_skipped += f.size_bytes
                    else:
                        kept.append((f, ftr))
                candidates = [f for f, _ in kept]
                footers = [ftr for _, ftr in kept]
        res.files_scanned = len(candidates)
        full_bytes = sum(f.size_bytes for f in candidates)
        if not candidates:
            return res
        if not project and not late:
            # the pre-index path, unchanged: ONE pipelined full-body round
            res.bytes_scanned = full_bytes
            bodies = chunkfile.read_chunks(self.fs, snap.base_path,
                                           [f.path for f in candidates])
            batches = [self._finish(cols, predicates, columns)
                       for cols, _extra in bodies]
        elif late:
            batches = self._scan_late(snap.base_path, candidates, footers,
                                      predicates, columns, res)
        else:
            # projection without predicates (or knob off): one ranged
            # round over the needed columns of every candidate
            need = sorted({*columns, *(p.column for p in predicates)})
            fetched = chunkfile.read_chunks_columns(
                self.fs, snap.base_path, [f.path for f in candidates],
                need, footers=footers)
            batches = []
            for cols, nbytes in fetched:
                res.bytes_scanned += nbytes
                batches.append(self._finish(cols, predicates, columns))
        res.bytes_projected_away = full_bytes - res.bytes_scanned
        if batches:
            res.rows = {c: np.concatenate([b[c] for b in batches])
                        for c in batches[0]}
        return res

    @staticmethod
    def _finish(cols: dict, predicates, columns) -> dict:
        """Mask + project one file's columns.  The mask is sized from the
        data, not the metadata record_count — a stats-poor metadata layer
        may carry 0 there."""
        nrows = next(iter(cols.values())).shape[0] if cols else 0
        mask = np.ones(nrows, bool)
        for p in predicates:
            if p.column in cols:
                mask &= p.mask(cols[p.column])
        if columns:
            cols = {c: cols[c] for c in columns if c in cols}
        return {c: a[mask] if a.shape[:1] == mask.shape else a
                for c, a in cols.items()}

    def _scan_late(self, base_path: str, candidates, footers, predicates,
                   columns, res: ScanResult) -> list:
        """Two-phase late materialization over one scan's candidates.

        Phase 1 fetches ONLY the predicate columns of every candidate
        (one ranged batch round; CHK2 files fall back to full bodies in
        the same round) and evaluates the row masks.  A CHK3 chunk whose
        mask comes back all-False is dropped — the data refuted what its
        stats could not — contributing a zero-row batch synthesized from
        its footer schema (so concatenation dtypes match the full-body
        scan exactly) and never paying for its remaining columns.  Phase
        2 fetches the survivors' still-missing output columns in one
        more ranged batch round.
        """
        project = bool(columns)
        pred_cols = sorted({p.column for p in predicates})
        phase1 = chunkfile.read_chunks_columns(
            self.fs, base_path, [f.path for f in candidates], pred_cols,
            footers=footers)
        batches: list = [None] * len(candidates)
        work = []                          # (index, cols1, mask) for phase 2
        p2_paths, p2_footers = [], []
        for i, (f, ftr, (cols1, nbytes)) in enumerate(
                zip(candidates, footers, phase1)):
            res.bytes_scanned += nbytes
            nrows = (next(iter(cols1.values())).shape[0] if cols1
                     else ftr.nrows)
            mask = np.ones(nrows, bool)
            for p in predicates:
                if p.column in cols1:
                    mask &= p.mask(cols1[p.column])
            if not ftr.projectable:
                # CHK2: phase 1 was already the whole body — finish now
                cols = cols1
                if project:
                    cols = {c: cols[c] for c in columns if c in cols}
                batches[i] = {c: a[mask] if a.shape[:1] == mask.shape else a
                              for c, a in cols.items()}
                continue
            out_names = ([c for c in columns if c in ftr.schema] if project
                         else [n for n, _o, _l in ftr.columns])
            if not mask.any() and all(
                    tuple(ftr.schema[c]["shape"][:1]) == (nrows,)
                    for c in out_names):
                res.files_pruned_late += 1
                batches[i] = {c: chunkfile.empty_column(ftr.schema[c])
                              for c in out_names}
                continue
            work.append((i, cols1, mask))
            p2_paths.append(f.path)
            p2_footers.append(ftr)
        if work:
            fetched2 = chunkfile.read_chunks_columns(
                self.fs, base_path, p2_paths,
                columns if project else None,
                footers=p2_footers, exclude=set(pred_cols))
            for (i, cols1, mask), (cols2, nbytes) in zip(work, fetched2):
                res.bytes_scanned += nbytes
                merged = {**cols1, **cols2}
                if project:
                    cols = {c: merged[c] for c in columns if c in merged}
                else:
                    # restore the file's schema order (phase-1 predicate
                    # columns came first in `merged`)
                    cols = {n: merged[n] for n, _o, _l in footers[i].columns
                            if n in merged}
                batches[i] = {c: a[mask] if a.shape[:1] == mask.shape else a
                              for c, a in cols.items()}
        return batches

    # ------------------------------------------------- catalog-pinned reads
    def read_at(self, base_path: str, fmt: str, token: str,
                commit: str) -> TableSnapshot:
        """Serve the snapshot pinned at a published ``(token, commit)``.

        The catalog-pinned building block: ``token`` keys the same LRU
        the conditional-GET path fills (a co-located daemon's eager
        post-drain publish makes this a pure memo hit), and ``commit``
        pins the exact published state through the index's ``state_at``
        — correct even when the table has moved past the pointer, which
        a head-chasing ``refresh_to`` would not be.  Beyond the index's
        one-time build, a pinned read costs ZERO storage requests while
        memoized and at most one tail refresh when not.
        """
        self.stats.bump("reads")
        key = (fmt, base_path, token)
        with self._lock:
            snap = self._snapshots.get(key)
            if snap is not None:
                self._snapshots.move_to_end(key)
                self.stats.bump("snapshot_hits")
                return snap
        index = self.cache.index(fmt, base_path)
        state = index.state_at(commit)
        snap = TableSnapshot(base_path=base_path, view_format=fmt,
                             token=token, head_commit=commit, state=state,
                             created_at=self._now())
        with self._lock:
            if key in self._snapshots:
                self._snapshots.move_to_end(key)
                return self._snapshots[key]
            self._snapshots[key] = snap
            self.stats.bump("snapshot_builds")
            while len(self._snapshots) > self.options.max_snapshots:
                self._snapshots.popitem(last=False)
                self.stats.bump("evictions")
        return snap

    def read_group(self, catalog, tables=None, *, group: str | None = None,
                   fmt: str | None = None) -> GroupSnapshot:
        """Consistent multi-table read through a catalog (see module doc).

        Resolves ONE catalog generation up front (one LIST, plus one GET
        only when the generation moved) and serves every requested table
        pinned at that generation's published ``(token, commit)`` — the
        members can never mix publish generations, however many group
        commits land while the reader iterates.

        ``group`` selects a published dataset group, ``tables`` an
        explicit name list; neither means every registered table.
        ``fmt`` picks a specific format view (default: each table's
        source view); a table without that published view raises
        ``KeyError`` rather than silently serving a differently pinned
        one.
        """
        cat = catalog.snapshot()
        if group is not None:
            names = cat.group(group)
        elif tables is not None:
            names = tuple(tables)
        else:
            names = tuple(cat.table_names())
        snaps = {}
        for name in names:
            ptr = cat.resolve(name)
            ref = ptr.view(fmt)
            snaps[name] = self.read_at(ptr.base_path,
                                       fmt or ptr.source_format,
                                       ref.token, ref.commit)
        self.stats.bump("group_reads")
        return GroupSnapshot(generation=cat.generation, snapshots=snaps)

    # ---------------------------------------------------- daemon co-location
    def publish(self, base_path: str, fmt: str, token: str) -> None:
        """Co-located daemon hook: install a just-synced head token.

        Called post-drain with the cycle's probed token, while the index
        still carries that cycle's head hint — so the eager snapshot
        build below costs zero storage requests (the daemon's replay
        already indexed the head), and every reader inside the next TTL
        window is served without even the probe.
        """
        entry = self._entry(base_path, fmt)
        with entry.lock:
            entry.token = token
            entry.fresh_until = self._now() + self.options.ttl_ms / 1000.0
        self.stats.bump("published")
        try:
            self._snapshot_for(base_path, fmt, token)
        except Exception:
            # eager materialization is an optimization; the first reader
            # retries it with real error propagation
            pass

    # ------------------------------------------------------------ internals
    def _entry(self, base_path: str, fmt: str) -> _TableEntry:
        with self._lock:
            return self._tables.setdefault((fmt, base_path), _TableEntry())

    def _current_token(self, base_path: str, fmt: str) -> str:
        """The freshest head token, probing at most once per TTL window.

        The entry lock is held across the probe on purpose: concurrent
        readers of a stale window serialize here and all but the first
        find the refreshed deadline — "<= 1 probe per window per table"
        is a guarantee, not an expectation.
        """
        entry = self._entry(base_path, fmt)
        with entry.lock:
            now = self._now()
            if entry.token is not None and now < entry.fresh_until:
                return entry.token
            index = self.cache.index(fmt, base_path)
            entry.token = index.probe()
            entry.fresh_until = now + self.options.ttl_ms / 1000.0
            self.stats.bump("probes")
            return entry.token

    def _snapshot_for(self, base_path: str, fmt: str,
                      token: str) -> TableSnapshot:
        key = (fmt, base_path, token)
        with self._lock:
            snap = self._snapshots.get(key)
            if snap is not None:
                self._snapshots.move_to_end(key)
                self.stats.bump("snapshot_hits")
                return snap
        index = self.cache.index(fmt, base_path)
        # single-flight: racing builders serialize on the index lock and
        # at most one pays the (tail-only) replay
        index.refresh_to(token)
        head, state = index.pinned_state()
        snap = TableSnapshot(base_path=base_path, view_format=fmt,
                             token=token, head_commit=head, state=state,
                             created_at=self._now())
        with self._lock:
            if key in self._snapshots:
                # a racing builder won; serve its (identical) snapshot
                self._snapshots.move_to_end(key)
                return self._snapshots[key]
            self._snapshots[key] = snap
            self.stats.bump("snapshot_builds")
            while len(self._snapshots) > self.options.max_snapshots:
                self._snapshots.popitem(last=False)
                self.stats.bump("evictions")
        return snap

    def snapshot_count(self) -> int:
        with self._lock:
            return len(self._snapshots)
