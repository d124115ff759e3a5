# Copy of repro/core/targets.py; the port imports nothing of repro.
"""Target writers (paper §3.1): Unified Internal Representation -> format.

Mirror images of the source readers. A target writer materializes IR
snapshots/changes as native metadata of its format, *referencing the same
data files* (metadata-only translation — the paper's low-overhead property).

Sync state (which source commit the target reflects) is persisted **in the
target's own metadata layer**, exactly as real XTable does: Delta table
configuration, Iceberg table properties / snapshot summary, Hudi commit
``extraMetadata``. That makes incremental sync recoverable from the target
alone — there is no side database to lose.
"""

from __future__ import annotations

import json
from contextlib import contextmanager
from typing import Protocol

from repro_torch.core.ir import InternalSnapshot, TableChange
from repro_torch.lst.delta import DeltaTable
from repro_torch.lst.hudi import HudiTable, schema_from_avro
from repro_torch.lst.iceberg import IcebergTable

TOKEN_KEY = "xtable.lastSyncedSourceCommit"
SOURCE_FMT_KEY = "xtable.sourceFormat"
MODE_KEY = "xtable.lastSyncMode"
LINEAGE_KEY = "xtable.coalescedCommits"


class ConversionTarget(Protocol):
    format: str

    def get_sync_token(self) -> str | None: ...
    def full_sync(self, snapshot: InternalSnapshot) -> str: ...
    def incremental_sync(self, change: TableChange) -> str: ...


class _HandleTarget:
    handle_cls = None
    format = "?"

    def __init__(self, fs, base_path: str, *,
                 manifest_compaction_threshold: int | None = None):
        self.fs = fs
        self.base = base_path
        self.handle = (self.handle_cls.open(fs, base_path)
                       if self.handle_cls.exists(fs, base_path) else None)
        self._snap = None       # cached target-side TableState (one replay)
        self._schema = None     # tracked current schema across commits
        self._state = None      # cached sync-state dict (one tail read)
        self._txn = None        # active handle transaction (None = direct)
        self._in_txn = False
        # format-specific transaction knobs (iceberg: manifest compaction)
        self._txn_opts: dict = {}
        if manifest_compaction_threshold is not None \
                and self.format == "iceberg":
            self._txn_opts["manifest_compaction_threshold"] = \
                manifest_compaction_threshold

    # -- target-side metadata cache ----------------------------------------
    # the target's own log is replayed at most once per writer instance;
    # afterwards the schema is tracked through the commits this writer makes
    # (it is the only writer of the unit), so an N-commit incremental unit
    # costs one replay of the target log instead of N.
    def _snapshot(self):
        if self._snap is None:
            self._snap = self.handle.snapshot()
        return self._snap

    def _current_schema(self):
        if self._schema is None:
            self._schema = self._snapshot().schema
        return self._schema

    # -- transactions -------------------------------------------------------
    # inside a transaction the handle's parsed metadata (version counter /
    # metadata dict + manifest list / timeline schema + properties) is read
    # once and threaded through every commit in memory.  Iceberg/hudi
    # buffer their commits: every non-commit-point object of the whole
    # drain (manifests, manifest-lists, instant markers) is staged and
    # flushed in ONE pipelined write_many round when the transaction
    # closes, and only the per-commit metadata puts stay serial — a crash
    # still leaves a valid prefix because staged objects are unreferenced
    # until their (ordered, atomic put-if-absent) commit point lands, and
    # recovery stays "run it again".
    @contextmanager
    def transaction(self):
        self._in_txn = True
        try:
            yield self
        except BaseException:
            txn, self._txn = self._txn, None
            self._in_txn = False
            if txn is not None:
                try:
                    txn.close()     # best-effort: land what was buffered
                except Exception:
                    pass            # the body's error is the root cause —
                    #                 a secondary flush failure must not
                    #                 mask it (recovery is "run it again")
            raise
        else:
            txn, self._txn = self._txn, None
            self._in_txn = False
            if txn is not None:
                txn.close()         # flush any buffered commits

    def _commit(self, adds, removes, **kw) -> str:
        if self._in_txn:
            if self._txn is None:   # lazy: FULL sync may create the table
                self._txn = self._begin_txn()
            return self._txn.commit(adds, removes, **kw)
        return self.handle.commit(adds, removes, **kw)

    def _begin_txn(self):
        """Open the handle transaction, seeding it with whatever target
        metadata this writer already read at plan time (format overrides
        pass their cached state so begin costs zero re-reads)."""
        return self.handle.transaction(schema=self._schema, **self._txn_opts)

    # -- sync-state bookkeeping (stored in target-native metadata) ---------
    def get_sync_token(self) -> str | None:
        if self.handle is None:
            return None
        return self._read_state().get(TOKEN_KEY)

    def get_sync_source_format(self) -> str | None:
        if self.handle is None:
            return None
        return self._read_state().get(SOURCE_FMT_KEY)

    def _read_state(self) -> dict:
        if self._state is None:
            self._state = self._load_state()
        return self._state

    def _load_state(self) -> dict:
        return self._snapshot().properties

    def _state_props(self, src: InternalSnapshot | TableChange, mode: str) -> dict:
        return {TOKEN_KEY: src.source_commit,
                SOURCE_FMT_KEY: src.source_format, MODE_KEY: mode}

    # -- initialization -----------------------------------------------------
    def _ensure_table(self, schema, partition_spec) -> None:
        if self.handle is None:
            self.handle = self.handle_cls.create(
                self.fs, self.base, schema, partition_spec, {})
            self._snap = None
            self._schema = schema

    # -- FULL: reconcile target state to exactly the snapshot ---------------
    def full_sync(self, snapshot: InternalSnapshot) -> str:
        self._ensure_table(snapshot.schema, snapshot.partition_spec)
        cur = self._snapshot()
        cur_paths = set(cur.files)
        want = {f.physical_path: f for f in snapshot.files}
        removes = sorted(cur_paths - set(want))
        adds = [f.to_meta() for p, f in sorted(want.items())
                if p not in cur_paths]
        schema = None if cur.schema.logical_eq(snapshot.schema) \
            else snapshot.schema
        carried = {k: v for k, v in snapshot.properties.items()
                   if not k.startswith("xtable.")}
        props = {**carried, **self._state_props(snapshot, "FULL")}
        v = self._commit(
            adds, removes, schema=schema,
            properties=props,
            operation="xtable-full-sync",
            extra_meta=props)
        self._snap = None
        self._state = None
        self._schema = snapshot.schema
        return v

    # -- INCREMENTAL: replay one source commit (or a coalesced range) --------
    def incremental_sync(self, change: TableChange) -> str:
        if self.handle is None:
            raise RuntimeError("incremental sync on uninitialized target")
        cur_schema = self._current_schema()
        schema = None
        if change.schema is not None and not cur_schema.logical_eq(change.schema):
            schema = change.schema
        props = {**change.extra, **self._state_props(change, "INCREMENTAL")}
        extra = dict(props)
        if change.lineage:   # coalesced range: keep per-commit provenance
            extra[LINEAGE_KEY] = json.dumps(list(change.lineage))
        v = self._commit(
            [f.to_meta() for f in change.adds], list(change.removes),
            schema=schema, properties=props,
            operation=f"xtable-incr-{change.operation}",
            extra_meta=extra)
        self._snap = None
        self._state = None
        if change.schema is not None:
            self._schema = change.schema
        return v


class DeltaTarget(_HandleTarget):
    handle_cls = DeltaTable
    format = "delta"

    # sync state lives in the table configuration, which every sync commit
    # rewrites in its metaData action — the log TAIL answers "where is this
    # target?" in one read; replaying the whole log per planning pass would
    # make token reads O(history)
    def _load_state(self) -> dict:
        _, schema, _, props = self.handle.tail_state()
        if self._schema is None:
            self._schema = schema
        return props

    def _current_schema(self):
        if self._schema is None:
            self._schema = self.handle.tail_state()[1]
        return self._schema


class IcebergTarget(_HandleTarget):
    handle_cls = IcebergTable
    format = "iceberg"

    # iceberg keeps properties and schema in the metadata JSON; ONE metadata
    # read at plan time serves the sync token, the current schema AND the
    # transaction begin — re-discovering the head for each (hint read +
    # roll-forward + metadata parse) would pay ~3 extra RTT rounds per unit
    def __init__(self, fs, base_path, **kw):
        super().__init__(fs, base_path, **kw)
        self._meta = None       # (version, metadata dict) from _load_state

    def _load_state(self) -> dict:
        self._meta = self.handle.read_metadata()
        meta = self._meta[1]
        if self._schema is None:
            self._schema = self.handle.schema_from_metadata(meta)
        return dict(meta["properties"])

    def _current_schema(self):
        if self._schema is None:
            if self._meta is not None:
                self._schema = self.handle.schema_from_metadata(
                    self._meta[1])
            else:
                self._schema = self.handle.current_schema()
        return self._schema

    def _begin_txn(self):
        # seed the transaction with the plan-time metadata read: begin then
        # costs ZERO requests (a foreign commit in between surfaces as a
        # conflict at flush and re-syncs — the same race window as before)
        return self.handle.transaction(schema=self._schema, meta=self._meta,
                                       **self._txn_opts)


class HudiTarget(_HandleTarget):
    handle_cls = HudiTable
    format = "hudi"

    def __init__(self, fs, base_path, **kw):
        super().__init__(fs, base_path, **kw)
        self._props_full = None     # full hoodie.properties from _load_state

    def _load_state(self) -> dict:
        # hudi keeps sync state in the latest commit's extraMetadata, whose
        # values arrive already decoded by the shared extraMetadata codec;
        # the ONE properties read here also seeds the transaction begin
        em = self.handle.latest_extra_metadata()
        self._props_full = self.handle.table_properties()
        if self._schema is None:
            s = em.get("schema") or \
                self._props_full["hoodie.table.create.schema"]
            self._schema = schema_from_avro(s)
        out = {k: v for k, v in self._props_full.items()
               if not k.startswith("hoodie.")}
        for k in (TOKEN_KEY, SOURCE_FMT_KEY, MODE_KEY):
            if k in em:
                # sync-state values are strings by contract; a foreign/legacy
                # writer storing a raw numeric token (e.g. "7" for a delta
                # version) decodes as a scalar — coerce it back
                out[k] = em[k] if isinstance(em[k], str) else str(em[k])
        return out

    def _current_schema(self):
        # the schema rides in the newest instant's extraMetadata — one
        # instant read instead of a whole-timeline replay
        if self._schema is None:
            em = self.handle.latest_extra_metadata()
            s = em.get("schema") or \
                self.handle.table_properties()["hoodie.table.create.schema"]
            self._schema = schema_from_avro(s)
        return self._schema

    def _begin_txn(self):
        # seed the transaction with the plan-time properties read
        return self.handle.transaction(schema=self._schema,
                                       props=self._props_full)


TARGETS = {"delta": DeltaTarget, "iceberg": IcebergTarget, "hudi": HudiTarget}


def make_target(fmt: str, fs, base_path: str, *,
                manifest_compaction_threshold: int | None = None
                ) -> ConversionTarget:
    return TARGETS[fmt](
        fs, base_path,
        manifest_compaction_threshold=manifest_compaction_threshold)
