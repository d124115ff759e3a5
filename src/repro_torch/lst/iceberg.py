# Copy of repro/lst/iceberg.py; the port imports nothing of repro.
"""Iceberg-style LST: snapshot -> manifest-list -> manifest metadata chain.

Faithful architectural reimplementation of the Iceberg table spec (v2):

* ``metadata/v{N}.metadata.json`` — table metadata: schemas (with *field ids*),
  partition specs (with transforms), properties, the snapshot list, and
  ``current-snapshot-id``; plus ``metadata/version-hint.text`` (Hadoop-catalog
  style pointer). Commit = put-if-absent of the next metadata file.
* ``metadata/snap-{id}.manifest-list.json`` — one manifest-list per snapshot.
* ``metadata/manifest-{id}-{k}.json`` — manifest files holding data-file
  entries with status ADDED(1)/EXISTING(0)/DELETED(2) and column bounds.
* Manifest *reuse*: a new snapshot's manifest list references untouched
  manifests from the parent snapshot as-is — only new/affected manifests are
  written. This is the property that makes Iceberg commits (and XTable's
  incremental translation into Iceberg) O(change), not O(table).
"""

from __future__ import annotations

import json
import time
import uuid

from repro_torch.lst.chunkfile import ColumnStats, DataFileMeta
from repro_torch.lst.storage import PutIfAbsentError, fetch_many, flush_many, join
from repro_torch.lst.schema import (CommitEntry, Field, PartitionField,
                              PartitionSpec, Schema, TableState)

FORMAT = "iceberg"
META_DIR = "metadata"
ADDED, EXISTING, DELETED = 1, 0, 2

_TYPES_TO_ICE = {"int32": "int", "int64": "long", "float32": "float",
                 "float64": "double", "string": "string", "bool": "boolean",
                 "binary": "binary", "timestamp": "timestamptz"}
_ICE_TO_TYPES = {v: k for k, v in _TYPES_TO_ICE.items()}


def schema_to_ice(schema: Schema) -> dict:
    schema = schema.with_ids()
    return {"type": "struct", "schema-id": schema.schema_id,
            "fields": [{"id": f.field_id, "name": f.name,
                        "required": not f.nullable,
                        "type": _TYPES_TO_ICE[f.type]} for f in schema.fields]}


def schema_from_ice(d: dict) -> Schema:
    return Schema([Field(f["name"], _ICE_TO_TYPES[f["type"]],
                         not f["required"], f["id"]) for f in d["fields"]],
                  d.get("schema-id", 0))


def spec_to_ice(spec: PartitionSpec, schema: Schema) -> dict:
    schema = schema.with_ids()
    ids = {f.name: f.field_id for f in schema.fields}
    return {"spec-id": 0, "fields": [
        {"source-id": ids[f.source], "field-id": 1000 + i,
         "transform": f.transform, "name": f.out_name}
        for i, f in enumerate(spec.fields)]}


def spec_from_ice(d: dict, schema: Schema) -> PartitionSpec:
    names = {f.field_id: f.name for f in schema.fields}
    return PartitionSpec([PartitionField(names[f["source-id"]], f["transform"],
                                         f["name"]) for f in d["fields"]])


def _file_to_entry(f: DataFileMeta, status: int, snapshot_id: int) -> dict:
    return {"status": status, "snapshot-id": snapshot_id, "data-file": {
        "file-path": f.path, "file-format": "CHUNKFILE",
        "partition": {k: v for k, v in f.partition_values.items()},
        "record-count": f.record_count, "file-size-in-bytes": f.size_bytes,
        "lower-bounds": {k: s.min for k, s in f.column_stats.items()},
        "upper-bounds": {k: s.max for k, s in f.column_stats.items()},
        "null-value-counts": {k: s.nan_count for k, s in f.column_stats.items()},
        "value-counts": {k: s.count for k, s in f.column_stats.items()},
        "extra": f.extra or {}}}


def _file_from_entry(e: dict) -> DataFileMeta:
    df = e["data-file"]
    cols = set(df.get("lower-bounds", {})) | set(df.get("upper-bounds", {})) | \
        set(df.get("null-value-counts", {}))
    stats = {c: ColumnStats(df.get("lower-bounds", {}).get(c),
                            df.get("upper-bounds", {}).get(c),
                            df.get("value-counts", {}).get(c, 0),
                            df.get("null-value-counts", {}).get(c, 0))
             for c in cols}
    return DataFileMeta(path=df["file-path"], size_bytes=df["file-size-in-bytes"],
                        record_count=df["record-count"],
                        partition_values=dict(df.get("partition", {})),
                        column_stats=stats, extra=dict(df.get("extra", {})))


class CommitConflict(RuntimeError):
    pass


class IcebergTable:
    format = FORMAT

    def __init__(self, fs, base_path: str):
        self.fs = fs
        self.base = base_path

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def exists(cls, fs, base_path: str) -> bool:
        return any(n.endswith(".metadata.json")
                   for n in fs.list_dir(join(base_path, META_DIR)))

    @classmethod
    def create(cls, fs, base_path: str, schema: Schema,
               partition_spec: PartitionSpec = PartitionSpec(),
               properties: dict | None = None) -> "IcebergTable":
        t = cls(fs, base_path)
        schema = schema.with_ids()
        meta = {
            "format-version": 2, "table-uuid": str(uuid.uuid4()),
            "location": base_path, "last-sequence-number": 0,
            "last-updated-ms": _now_ms(),
            "last-column-id": max((f.field_id or 0) for f in schema.fields),
            "schemas": [schema_to_ice(schema)], "current-schema-id": schema.schema_id,
            "partition-specs": [spec_to_ice(partition_spec, schema)],
            "default-spec-id": 0,
            "properties": {k: str(v) for k, v in (properties or {}).items()},
            "current-snapshot-id": -1, "snapshots": [], "snapshot-log": [],
        }
        t._write_metadata(1, meta)
        return t

    @classmethod
    def open(cls, fs, base_path: str) -> "IcebergTable":
        if not cls.exists(fs, base_path):
            raise FileNotFoundError(f"no iceberg table at {base_path}")
        return cls(fs, base_path)

    # ------------------------------------------------------------- metadata
    def _meta_path(self, n: int) -> str:
        return join(self.base, META_DIR, f"v{n}.metadata.json")

    def _hint_path(self) -> str:
        return join(self.base, META_DIR, "version-hint.text")

    def _current_meta_version(self) -> int:
        try:
            # read the hint directly (no exists() pre-flight — one fewer
            # round trip; a missing hint is the rare foreign-table case)
            n = int(self.fs.read_bytes(self._hint_path()).decode().strip())
        except FileNotFoundError:
            versions = [int(x[1:-len(".metadata.json")])
                        for x in self.fs.list_dir(join(self.base, META_DIR))
                        if x.startswith("v") and x.endswith(".metadata.json")]
            if not versions:
                raise FileNotFoundError("no iceberg metadata") from None
            return max(versions)
        # the hint may lag a concurrent commit; roll forward
        while self.fs.exists(self._meta_path(n + 1)):
            n += 1
        return n

    def _read_metadata(self, n: int | None = None) -> tuple[int, dict]:
        n = n if n is not None else self._current_meta_version()
        return n, json.loads(self.fs.read_bytes(self._meta_path(n)))

    def _write_metadata(self, n: int, meta: dict) -> None:
        try:
            self.fs.write_bytes(self._meta_path(n), json.dumps(meta).encode())
        except PutIfAbsentError as e:
            raise CommitConflict(f"iceberg metadata v{n} exists") from e
        self.fs.write_bytes(self._hint_path(), str(n).encode(), overwrite=True)

    # ------------------------------------------------------------ manifests
    def _read_manifest(self, path: str) -> list[dict]:
        return json.loads(self.fs.read_bytes(join(self.base, path)))["entries"]

    def _read_manifests_many(self, paths: list[str]) -> dict[str, list[dict]]:
        """Batched manifest fetch: independent GETs pipelined via
        ``read_many`` (one round of round trips, not one per manifest)."""
        blobs = fetch_many(self.fs, [join(self.base, p) for p in paths])
        return {p: json.loads(raw)["entries"] for p, raw in zip(paths, blobs)}

    def _write_manifest(self, name: str, entries: list[dict]) -> str:
        rel = join(META_DIR, name)
        self.fs.write_bytes(join(self.base, rel),
                            json.dumps({"entries": entries}).encode())
        return rel

    def _stage_manifest(self, name: str, entries: list[dict],
                        staged: list[tuple[str, bytes]]) -> str:
        """Append a manifest to a staged-write batch instead of putting it
        immediately; the caller flushes the batch in one pipelined round
        before the commit-point metadata put."""
        rel = join(META_DIR, name)
        staged.append((join(self.base, rel),
                       json.dumps({"entries": entries}).encode()))
        return rel

    def _read_manifest_list(self, path: str) -> list[dict]:
        return json.loads(self.fs.read_bytes(join(self.base, path)))["manifests"]

    # ----------------------------------------------------------------- state
    def current_version(self) -> str:
        _, meta = self._read_metadata()
        return str(meta["current-snapshot-id"])

    def head(self) -> str:
        """The head snapshot id (reads the current metadata JSON)."""
        return self.current_version()

    def head_token(self) -> str:
        """O(1) change-detection probe: an opaque token that moves iff the
        table advanced.  One GET of ``version-hint.text`` — every commit
        (every transaction *flush*, including one that aborts after landing
        a prefix) rewrites the hint right after its last metadata put, so
        the hint number moves with the head and no ``v{N}.metadata.json``
        is parsed.  A writer crashing inside the hint window leaves the
        token lagging until the next successful commit — readers roll the
        hint forward, only change *detection* waits.  Falls back to listing
        the metadata dir when the hint is missing (foreign writer); an
        absent table yields ``""``.

        The token is the *metadata file* version, not the snapshot id: two
        different tokens can name the same snapshot (e.g. a properties-only
        commit), which at worst causes one spurious replan — never a missed
        change.
        """
        return self.head_probe()[0]

    def head_probe(self) -> tuple[str, int | None]:
        """``(head_token, probe_state)`` in ONE storage request (plus the
        listing fallback for hint-less foreign tables).

        The probe state is the metadata-file version the token names, which
        ``replay(probe=...)`` / ``_read_metadata(n)`` can consume within the
        same daemon cycle to open ``v{N}.metadata.json`` directly instead of
        re-running the hint-read + roll-forward discovery dance.
        """
        try:
            n = int(self.fs.read_bytes(self._hint_path()).decode().strip())
            return f"hint:{n}", n
        except FileNotFoundError:
            versions = [int(x[1:-len(".metadata.json")])
                        for x in self.fs.list_dir(join(self.base, META_DIR))
                        if x.startswith("v") and x.endswith(".metadata.json")]
            if not versions:
                return "", None
            return f"list:{max(versions)}", max(versions)

    def versions(self) -> list[str]:
        _, meta = self._read_metadata()
        return [str(s["snapshot-id"]) for s in
                sorted(meta["snapshots"], key=lambda s: s["sequence-number"])]

    def _snapshot_rec(self, meta: dict, snapshot_id: int) -> dict:
        for s in meta["snapshots"]:
            if s["snapshot-id"] == snapshot_id:
                return s
        raise KeyError(f"snapshot {snapshot_id} not found")

    def _live_files(self, meta: dict, snap: dict) -> dict:
        files: dict[str, DataFileMeta] = {}
        manifests = self._read_manifest_list(snap["manifest-list"])
        by_path = self._read_manifests_many(
            [m["manifest-path"] for m in manifests])
        for m in manifests:
            for e in by_path[m["manifest-path"]]:
                if e["status"] != DELETED:
                    f = _file_from_entry(e)
                    files[f.path] = f
        return files

    def snapshot(self, version: str | None = None) -> TableState:
        _, meta = self._read_metadata()
        sid = int(version) if version is not None else meta["current-snapshot-id"]
        schema = self._schema_of(meta, meta["current-schema-id"])
        spec = spec_from_ice(meta["partition-specs"][meta["default-spec-id"]], schema)
        if sid == -1:  # empty table
            return TableState(FORMAT, "-1", meta["last-updated-ms"], schema, spec,
                              {}, dict(meta["properties"]))
        snap = self._snapshot_rec(meta, sid)
        schema = self._schema_of(meta, snap.get("schema-id",
                                                meta["current-schema-id"]))
        return TableState(FORMAT, str(sid), snap["timestamp-ms"], schema, spec,
                          self._live_files(meta, snap), dict(meta["properties"]))

    def _schema_of(self, meta: dict, schema_id: int) -> Schema:
        for s in meta["schemas"]:
            if s.get("schema-id", 0) == schema_id:
                return schema_from_ice(s)
        return schema_from_ice(meta["schemas"][-1])

    def changes(self, version: str) -> tuple[list[DataFileMeta], list[str], str, dict]:
        _, meta = self._read_metadata()
        snap = self._snapshot_rec(meta, int(version))
        adds, removes = [], []
        manifests = self._read_manifest_list(snap["manifest-list"])
        by_path = self._read_manifests_many(
            [m["manifest-path"] for m in manifests])
        for m in manifests:
            for e in by_path[m["manifest-path"]]:
                if e["snapshot-id"] != int(version):
                    continue
                if e["status"] == ADDED:
                    adds.append(_file_from_entry(e))
                elif e["status"] == DELETED:
                    removes.append(e["data-file"]["file-path"])
        return adds, removes, snap["summary"].get("operation", "unknown"), \
            dict(snap["summary"])

    def replay(self, since: str | None = None,
               seed: CommitEntry | None = None,
               probe: int | None = None
               ) -> tuple[TableState | None, list[CommitEntry]]:
        """Single-pass scan of the snapshot chain -> per-commit entries.

        Manifest files are read once each even though manifest *reuse* makes
        them appear in many snapshots' manifest lists, so the whole history
        costs one read per metadata object, not one per (snapshot, manifest).
        The base state is the empty pre-first-snapshot table (version "-1").

        With ``since`` set, only snapshots AFTER that id are scanned
        (tail-only refresh, ``base`` is ``None``); a snapshot's changes live
        exclusively in manifests it added itself (``added-snapshot-id``), so
        the tail never touches carried-forward manifests from older
        snapshots.  Raises ``KeyError`` if ``since`` is not in the chain.

        ``probe`` — the metadata-file version from a same-cycle
        ``head_probe()`` — opens ``v{N}.metadata.json`` directly, skipping
        the hint-read + roll-forward head discovery.
        """
        _, meta = self._read_metadata(probe)
        cur_schema = self._schema_of(meta, meta["current-schema-id"])
        spec = spec_from_ice(meta["partition-specs"][meta["default-spec-id"]],
                             cur_schema)
        props = dict(meta["properties"])
        snaps = sorted(meta["snapshots"], key=lambda s: s["sequence-number"])
        base: TableState | None = TableState(
            FORMAT, "-1", meta["last-updated-ms"], cur_schema, spec, {}, props)
        tail_only = since is not None and since != "-1"
        if tail_only:
            known = {str(s["snapshot-id"]) for s in snaps}
            if since not in known:
                raise KeyError(f"snapshot {since} not in iceberg chain")
            snaps = [s for s in snaps if s["sequence-number"] >
                     next(x["sequence-number"] for x in snaps
                          if str(x["snapshot-id"]) == since)]
            base = None
        elif since is not None:   # since == "-1": tail == whole chain
            base = None

        # two pipelined fetch rounds instead of one RTT per metadata object:
        # all manifest-lists at once, then every unique manifest exactly once
        # (manifest *reuse* makes the same manifest appear in many lists)
        ml_blobs = fetch_many(
            self.fs, [join(self.base, s["manifest-list"]) for s in snaps])
        ml_by_snap = {s["snapshot-id"]: json.loads(raw)["manifests"]
                      for s, raw in zip(snaps, ml_blobs)}
        needed: dict[str, None] = {}
        for snap in snaps:
            sid = snap["snapshot-id"]
            for m in ml_by_snap[sid]:
                # a snapshot's ADDED/DELETED entries only live in manifests
                # written at that snapshot; skip reused ones on tail scans
                if tail_only and m.get("added-snapshot-id") != sid:
                    continue
                needed[m["manifest-path"]] = None
        manifest_memo = self._read_manifests_many(list(needed))

        entries = []
        for snap in snaps:
            sid = snap["snapshot-id"]
            adds, removes = [], []
            for m in ml_by_snap[sid]:
                if tail_only and m.get("added-snapshot-id") != sid:
                    continue
                for e in manifest_memo[m["manifest-path"]]:
                    if e["snapshot-id"] != sid:
                        continue
                    if e["status"] == ADDED:
                        adds.append(_file_from_entry(e))
                    elif e["status"] == DELETED:
                        removes.append(e["data-file"]["file-path"])
            schema = self._schema_of(meta, snap.get("schema-id",
                                                    meta["current-schema-id"]))
            entries.append(CommitEntry(
                str(sid), snap["timestamp-ms"],
                snap["summary"].get("operation", "unknown"), tuple(adds),
                tuple(removes), schema, spec, props, dict(snap["summary"])))
        return base, entries

    def properties(self) -> dict:
        _, meta = self._read_metadata()
        return dict(meta["properties"])

    def current_schema(self) -> Schema:
        """Schema from the metadata JSON alone (no manifest reads)."""
        _, meta = self._read_metadata()
        return self._schema_of(meta, meta["current-schema-id"])

    def read_metadata(self) -> tuple[int, dict]:
        """One read of the current ``(metadata version, metadata dict)`` —
        the public accessor for callers that answer several questions
        (properties, schema, transaction seed) from a single fetch; hand
        the tuple to ``transaction(meta=...)`` to make begin free."""
        return self._read_metadata()

    def schema_from_metadata(self, meta: dict) -> Schema:
        """The current schema carried by an already-read metadata dict."""
        return self._schema_of(meta, meta["current-schema-id"])

    # --------------------------------------------------------------- commits
    def commit(self, adds: list[DataFileMeta] = (), removes: list[str] = (), *,
               schema: Schema | None = None, properties: dict | None = None,
               operation: str = "append", extra_meta: dict | None = None,
               max_retries: int = 5) -> str:
        for _ in range(max_retries):
            try:
                return self._commit_once(adds, removes, schema, properties,
                                         operation, extra_meta)
            except CommitConflict:
                continue
        raise CommitConflict("iceberg commit retries exhausted")

    def _commit_once(self, adds, removes, schema, properties, operation,
                     extra_meta) -> str:
        n, meta = self._read_metadata()
        seq = meta["last-sequence-number"] + 1
        sid = seq  # deterministic, ordered snapshot ids
        ts = _now_ms()
        removes = set(removes)

        # -- carry forward manifests, rewriting only those touching removes;
        #    new manifests + the manifest list are STAGED and flushed in one
        #    pipelined round — only the metadata put below is ordered
        staged: list[tuple[str, bytes]] = []
        manifests: list[dict] = []
        if meta["current-snapshot-id"] != -1:
            parent = self._snapshot_rec(meta, meta["current-snapshot-id"])
            parent_list = self._read_manifest_list(parent["manifest-list"])
            by_path = self._read_manifests_many(
                [m["manifest-path"] for m in parent_list])
            for m in parent_list:
                entries = [e for e in by_path[m["manifest-path"]]
                           if e["status"] != DELETED]
                if removes and any(e["data-file"]["file-path"] in removes
                                   for e in entries):
                    new_entries = []
                    for e in entries:
                        p = e["data-file"]["file-path"]
                        if p in removes:
                            new_entries.append({**e, "status": DELETED,
                                                "snapshot-id": sid})
                        else:
                            new_entries.append({**e, "status": EXISTING})
                    rel = self._stage_manifest(
                        f"manifest-{sid}-rw{len(manifests)}.json", new_entries,
                        staged)
                    manifests.append(_mf_entry(rel, sid, new_entries))
                elif entries:
                    manifests.append({**m, "added-files-count": 0,
                                      "existing-files-count":
                                          m.get("added-files-count", 0) +
                                          m.get("existing-files-count", 0),
                                      "deleted-files-count": 0})
        if adds:
            entries = [_file_to_entry(f, ADDED, sid) for f in adds]
            rel = self._stage_manifest(f"manifest-{sid}-add.json", entries,
                                       staged)
            manifests.append(_mf_entry(rel, sid, entries))

        ml_rel = join(META_DIR, f"snap-{sid}.manifest-list.json")
        staged.append((join(self.base, ml_rel),
                       json.dumps({"manifests": manifests}).encode()))
        flush_many(self.fs, staged)

        summary = {"operation": operation,
                   "added-data-files": str(len(adds)),
                   "deleted-data-files": str(len(removes))}
        if extra_meta:
            summary.update({f"xtable.{k}": json.dumps(v) if not
                            isinstance(v, str) else v
                            for k, v in extra_meta.items()})

        new_meta = dict(meta)
        if schema is not None:
            ice = schema_to_ice(Schema(schema.fields,
                                       meta["current-schema-id"] + 1))
            new_meta["schemas"] = meta["schemas"] + [ice]
            new_meta["current-schema-id"] = ice["schema-id"]
            new_meta["last-column-id"] = max(f["id"] for f in ice["fields"])
        if properties:
            new_meta["properties"] = {**meta["properties"],
                                      **{k: str(v) for k, v in properties.items()}}
        new_meta.update({
            "last-sequence-number": seq, "last-updated-ms": ts,
            "current-snapshot-id": sid,
            "snapshots": meta["snapshots"] + [{
                "snapshot-id": sid,
                "parent-snapshot-id": meta["current-snapshot-id"],
                "sequence-number": seq, "timestamp-ms": ts,
                "manifest-list": ml_rel, "summary": summary,
                "schema-id": new_meta["current-schema-id"]}],
            "snapshot-log": meta["snapshot-log"] + [
                {"timestamp-ms": ts, "snapshot-id": sid}],
        })
        self._write_metadata(n + 1, new_meta)
        return str(sid)

    # ----------------------------------------------------------- transaction
    def transaction(self, *, schema: Schema | None = None,
                    manifest_compaction_threshold: int | None = None,
                    meta: tuple[int, dict] | None = None
                    ) -> "IcebergTransaction":
        """Multi-commit transaction: parse ``v{N}.metadata.json`` ONCE and
        thread the metadata dict + manifest-list through every commit in
        memory.  Commits are *buffered*: every non-commit-point object (new
        manifests, manifest-lists) across the whole chain is staged and
        flushed in one pipelined ``write_many`` round at ``flush()``/
        ``close()``; only the per-commit metadata puts stay serial, so an
        N-commit drain costs ~N+O(1) serial round trips instead of ~4N.
        ``manifest_compaction_threshold`` folds the manifest list into one
        manifest whenever a commit would leave more than that many; ``meta``
        — an already-read ``(version, metadata dict)`` — makes begin cost
        zero requests (a stale caller races like any concurrent writer:
        the conflict surfaces at flush and the chain re-materializes)."""
        return IcebergTransaction(
            self, manifest_compaction_threshold=manifest_compaction_threshold,
            meta=meta)


class IcebergTransaction:
    """Buffered writer state for an N-commit sync unit (single writer).

    Begin cost: one metadata-JSON read; the parent manifest-list is read
    lazily at the first flush.  ``commit()`` only *buffers*: the snapshot id
    is predicted from the in-memory sequence counter (the transaction is the
    single writer; a foreign commit surfaces as a conflict at flush and the
    chain is re-materialized with fresh ids).  ``flush()`` then

    1. materializes every pending commit in memory,
    2. flushes ALL staged non-commit objects — new manifests and
       manifest-lists, uniquely named per snapshot id, hence idempotent —
       in one pipelined ``write_many`` round,
    3. issues the per-commit ``v{N}.metadata.json`` puts serially (the
       ordered atomic commit points), and
    4. moves ``version-hint.text`` once.

    A crash anywhere leaves a valid prefix: staged objects are unreferenced
    until their commit point lands, and every landed commit references only
    already-flushed objects.  A commit with removes must locate the removed
    entries, which opens the live parent manifests — at most ONCE EACH per
    transaction (memoized; staged manifests enter the memo at materialize
    time).  With a ``manifest_compaction_threshold``, a commit that would
    carry more than that many manifests folds them all into one, bounding
    the O(manifests) read amplification of long incremental chains.
    """

    def __init__(self, table: IcebergTable, *,
                 manifest_compaction_threshold: int | None = None,
                 meta: tuple[int, dict] | None = None):
        self.t = table
        self.n, self.meta = meta if meta is not None \
            else table._read_metadata()
        if manifest_compaction_threshold is not None \
                and manifest_compaction_threshold < 1:
            raise ValueError("manifest_compaction_threshold must be >= 1")
        self.compaction_threshold = manifest_compaction_threshold
        self.compactions = 0                         # folds performed
        self._manifests: list[dict] | None = None    # current manifest list
        self._manifest_memo: dict[str, list[dict]] = {}
        self._pending: list[tuple] = []              # buffered commit args
        self._max_retries = 5

    @property
    def version(self) -> str:
        """Head snapshot id including buffered (not yet flushed) commits."""
        if self._pending:
            return str(self.meta["last-sequence-number"] + len(self._pending))
        return str(self.meta["current-snapshot-id"])

    def _read_manifest(self, path: str) -> list[dict]:
        if path not in self._manifest_memo:
            self._manifest_memo[path] = self.t._read_manifest(path)
        return self._manifest_memo[path]

    def _parent_manifests(self) -> list[dict]:
        if self._manifests is None:
            if self.meta["current-snapshot-id"] == -1:
                self._manifests = []
            else:
                parent = self.t._snapshot_rec(self.meta,
                                              self.meta["current-snapshot-id"])
                self._manifests = self.t._read_manifest_list(
                    parent["manifest-list"])
        return self._manifests

    def commit(self, adds: list[DataFileMeta] = (), removes: list[str] = (), *,
               schema: Schema | None = None, properties: dict | None = None,
               operation: str = "append", extra_meta: dict | None = None,
               max_retries: int = 5) -> str:
        """Buffer one commit; it lands at the next ``flush()``/``close()``.
        Returns the predicted snapshot id (exact unless a foreign writer
        races the flush, which re-materializes the chain)."""
        self._max_retries = max(self._max_retries, max_retries)
        self._pending.append((list(adds), list(removes), schema, properties,
                              operation, extra_meta))
        return str(self.meta["last-sequence-number"] + len(self._pending))

    # ---------------------------------------------------------------- flush
    def flush(self) -> None:
        """Land every buffered commit (see class docstring for the order)."""
        if not self._pending:
            return
        landed = False
        try:
            for _ in range(self._max_retries):
                staged, commits = self._materialize()
                applied = 0
                try:
                    flush_many(self.t.fs, staged)
                    for path, payload, n1, new_meta, new_manifests in commits:
                        self.t.fs.write_bytes(path, payload)
                        applied += 1
                        landed = True
                        self.n, self.meta = n1, new_meta
                        self._manifests = new_manifests
                except PutIfAbsentError:
                    # a concurrent writer advanced the table (a stale
                    # snapshot id collides at a staged name or at the
                    # metadata put): keep the prefix that landed, re-read,
                    # and re-materialize the remaining commits with fresh
                    # sequence numbers
                    del self._pending[:applied]
                    self.n, self.meta = self.t._read_metadata()
                    self._manifests = None
                    continue
                del self._pending[:applied]
                break
            else:
                raise CommitConflict(
                    "iceberg transactional commit retries exhausted")
        except BaseException:
            if landed:
                # commits DID land before the failure: still move the
                # advisory hint over them so ``head_token`` keeps tracking
                # the head (a change-detection probe must not miss the
                # landed prefix); a secondary hint failure must not mask
                # the original error
                try:
                    self.t.fs.write_bytes(self.t._hint_path(),
                                          str(self.n).encode(),
                                          overwrite=True)
                except Exception:
                    pass
            raise
        # move the hint ONCE per flush, after the last commit point — it is
        # advisory (readers roll forward), so deferring it drops N-1 serial
        # round trips from an N-commit drain
        self.t.fs.write_bytes(self.t._hint_path(), str(self.n).encode(),
                              overwrite=True)

    def _materialize(self) -> tuple[list, list]:
        """Pending commits -> (staged objects, ordered commit-point puts).

        Pure in-memory except for reads: the parent manifest list (lazy,
        once) and — only for commits with removes or a compaction fold —
        the not-yet-memoized live manifests, fetched in one batched round.
        """
        staged: list[tuple[str, bytes]] = []
        commits: list[tuple] = []
        meta, n = self.meta, self.n
        manifests = list(self._parent_manifests())
        # staged names carry a writer-unique token (the way real Iceberg
        # embeds a UUID in manifest names): a crashed writer's orphans and
        # a racing writer's staged objects can never collide with ours, so
        # staged puts are conflict-free and only the metadata put races
        self._tok = uuid.uuid4().hex[:8]
        for adds, removes, schema, properties, operation, extra_meta \
                in self._pending:
            meta, manifests = self._materialize_one(
                meta, manifests, adds, removes, schema, properties,
                operation, extra_meta, staged)
            n += 1
            commits.append((self.t._meta_path(n), json.dumps(meta).encode(),
                            n, meta, manifests))
        return staged, commits

    def _ensure_memo(self, manifests: list[dict]) -> None:
        """Batch-open every live, not-yet-memoized manifest of ``manifests``."""
        missing = [m["manifest-path"] for m in manifests
                   if (m.get("added-files-count", 0) +
                       m.get("existing-files-count", 0))
                   and m["manifest-path"] not in self._manifest_memo]
        self._manifest_memo.update(self.t._read_manifests_many(missing))

    def _materialize_one(self, meta, parent_manifests, adds, removes, schema,
                         properties, operation, extra_meta,
                         staged) -> tuple[dict, list[dict]]:
        seq = meta["last-sequence-number"] + 1
        sid = seq
        ts = _now_ms()
        removes = set(removes)

        # -- carry forward the in-memory manifest list; only manifests that
        #    contain a removed path are opened (memoized) and rewritten
        if removes:
            self._ensure_memo(parent_manifests)
        manifests: list[dict] = []
        for m in parent_manifests:
            live = (m.get("added-files-count", 0) +
                    m.get("existing-files-count", 0))
            if not live:
                continue
            if removes:
                entries = [e for e in self._read_manifest(m["manifest-path"])
                           if e["status"] != DELETED]
                if any(e["data-file"]["file-path"] in removes
                       for e in entries):
                    new_entries = []
                    for e in entries:
                        if e["data-file"]["file-path"] in removes:
                            new_entries.append({**e, "status": DELETED,
                                                "snapshot-id": sid})
                        else:
                            new_entries.append({**e, "status": EXISTING})
                    rel = self._stage(
                        f"manifest-{sid}-rw{len(manifests)}.{self._tok}.json",
                        new_entries, staged)
                    manifests.append(_mf_entry(rel, sid, new_entries))
                    continue
            manifests.append({**m, "added-files-count": 0,
                              "existing-files-count": live,
                              "deleted-files-count": 0})
        if adds:
            entries = [_file_to_entry(f, ADDED, sid) for f in adds]
            rel = self._stage(f"manifest-{sid}-add.{self._tok}.json",
                              entries, staged)
            manifests.append(_mf_entry(rel, sid, entries))

        if self.compaction_threshold is not None \
                and len(manifests) > self.compaction_threshold:
            manifests = [self._compact(manifests, sid, staged)]
            self.compactions += 1

        ml_rel = join(META_DIR,
                      f"snap-{sid}.{self._tok}.manifest-list.json")
        staged.append((join(self.t.base, ml_rel),
                       json.dumps({"manifests": manifests}).encode()))

        summary = {"operation": operation,
                   "added-data-files": str(len(adds)),
                   "deleted-data-files": str(len(removes))}
        if extra_meta:
            summary.update({f"xtable.{k}": json.dumps(v) if not
                            isinstance(v, str) else v
                            for k, v in extra_meta.items()})

        new_meta = dict(meta)
        if schema is not None:
            ice = schema_to_ice(Schema(schema.fields,
                                       meta["current-schema-id"] + 1))
            new_meta["schemas"] = meta["schemas"] + [ice]
            new_meta["current-schema-id"] = ice["schema-id"]
            new_meta["last-column-id"] = max(f["id"] for f in ice["fields"])
        if properties:
            new_meta["properties"] = {**meta["properties"],
                                      **{k: str(v) for k, v in
                                         properties.items()}}
        new_meta.update({
            "last-sequence-number": seq, "last-updated-ms": ts,
            "current-snapshot-id": sid,
            "snapshots": meta["snapshots"] + [{
                "snapshot-id": sid,
                "parent-snapshot-id": meta["current-snapshot-id"],
                "sequence-number": seq, "timestamp-ms": ts,
                "manifest-list": ml_rel, "summary": summary,
                "schema-id": new_meta["current-schema-id"]}],
            "snapshot-log": meta["snapshot-log"] + [
                {"timestamp-ms": ts, "snapshot-id": sid}],
        })
        return new_meta, manifests

    def _stage(self, name: str, entries: list[dict], staged: list) -> str:
        rel = self.t._stage_manifest(name, entries, staged)
        self._manifest_memo[rel] = entries
        return rel

    def _compact(self, manifests: list[dict], sid: int,
                 staged: list) -> dict:
        """Fold the whole manifest list into ONE staged manifest.

        Long incremental chains grow one small manifest per commit; folding
        at the threshold bounds snapshot-read amplification.  Entries of the
        current snapshot keep their ADDED/DELETED status (so ``changes()``
        and tail replays still see this commit's delta); older entries
        become EXISTING with their original snapshot-id, and historical
        tombstones are dropped (older snapshots read their own, untouched
        manifest lists).
        """
        self._ensure_memo(manifests)
        folded: list[dict] = []
        for m in manifests:
            if not (m.get("added-files-count", 0) +
                    m.get("existing-files-count", 0) +
                    m.get("deleted-files-count", 0)):
                continue
            for e in self._read_manifest(m["manifest-path"]):
                if e["snapshot-id"] == sid:
                    folded.append(e)             # this commit's own delta
                elif e["status"] != DELETED:
                    folded.append({**e, "status": EXISTING})
        rel = self._stage(f"manifest-{sid}-compact.{self._tok}.json",
                          folded, staged)
        return _mf_entry(rel, sid, folded)

    def close(self) -> None:
        self.flush()


def _mf_entry(rel: str, sid: int, entries: list[dict]) -> dict:
    return {"manifest-path": rel, "added-snapshot-id": sid,
            "added-files-count": sum(1 for e in entries if e["status"] == ADDED),
            "existing-files-count": sum(1 for e in entries
                                        if e["status"] == EXISTING),
            "deleted-files-count": sum(1 for e in entries
                                       if e["status"] == DELETED)}


def _now_ms() -> int:
    return time.time_ns() // 1_000_000
