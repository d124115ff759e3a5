# Copy of repro/lst/delta.py; the port imports nothing of repro.
"""Delta-Lake-style LST: an ordered JSON action log under ``_delta_log/``.

Faithful architectural reimplementation of the Delta transaction-log protocol:

* ``_delta_log/{version:020d}.json`` — newline-delimited JSON *actions*
  (``protocol``, ``metaData``, ``add``, ``remove``, ``commitInfo``).
* Version = the integer in the file name; commit = put-if-absent of the next
  version file (optimistic concurrency, exactly Delta's protocol on object
  stores with conditional writes).
* Checkpoints: every ``delta.checkpointInterval`` commits an aggregated
  ``{version:020d}.checkpoint.json`` plus a ``_last_checkpoint`` pointer, so
  state reconstruction replays O(interval) log files, not O(history).
* Per-file statistics ride in ``add.stats`` as a JSON string
  (``numRecords/minValues/maxValues/nullCount``) — Delta's layout.
"""

from __future__ import annotations

import json
import time

from repro_torch.lst.chunkfile import ColumnStats, DataFileMeta
from repro_torch.lst.storage import PutIfAbsentError, fetch_many, join
from repro_torch.lst.schema import (CommitEntry, Field, PartitionSpec, Schema,
                              TableState)

FORMAT = "delta"
LOG_DIR = "_delta_log"
CHECKPOINT_INTERVAL_KEY = "delta.checkpointInterval"
DEFAULT_CHECKPOINT_INTERVAL = 10

_TYPES_TO_DELTA = {"int32": "integer", "int64": "long", "float32": "float",
                   "float64": "double", "string": "string", "bool": "boolean",
                   "binary": "binary", "timestamp": "timestamp"}
_DELTA_TO_TYPES = {v: k for k, v in _TYPES_TO_DELTA.items()}


def schema_to_delta(schema: Schema) -> str:
    return json.dumps({"type": "struct", "fields": [
        {"name": f.name, "type": _TYPES_TO_DELTA[f.type], "nullable": f.nullable,
         "metadata": ({"delta.columnMapping.id": f.field_id}
                      if f.field_id is not None else {})}
        for f in schema.fields]})


def schema_from_delta(s: str, schema_id: int = 0) -> Schema:
    d = json.loads(s)
    return Schema([Field(f["name"], _DELTA_TO_TYPES[f["type"]], f["nullable"],
                         f.get("metadata", {}).get("delta.columnMapping.id"))
                   for f in d["fields"]], schema_id)


def _stats_to_delta(column_stats: dict) -> str:
    num = max((s.count for s in column_stats.values()), default=0)
    return json.dumps({
        "numRecords": num,
        "minValues": {k: s.min for k, s in column_stats.items() if s.min is not None},
        "maxValues": {k: s.max for k, s in column_stats.items() if s.max is not None},
        "nullCount": {k: s.nan_count for k, s in column_stats.items()},
    })


def _stats_from_delta(s: str | None) -> dict:
    if not s:
        return {}
    d = json.loads(s)
    cols = set(d.get("minValues", {})) | set(d.get("maxValues", {})) | \
        set(d.get("nullCount", {}))
    return {c: ColumnStats(d.get("minValues", {}).get(c),
                           d.get("maxValues", {}).get(c),
                           d.get("numRecords", 0),
                           d.get("nullCount", {}).get(c, 0)) for c in cols}


def _add_action(f: DataFileMeta, ts: int) -> dict:
    return {"add": {"path": f.path, "partitionValues": {k: str(v) for k, v in
                                                        f.partition_values.items()},
                    "size": f.size_bytes, "modificationTime": ts, "dataChange": True,
                    "stats": _stats_to_delta(f.column_stats),
                    "tags": f.extra or {}}}


def _file_from_add(a: dict) -> DataFileMeta:
    st = _stats_from_delta(a.get("stats"))
    num = json.loads(a["stats"])["numRecords"] if a.get("stats") else 0
    return DataFileMeta(path=a["path"], size_bytes=a["size"], record_count=num,
                        partition_values=dict(a.get("partitionValues", {})),
                        column_stats=st, extra=dict(a.get("tags", {})))


class DeltaTable:
    format = FORMAT

    def __init__(self, fs, base_path: str):
        self.fs = fs
        self.base = base_path

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def exists(cls, fs, base_path: str) -> bool:
        return bool(fs.list_dir(join(base_path, LOG_DIR)))

    @classmethod
    def create(cls, fs, base_path: str, schema: Schema,
               partition_spec: PartitionSpec = PartitionSpec(),
               properties: dict | None = None) -> "DeltaTable":
        t = cls(fs, base_path)
        ts = _now_ms()
        actions = [
            {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
            _metadata_action(schema, partition_spec, properties or {}, ts),
            {"commitInfo": {"timestamp": ts, "operation": "CREATE TABLE",
                            "operationParameters": {}}},
        ]
        t._write_commit(0, actions)
        return t

    @classmethod
    def open(cls, fs, base_path: str) -> "DeltaTable":
        if not cls.exists(fs, base_path):
            raise FileNotFoundError(f"no delta table at {base_path}")
        return cls(fs, base_path)

    # ------------------------------------------------------------------ log
    def _log_path(self, version: int, checkpoint: bool = False) -> str:
        suffix = ".checkpoint.json" if checkpoint else ".json"
        return join(self.base, LOG_DIR, f"{version:020d}{suffix}")

    def _list_versions(self) -> list[int]:
        names = self.fs.list_dir(join(self.base, LOG_DIR))
        return sorted(int(n[:20]) for n in names
                      if n.endswith(".json") and not n.endswith(".checkpoint.json")
                      and n[:20].isdigit())

    def _read_actions(self, version: int) -> list[dict]:
        raw = self.fs.read_bytes(self._log_path(version)).decode()
        return [json.loads(line) for line in raw.splitlines() if line.strip()]

    def _read_actions_many(self, versions: list[int]) -> dict[int, list[dict]]:
        """Batched fetch of many log segments: the independent GETs go
        through ``read_many`` so a replay over a high-RTT object store is
        pipelined instead of one round trip per commit file."""
        blobs = fetch_many(self.fs, [self._log_path(v) for v in versions])
        return {v: [json.loads(line) for line in raw.decode().splitlines()
                    if line.strip()]
                for v, raw in zip(versions, blobs)}

    def _last_checkpoint(self) -> int | None:
        p = join(self.base, LOG_DIR, "_last_checkpoint")
        if not self.fs.exists(p):
            return None
        return json.loads(self.fs.read_bytes(p))["version"]

    def _write_commit(self, version: int, actions: list[dict]) -> None:
        payload = "\n".join(json.dumps(a) for a in actions).encode()
        try:
            self.fs.write_bytes(self._log_path(version), payload)
        except PutIfAbsentError as e:
            raise CommitConflict(f"delta version {version} already committed") from e

    # ----------------------------------------------------------------- state
    def current_version(self) -> str:
        vs = self._list_versions()
        if not vs:
            raise FileNotFoundError("empty delta log")
        return str(vs[-1])

    def head(self) -> str:
        """The head commit id — one log-tail listing, no action reads."""
        return self.current_version()

    def head_token(self) -> str:
        """O(1) change-detection probe: an opaque token that moves iff the
        table head moved.  One ``list_dir`` of ``_delta_log/`` — no log
        replay, no action reads — so an always-on watcher polling every
        table each cycle pays exactly one storage request per quiet table.
        An absent/empty log yields ``""`` (the "no table yet" token).
        """
        return self.head_probe()[0]

    def head_probe(self) -> tuple[str, int | None]:
        """``(head_token, probe_state)`` in ONE storage request.

        The probe state (the head version number) can be handed back to
        ``replay(probe=...)`` within the same daemon cycle so the tail
        refresh constructs the new log-segment names directly — delta
        versions are dense integers — instead of re-listing the log.
        """
        vs = self._list_versions()
        return (str(vs[-1]), vs[-1]) if vs else ("", None)

    def versions(self) -> list[str]:
        return [str(v) for v in self._list_versions()]

    def snapshot(self, version: str | None = None) -> TableState:
        versions = self._list_versions()
        if version is None and not versions:
            raise FileNotFoundError("empty delta log")
        target = int(version) if version is not None else versions[-1]
        files: dict[str, DataFileMeta] = {}
        schema, pspec, props, ts = None, PartitionSpec(), {}, 0
        start = 0
        cp = self._last_checkpoint()
        if cp is not None and cp <= target:
            for a in self._read_checkpoint(cp):
                schema, pspec, props, files, ts = _apply(a, schema, pspec, props,
                                                         files, ts)
            start = cp + 1
        live = [v for v in versions if start <= v <= target]
        actions_by_v = self._read_actions_many(live)
        for v in live:
            for a in actions_by_v[v]:
                schema, pspec, props, files, ts = _apply(a, schema, pspec, props,
                                                         files, ts)
        if schema is None:
            raise ValueError(f"no metaData action found up to version {target}")
        return TableState(FORMAT, str(target), ts, schema, pspec, files, props)

    def tail_state(self) -> tuple[str, Schema, PartitionSpec, dict]:
        """(head version, schema, partition spec, configuration) from the log
        *tail*: scan backwards until a ``metaData`` action, falling back to
        the checkpoint.  A sync-maintained target writes a metaData action on
        every commit (the sync token lives in the configuration), so this is
        one read regardless of history length — the O(1) way to answer "where
        is this target?" without replaying the log.
        """
        versions = self._list_versions()
        if not versions:
            raise FileNotFoundError("empty delta log")
        head = str(versions[-1])
        cp = self._last_checkpoint()
        for v in reversed(versions):
            if cp is not None and v <= cp:
                break
            for a in reversed(self._read_actions(v)):
                if "metaData" in a:
                    return (head, *_unpack_metadata(a["metaData"]))
        if cp is not None:
            for a in self._read_checkpoint(cp):
                if "metaData" in a:
                    return (head, *_unpack_metadata(a["metaData"]))
        raise ValueError("no metaData action in delta log")

    def changes(self, version: str) -> tuple[list[DataFileMeta], list[str], str, dict]:
        """(adds, removed paths, operation, commit-info) for one commit."""
        adds, removes, op, info = [], [], "unknown", {}
        for a in self._read_actions(int(version)):
            if "add" in a:
                adds.append(_file_from_add(a["add"]))
            elif "remove" in a:
                removes.append(a["remove"]["path"])
            elif "commitInfo" in a:
                op = a["commitInfo"].get("operation", "unknown")
                info = a["commitInfo"]
        return adds, removes, op, info

    def replay(self, since: str | None = None,
               seed: CommitEntry | None = None,
               probe: int | None = None
               ) -> tuple[TableState | None, list[CommitEntry]]:
        """Single-pass scan of the log -> per-commit entries.

        Returns ``(base, entries)``.  ``entries`` is one ``CommitEntry`` per
        surviving log version, in order; folding their adds/removes on top of
        ``base`` reproduces ``snapshot(v)`` for any listed version.  ``base``
        is ``None`` in the normal case (fold from the empty table); it is the
        checkpoint state when early log files were vacuumed behind a
        checkpoint and per-commit history below it no longer exists.

        With ``since`` set, only commits strictly AFTER that version are
        scanned (tail-only refresh); ``base`` is then always ``None``.
        ``seed`` (the caller's ``CommitEntry`` for ``since``) supplies the
        as-of schema/spec/properties so the tail costs O(new commits) reads;
        without it the metaData is recovered from the tail/checkpoint scan.
        Raises ``KeyError`` if ``since`` is no longer in the log (vacuumed) —
        callers fall back to a full replay.

        ``probe`` — the head version from a same-cycle ``head_probe()`` —
        lets a seeded tail replay skip the log listing entirely: delta
        versions are dense integers, so the segment names for
        ``since+1 .. probe`` are constructed directly (a vacuumed segment
        surfaces as ``FileNotFoundError`` and callers rebuild).
        """
        schema, pspec, props, ts = None, PartitionSpec(), {}, 0
        base = None
        start_after = -1
        if since is not None and seed is not None and probe is not None:
            # probe-assisted tail: zero head-discovery requests
            sv = int(since)
            if int(probe) < sv:
                # the head moved BEHIND the anchor (restore / divergent
                # rewrite): an empty constructed range would silently hide
                # it — surface it like the unhinted membership check does
                raise KeyError(f"head {probe} behind anchor {since} "
                               f"(divergent rewrite)")
            schema, pspec, props = (seed.schema, seed.partition_spec,
                                    dict(seed.properties))
            ts = seed.timestamp_ms
            tail = list(range(sv + 1, int(probe) + 1))
            actions_by_v = self._read_actions_many(tail)
            entries = []
            for v in tail:
                schema, pspec, props, ts, e = self._entry_of(
                    v, actions_by_v[v], schema, pspec, props, ts)
                entries.append(e)
            return None, entries
        versions = self._list_versions()
        cp = self._last_checkpoint()
        if since is not None:
            sv = int(since)
            if sv not in versions and (cp is None or sv != cp):
                raise KeyError(f"version {since} not in delta log")
            if seed is not None:
                schema, pspec, props = (seed.schema, seed.partition_spec,
                                        dict(seed.properties))
                ts = seed.timestamp_ms
            elif cp is not None and sv == cp:
                # resuming right at the checkpoint base: its metaData seeds
                for a in self._read_checkpoint(cp):
                    if "metaData" in a:
                        schema, pspec, props = _unpack_metadata(a["metaData"])
            else:
                raise KeyError(f"no seed state for version {since}")
            tail = [v for v in versions if v > sv]
            actions_by_v = self._read_actions_many(tail)
            entries = []
            for v in tail:
                schema, pspec, props, ts, e = self._entry_of(
                    v, actions_by_v[v], schema, pspec, props, ts)
                entries.append(e)
            return None, entries
        if cp is not None and (not versions or versions[0] > 0):
            files: dict[str, DataFileMeta] = {}
            for a in self._read_checkpoint(cp):
                schema, pspec, props, files, ts = _apply(a, schema, pspec,
                                                         props, files, ts)
            base = TableState(FORMAT, str(cp), ts, schema, pspec, files, props)
            start_after = cp
        scan = [v for v in versions if v > start_after]
        actions_by_v = self._read_actions_many(scan)
        entries = []
        for v in scan:
            schema, pspec, props, ts, e = self._entry_of(
                v, actions_by_v[v], schema, pspec, props, ts)
            entries.append(e)
        return base, entries

    def _entry_of(self, v: int, actions: list[dict], schema, pspec, props, ts):
        """Fold one log file's (prefetched) actions -> updated running state
        + its CommitEntry."""
        adds, removes, op, info = [], [], "unknown", {}
        for a in actions:
            if "metaData" in a:
                schema, pspec, props = _unpack_metadata(a["metaData"])
            elif "add" in a:
                adds.append(_file_from_add(a["add"]))
                ts = max(ts, a["add"].get("modificationTime", 0))
            elif "remove" in a:
                removes.append(a["remove"]["path"])
                ts = max(ts, a["remove"].get("deletionTimestamp", 0))
            elif "commitInfo" in a:
                op = a["commitInfo"].get("operation", "unknown")
                info = a["commitInfo"]
                ts = max(ts, a["commitInfo"].get("timestamp", 0))
        return schema, pspec, props, ts, CommitEntry(
            str(v), ts, op, tuple(adds), tuple(removes), schema, pspec,
            dict(props), info)

    def properties(self) -> dict:
        return self.snapshot().properties

    # --------------------------------------------------------------- commits
    def commit(self, adds: list[DataFileMeta] = (), removes: list[str] = (), *,
               schema: Schema | None = None, properties: dict | None = None,
               operation: str = "WRITE", extra_meta: dict | None = None,
               max_retries: int = 5) -> str:
        for _ in range(max_retries):
            try:
                return self._commit_once(adds, removes, schema, properties,
                                         operation, extra_meta)
            except CommitConflict:
                continue
        raise CommitConflict("delta commit retries exhausted")

    def _commit_once(self, adds, removes, schema, properties, operation,
                     extra_meta) -> str:
        cur = self.snapshot()
        version = int(cur.version) + 1
        ts = _now_ms()
        actions: list[dict] = []
        if schema is not None or properties:
            new_schema = schema or cur.schema
            props = dict(cur.properties)
            props.update(properties or {})
            actions.append(_metadata_action(new_schema, cur.partition_spec, props, ts))
        for p in removes:
            actions.append({"remove": {"path": p, "deletionTimestamp": ts,
                                       "dataChange": True}})
        for f in adds:
            actions.append(_add_action(f, ts))
        ci = {"timestamp": ts, "operation": operation, "operationParameters": {}}
        if extra_meta:
            ci["xtable"] = extra_meta
        actions.append({"commitInfo": ci})
        self._write_commit(version, actions)
        self._maybe_checkpoint(version)
        return str(version)

    # ------------------------------------------------------------ checkpoint
    def _checkpoint_interval(self) -> int:
        try:
            return int(self.snapshot().properties.get(
                CHECKPOINT_INTERVAL_KEY, DEFAULT_CHECKPOINT_INTERVAL))
        except Exception:
            return DEFAULT_CHECKPOINT_INTERVAL

    def _maybe_checkpoint(self, version: int) -> None:
        if version == 0 or version % self._checkpoint_interval():
            return
        st = self.snapshot(str(version))
        actions = [{"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
                   _metadata_action(st.schema, st.partition_spec, st.properties,
                                    st.timestamp_ms)]
        actions += [_add_action(f, st.timestamp_ms) for f in st.files.values()]
        try:
            self.fs.write_bytes(self._log_path(version, checkpoint=True),
                                "\n".join(json.dumps(a) for a in actions).encode())
        except PutIfAbsentError:
            return  # concurrent checkpointer won; fine
        self.fs.write_bytes(join(self.base, LOG_DIR, "_last_checkpoint"),
                            json.dumps({"version": version}).encode(),
                            overwrite=True)

    def _read_checkpoint(self, version: int) -> list[dict]:
        raw = self.fs.read_bytes(self._log_path(version, checkpoint=True)).decode()
        return [json.loads(line) for line in raw.splitlines() if line.strip()]

    # ----------------------------------------------------------- transaction
    def transaction(self, *, schema: Schema | None = None) -> "DeltaTransaction":
        """Multi-commit transaction: read the log tail ONCE, then thread the
        (version counter, schema, spec, configuration) through every commit
        in memory — each flush is one put-if-absent log write with zero
        re-reads, instead of the full-snapshot-per-commit of ``commit()``."""
        return DeltaTransaction(self, schema=schema)


class DeltaTransaction:
    """Buffered writer state for an N-commit sync unit (single writer).

    Begin cost: one ``list_dir`` + the tail metaData read.  Per commit: one
    put-if-absent write, no reads.  The file list is only materialized if a
    checkpoint boundary is crossed (bounded by the checkpoint interval, not
    the table history), then kept up to date in memory.
    """

    def __init__(self, table: DeltaTable, *, schema: Schema | None = None):
        self.t = table
        head, tail_schema, pspec, props = table.tail_state()
        self._version = int(head)
        self._schema = schema or tail_schema
        self._pspec = pspec
        self._props = props
        self._files: dict[str, DataFileMeta] | None = None   # lazy (checkpoint)

    @property
    def version(self) -> str:
        return str(self._version)

    def commit(self, adds: list[DataFileMeta] = (), removes: list[str] = (), *,
               schema: Schema | None = None, properties: dict | None = None,
               operation: str = "WRITE", extra_meta: dict | None = None,
               max_retries: int = 5) -> str:
        for _ in range(max_retries):
            version = self._version + 1
            ts = _now_ms()
            new_schema = schema or self._schema
            new_props = dict(self._props)
            new_props.update({k: str(v) for k, v in (properties or {}).items()})
            actions: list[dict] = []
            if schema is not None or properties:
                actions.append(_metadata_action(new_schema, self._pspec,
                                                new_props, ts))
            for p in removes:
                actions.append({"remove": {"path": p, "deletionTimestamp": ts,
                                           "dataChange": True}})
            for f in adds:
                actions.append(_add_action(f, ts))
            ci = {"timestamp": ts, "operation": operation,
                  "operationParameters": {}}
            if extra_meta:
                ci["xtable"] = extra_meta
            actions.append({"commitInfo": ci})
            try:
                self.t._write_commit(version, actions)
            except CommitConflict:
                # a concurrent writer took this version: re-sync the counter
                # and config from the tail and try the next slot
                head, self._schema, self._pspec, self._props = \
                    self.t.tail_state()
                self._version = int(head)
                self._files = None
                continue
            self._version = version
            self._schema = new_schema
            self._props = new_props
            if self._files is not None:
                for p in removes:
                    self._files.pop(p, None)
                for f in adds:
                    self._files[f.path] = f
            self._maybe_checkpoint(version, ts)
            return str(version)
        raise CommitConflict("delta transactional commit retries exhausted")

    def _maybe_checkpoint(self, version: int, ts: int) -> None:
        try:
            interval = int(self._props.get(CHECKPOINT_INTERVAL_KEY,
                                           DEFAULT_CHECKPOINT_INTERVAL))
        except (TypeError, ValueError):
            interval = DEFAULT_CHECKPOINT_INTERVAL
        if version == 0 or version % interval:
            return
        if self._files is None:   # one bounded read-back, then tracked
            self._files = dict(self.t.snapshot(str(version)).files)
        actions = [{"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
                   _metadata_action(self._schema, self._pspec, self._props, ts)]
        actions += [_add_action(f, ts) for f in self._files.values()]
        try:
            self.t.fs.write_bytes(
                self.t._log_path(version, checkpoint=True),
                "\n".join(json.dumps(a) for a in actions).encode())
        except PutIfAbsentError:
            return  # concurrent checkpointer won; fine
        self.t.fs.write_bytes(join(self.t.base, LOG_DIR, "_last_checkpoint"),
                              json.dumps({"version": version}).encode(),
                              overwrite=True)

    def close(self) -> None:
        pass


class CommitConflict(RuntimeError):
    pass


def _unpack_metadata(m: dict) -> tuple[Schema, PartitionSpec, dict]:
    return (schema_from_delta(m["schemaString"]),
            PartitionSpec(m.get("partitionColumns", [])),
            dict(m.get("configuration", {})))


def _metadata_action(schema: Schema, pspec: PartitionSpec, props: dict,
                     ts: int) -> dict:
    return {"metaData": {
        "id": props.get("delta.tableId", "tbl"),
        "format": {"provider": "chunkfile", "options": {}},
        "schemaString": schema_to_delta(schema),
        "partitionColumns": pspec.column_names(),
        "configuration": {k: str(v) for k, v in props.items()},
        "createdTime": ts}}


def _apply(action: dict, schema, pspec, props, files, ts):
    if "metaData" in action:
        m = action["metaData"]
        schema = schema_from_delta(m["schemaString"])
        pspec = PartitionSpec(m.get("partitionColumns", []))
        props = dict(m.get("configuration", {}))
    elif "add" in action:
        f = _file_from_add(action["add"])
        files[f.path] = f
        ts = max(ts, action["add"].get("modificationTime", 0))
    elif "remove" in action:
        files.pop(action["remove"]["path"], None)
        ts = max(ts, action["remove"].get("deletionTimestamp", 0))
    elif "commitInfo" in action:
        ts = max(ts, action["commitInfo"].get("timestamp", 0))
    return schema, pspec, props, files, ts


def _now_ms() -> int:
    return time.time_ns() // 1_000_000
