# Copy of repro/lst/hudi.py; the port imports nothing of repro.
"""Hudi-style LST: a timeline of instants under ``.hoodie/``.

Faithful architectural reimplementation of the Hudi (copy-on-write) timeline:

* ``.hoodie/hoodie.properties`` — table name/type/version, create schema
  (Avro record JSON), partition fields.
* Timeline instants ``.hoodie/{ts}.{action}`` with the three-phase state
  machine ``{ts}.{action}.requested`` -> ``{ts}.{action}.inflight`` ->
  ``{ts}.{action}`` (completed). Only the *completed* file makes the commit
  visible — put-if-absent of the completed instant is the atomic commit point.
* Actions: ``commit`` (insert/upsert) and ``replacecommit`` (COW delete /
  clustering), with ``partitionToWriteStats`` (per-file write statistics) and
  ``partitionToReplacedFilePaths`` payloads, schema + arbitrary key/values in
  ``extraMetadata`` (where XTable's real Hudi target stores its sync state).
* Data files are named ``{fileId}_{instant}.chunk`` inside partition dirs —
  Hudi's file-group/file-slice naming.
"""

from __future__ import annotations

import json
import threading
import time

from repro_torch.lst.chunkfile import ColumnStats, DataFileMeta
from repro_torch.lst.storage import PutIfAbsentError, fetch_many, flush_many, join
from repro_torch.lst.schema import (CommitEntry, Field, PartitionSpec, Schema,
                              TableState)

FORMAT = "hudi"
HOODIE_DIR = ".hoodie"

_TYPES_TO_AVRO = {"int32": "int", "int64": "long", "float32": "float",
                  "float64": "double", "string": "string", "bool": "boolean",
                  "binary": "bytes",
                  "timestamp": {"type": "long", "logicalType": "timestamp-micros"}}


def schema_to_avro(schema: Schema, name: str = "record") -> str:
    fields = []
    for f in schema.fields:
        t = _TYPES_TO_AVRO[f.type]
        fields.append({"name": f.name, "type": ["null", t] if f.nullable else t})
    return json.dumps({"type": "record", "name": name, "fields": fields})


def schema_from_avro(s: str) -> Schema:
    d = json.loads(s)
    rev = {}
    for k, v in _TYPES_TO_AVRO.items():
        rev[json.dumps(v, sort_keys=True)] = k
    out = []
    for f in d["fields"]:
        t = f["type"]
        nullable = isinstance(t, list) and "null" in t
        if nullable:
            t = [x for x in t if x != "null"][0]
        out.append(Field(f["name"], rev[json.dumps(t, sort_keys=True)], nullable))
    return Schema(out)


# -- extraMetadata value codec ---------------------------------------------
# Every non-reserved value in a completed instant's ``extraMetadata`` is
# JSON-encoded on write and JSON-decoded on read, by this one pair — the
# commit path and every reader share it, so there is no "does it look
# quoted?" guessing (a string value that happens to start with '"' round-
# trips exactly).  ``schema`` is reserved: it is already an Avro JSON
# document and is stored/consumed verbatim by ``snapshot``/``replay``.
_EM_RAW_KEYS = frozenset({"schema"})


def encode_extra_metadata(extra: dict) -> dict:
    return {k: v if k in _EM_RAW_KEYS else json.dumps(v)
            for k, v in extra.items()}


def decode_extra_metadata(extra: dict) -> dict:
    out = {}
    for k, v in extra.items():
        if k in _EM_RAW_KEYS:
            out[k] = v
            continue
        try:
            out[k] = json.loads(v)
        except (TypeError, ValueError):
            # foreign writer storing a raw non-JSON string; NOTE a raw
            # string that parses as a JSON scalar ("7", "true") is
            # indistinguishable from the codec's encoding of that scalar —
            # consumers needing a string must coerce (see targets.py)
            out[k] = v
    return out


_instant_lock = threading.Lock()
_last_instant = [0]


def new_instant() -> str:
    """Monotonic Hudi-style instant timestamp (yyyyMMddHHmmssSSS-like)."""
    with _instant_lock:
        t = time.time_ns() // 1_000_000
        if t <= _last_instant[0]:
            t = _last_instant[0] + 1
        _last_instant[0] = t
        return time.strftime("%Y%m%d%H%M%S", time.gmtime(t / 1000)) + f"{t % 1000:03d}"


def _stat_entry(f: DataFileMeta) -> dict:
    return {"path": f.path, "fileId": f.extra.get("fileId", f.path.split("/")[-1]
                                                  .split("_")[0]),
            "numWrites": f.record_count, "fileSizeInBytes": f.size_bytes,
            "partitionPath": "/".join(f"{k}={v}" for k, v in
                                      f.partition_values.items()),
            "partitionValues": {k: v for k, v in f.partition_values.items()},
            "minValues": {k: s.min for k, s in f.column_stats.items()},
            "maxValues": {k: s.max for k, s in f.column_stats.items()},
            "nullCounts": {k: s.nan_count for k, s in f.column_stats.items()},
            "valueCounts": {k: s.count for k, s in f.column_stats.items()},
            "tags": f.extra or {}}


def _file_from_stat(w: dict) -> DataFileMeta:
    cols = set(w.get("minValues", {})) | set(w.get("maxValues", {})) | \
        set(w.get("nullCounts", {}))
    stats = {c: ColumnStats(w.get("minValues", {}).get(c),
                            w.get("maxValues", {}).get(c),
                            w.get("valueCounts", {}).get(c, 0),
                            w.get("nullCounts", {}).get(c, 0)) for c in cols}
    return DataFileMeta(path=w["path"], size_bytes=w["fileSizeInBytes"],
                        record_count=w["numWrites"],
                        partition_values=dict(w.get("partitionValues", {})),
                        column_stats=stats, extra=dict(w.get("tags", {})))


class CommitConflict(RuntimeError):
    pass


class HudiTable:
    format = FORMAT

    def __init__(self, fs, base_path: str):
        self.fs = fs
        self.base = base_path

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def exists(cls, fs, base_path: str) -> bool:
        return fs.exists(join(base_path, HOODIE_DIR, "hoodie.properties"))

    @classmethod
    def create(cls, fs, base_path: str, schema: Schema,
               partition_spec: PartitionSpec = PartitionSpec(),
               properties: dict | None = None) -> "HudiTable":
        t = cls(fs, base_path)
        props = {"hoodie.table.name": (properties or {}).get("name", "table"),
                 "hoodie.table.type": "COPY_ON_WRITE",
                 "hoodie.table.version": "6",
                 "hoodie.table.create.schema": schema_to_avro(schema),
                 "hoodie.table.partition.fields":
                     ",".join(partition_spec.column_names())}
        props.update({k: str(v) for k, v in (properties or {}).items()})
        t._write_props(props, overwrite=False)
        return t

    @classmethod
    def open(cls, fs, base_path: str) -> "HudiTable":
        if not cls.exists(fs, base_path):
            raise FileNotFoundError(f"no hudi table at {base_path}")
        return cls(fs, base_path)

    # -------------------------------------------------------------- timeline
    def _props_path(self) -> str:
        return join(self.base, HOODIE_DIR, "hoodie.properties")

    def _write_props(self, props: dict, overwrite: bool = True) -> None:
        body = "\n".join(f"{k}={v}" for k, v in sorted(props.items())).encode()
        self.fs.write_bytes(self._props_path(), body, overwrite=overwrite)

    def _read_props(self) -> dict:
        out = {}
        for line in self.fs.read_bytes(self._props_path()).decode().splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                out[k] = v
        return out

    @staticmethod
    def _completed_instants(names: list[str]) -> list[tuple[str, str]]:
        """``.hoodie/`` entries -> [(ts, action)] of COMPLETED instants, in
        timeline order.  The one place that knows which filenames are
        visible commits (requested/inflight markers are not) — shared by
        the full timeline scan and the daemon's ``head_token`` probe so the
        visibility rule cannot drift between them."""
        out = []
        for n in names:
            parts = n.split(".")
            if len(parts) == 2 and parts[0].isdigit() and \
                    parts[1] in ("commit", "replacecommit"):
                out.append((parts[0], parts[1]))
        return sorted(out)

    def _timeline(self) -> list[tuple[str, str]]:
        """Completed instants: [(ts, action)] in timeline order."""
        return self._completed_instants(
            self.fs.list_dir(join(self.base, HOODIE_DIR)))

    def _instant_payload(self, ts: str, action: str) -> dict:
        return json.loads(self.fs.read_bytes(
            join(self.base, HOODIE_DIR, f"{ts}.{action}")))

    def _instant_payloads_many(
            self, instants: list[tuple[str, str]]) -> dict[tuple, dict]:
        """Batched fetch of completed-instant payloads keyed by
        (timestamp, action): the independent GETs go through ``read_many``
        so a timeline replay on a high-RTT object store is pipelined, not
        one RTT per instant."""
        blobs = fetch_many(
            self.fs, [join(self.base, HOODIE_DIR, f"{ts}.{a}")
                      for ts, a in instants])
        return {key: json.loads(raw) for key, raw in zip(instants, blobs)}

    # ----------------------------------------------------------------- state
    def current_version(self) -> str:
        tl = self._timeline()
        return tl[-1][0] if tl else "0"

    def head(self) -> str:
        """The newest completed instant — one timeline listing."""
        return self.current_version()

    def head_token(self) -> str:
        """O(1) change-detection probe: an opaque token that moves iff a
        new instant completed.  One ``list_dir`` of ``.hoodie/`` — only
        *completed* instants count (requested/inflight markers are not yet
        visible commits), so the token moves exactly when the atomic commit
        point lands.  An absent table yields ``""``; an empty-but-created
        timeline yields ``"0"`` (the pre-first-instant version).
        """
        return self.head_probe()[0]

    def head_probe(self) -> tuple[str, list | None]:
        """``(head_token, probe_state)`` in ONE storage request.

        The probe state is the parsed completed-instant timeline, which
        ``replay(probe=...)`` can consume within the same daemon cycle so
        the tail refresh never re-lists ``.hoodie/`` (instant timestamps
        are not dense, so unlike delta the listing itself is the memo).
        """
        names = self.fs.list_dir(join(self.base, HOODIE_DIR))
        if not names:
            return "", None
        completed = self._completed_instants(names)
        return (completed[-1][0] if completed else "0"), completed

    def versions(self) -> list[str]:
        return [ts for ts, _ in self._timeline()]

    def snapshot(self, version: str | None = None) -> TableState:
        props = self._read_props()
        target = version if version is not None else self.current_version()
        files: dict[str, DataFileMeta] = {}
        schema = schema_from_avro(props["hoodie.table.create.schema"])
        ts_ms = 0
        upto = [(ts, a) for ts, a in self._timeline() if ts <= target]
        payloads = self._instant_payloads_many(upto)
        for ts, action in upto:
            payload = payloads[(ts, action)]
            for paths in payload.get("partitionToReplacedFilePaths", {}).values():
                for p in paths:
                    files.pop(p, None)
            for stats in payload.get("partitionToWriteStats", {}).values():
                for w in stats:
                    f = _file_from_stat(w)
                    files[f.path] = f
            if "schema" in payload.get("extraMetadata", {}):
                schema = schema_from_avro(payload["extraMetadata"]["schema"])
            ts_ms = max(ts_ms, payload.get("timestampMs", 0))
        pf = props.get("hoodie.table.partition.fields", "")
        spec = PartitionSpec([c for c in pf.split(",") if c])
        user_props = {k: v for k, v in props.items()
                      if not k.startswith("hoodie.")}
        return TableState(FORMAT, target, ts_ms, schema, spec, files, user_props)

    def changes(self, version: str) -> tuple[list[DataFileMeta], list[str], str, dict]:
        for ts, action in self._timeline():
            if ts == version:
                payload = self._instant_payload(ts, action)
                adds = [_file_from_stat(w) for stats in
                        payload.get("partitionToWriteStats", {}).values()
                        for w in stats]
                removes = [p for paths in
                           payload.get("partitionToReplacedFilePaths", {}).values()
                           for p in paths]
                return adds, removes, payload.get("operationType", "unknown"), \
                    decode_extra_metadata(payload.get("extraMetadata", {}))
        raise KeyError(f"instant {version} not found")

    def replay(self, since: str | None = None,
               seed: CommitEntry | None = None,
               probe: list | None = None
               ) -> tuple[TableState | None, list[CommitEntry]]:
        """Single-pass scan of the timeline -> per-instant entries.

        Each completed instant payload is read exactly once; the base state
        is the empty pre-first-instant table (version "0").

        With ``since`` set, only instants AFTER that timestamp are read
        (tail-only refresh, ``base`` is ``None``); ``seed`` — the caller's
        ``CommitEntry`` for ``since`` — supplies the as-of schema, so the
        tail costs O(new instants) reads.  Raises ``KeyError`` if ``since``
        is not a completed instant.

        ``probe`` — the completed-instant timeline from a same-cycle
        ``head_probe()`` — replaces the ``.hoodie/`` listing, so a hinted
        refresh never re-discovers the head it was just told about.
        """
        props = self._read_props()
        schema = schema_from_avro(props["hoodie.table.create.schema"])
        pf = props.get("hoodie.table.partition.fields", "")
        spec = PartitionSpec([c for c in pf.split(",") if c])
        user_props = {k: v for k, v in props.items()
                      if not k.startswith("hoodie.")}
        timeline = list(probe) if probe is not None else self._timeline()
        base: TableState | None = TableState(FORMAT, "0", 0, schema, spec, {},
                                             user_props)
        ts_ms = 0
        if since is not None and since != "0":
            if since not in {ts for ts, _ in timeline}:
                raise KeyError(f"instant {since} not in hudi timeline")
            if seed is None:   # no as-of schema to resume from
                raise KeyError(f"no seed state for instant {since}")
            timeline = [(ts, a) for ts, a in timeline if ts > since]
            base = None
            schema = seed.schema
            ts_ms = seed.timestamp_ms
        elif since is not None:
            base = None
        payloads = self._instant_payloads_many(timeline)
        entries = []
        for ts, action in timeline:
            payload = payloads[(ts, action)]
            adds = [_file_from_stat(w) for stats in
                    payload.get("partitionToWriteStats", {}).values()
                    for w in stats]
            removes = [p for paths in
                       payload.get("partitionToReplacedFilePaths", {}).values()
                       for p in paths]
            if "schema" in payload.get("extraMetadata", {}):
                schema = schema_from_avro(payload["extraMetadata"]["schema"])
            ts_ms = max(ts_ms, payload.get("timestampMs", 0))
            entries.append(CommitEntry(
                ts, ts_ms, payload.get("operationType", "unknown"),
                tuple(adds), tuple(removes), schema, spec, dict(user_props),
                decode_extra_metadata(payload.get("extraMetadata", {}))))
        return base, entries

    def properties(self) -> dict:
        props = self._read_props()
        return {k: v for k, v in props.items() if not k.startswith("hoodie.")}

    def table_properties(self) -> dict:
        """The full ``hoodie.properties`` map, ``hoodie.*`` keys included
        (``properties()`` filters those out) — the public accessor for
        table-level facts like ``hoodie.table.create.schema``."""
        return dict(self._read_props())

    def latest_extra_metadata(self) -> dict:
        tl = self._timeline()
        if not tl:
            return {}
        return decode_extra_metadata(
            self._instant_payload(*tl[-1]).get("extraMetadata", {}))

    # --------------------------------------------------------------- commits
    def commit(self, adds: list[DataFileMeta] = (), removes: list[str] = (), *,
               schema: Schema | None = None, properties: dict | None = None,
               operation: str = "upsert", extra_meta: dict | None = None,
               max_retries: int = 5) -> str:
        action = "replacecommit" if removes else "commit"
        for _ in range(max_retries):
            instant = new_instant()
            hdir = join(self.base, HOODIE_DIR)
            try:
                # three-phase instant state machine
                self.fs.write_bytes(join(hdir, f"{instant}.{action}.requested"), b"{}")
            except PutIfAbsentError:
                continue
            self.fs.write_bytes(join(hdir, f"{instant}.{action}.inflight"), b"{}",
                                overwrite=True)
            p2ws: dict[str, list] = {}
            for f in adds:
                part = "/".join(f"{k}={v}" for k, v in f.partition_values.items())
                p2ws.setdefault(part, []).append(_stat_entry(f))
            p2rf: dict[str, list] = {}
            for p in removes:
                p2rf.setdefault(p.rsplit("/", 1)[0] if "/" in p else "", []) \
                    .append(p)
            cur_schema = schema if schema is not None else self.snapshot().schema
            extra = {"schema": schema_to_avro(cur_schema)}
            if extra_meta:
                extra.update(extra_meta)
            payload = {"partitionToWriteStats": p2ws,
                       "operationType": operation.upper(),
                       "timestampMs": time.time_ns() // 1_000_000,
                       "extraMetadata": encode_extra_metadata(extra)}
            if removes:
                payload["partitionToReplacedFilePaths"] = p2rf
            try:
                self.fs.write_bytes(join(hdir, f"{instant}.{action}"),
                                    json.dumps(payload).encode())
            except PutIfAbsentError:
                continue
            if properties:
                props = self._read_props()
                props.update({k: str(v) for k, v in properties.items()})
                self._write_props(props)
            return instant
        raise CommitConflict("hudi commit retries exhausted")

    # ----------------------------------------------------------- transaction
    def transaction(self, *, schema: Schema | None = None,
                    props: dict | None = None) -> "HudiTransaction":
        """Multi-commit transaction: read the properties + latest instant
        ONCE, keep the schema and table properties in memory, and buffer
        each instant — the requested/inflight markers of the whole chain
        are staged and flushed in one pipelined ``write_many`` round at
        ``flush()``/``close()``; only the completed-instant puts (the
        atomic commit points) stay serial, and the properties file is
        rewritten once per flush instead of once per commit.  ``props`` —
        an already-read ``hoodie.properties`` map — makes begin cost zero
        requests."""
        return HudiTransaction(self, schema=schema, props=props)


class HudiTransaction:
    """Buffered writer state for an N-instant sync unit (single writer).

    Begin cost: one properties read (+ one latest-instant read when the
    schema is not seeded by the caller).  ``commit()`` only buffers: the
    instant timestamp is allocated eagerly (monotonic), the payload is
    materialized in memory, and nothing touches storage until ``flush()``,
    which (1) stages every pending instant's requested + inflight markers
    in one pipelined ``write_many`` round, (2) puts the completed instants
    serially — each a put-if-absent, the atomic commit point — and
    (3) rewrites ``hoodie.properties`` once if any commit changed it.

    A crash anywhere leaves a valid prefix: markers are invisible to
    readers (only *completed* instants are commits), and completed instants
    land oldest-first.  A completed-instant collision (foreign writer owns
    the timestamp) re-allocates that instant AND every later pending one,
    keeping timeline order, then re-flushes the affected markers.
    """

    def __init__(self, table: HudiTable, *, schema: Schema | None = None,
                 props: dict | None = None):
        self.t = table
        self._props = dict(props) if props is not None else table._read_props()
        self._props_dirty = False
        if schema is not None:
            self._schema = schema
        else:
            em = table.latest_extra_metadata()
            self._schema = schema_from_avro(
                em.get("schema") or self._props["hoodie.table.create.schema"])
        self._pending: list[dict] = []   # materialized, not yet flushed
        self._max_retries = 5

    def commit(self, adds: list[DataFileMeta] = (), removes: list[str] = (), *,
               schema: Schema | None = None, properties: dict | None = None,
               operation: str = "upsert", extra_meta: dict | None = None,
               max_retries: int = 5) -> str:
        """Buffer one instant; it lands at the next ``flush()``/``close()``.
        Returns the allocated instant timestamp (re-allocated only if a
        foreign writer collides on it at flush time)."""
        self._max_retries = max(self._max_retries, max_retries)
        action = "replacecommit" if removes else "commit"
        cur_schema = schema if schema is not None else self._schema
        p2ws: dict[str, list] = {}
        for f in adds:
            part = "/".join(f"{k}={v}" for k, v in f.partition_values.items())
            p2ws.setdefault(part, []).append(_stat_entry(f))
        p2rf: dict[str, list] = {}
        for p in removes:
            p2rf.setdefault(p.rsplit("/", 1)[0] if "/" in p else "", []) \
                .append(p)
        extra = {"schema": schema_to_avro(cur_schema)}
        if extra_meta:
            extra.update(extra_meta)
        payload = {"partitionToWriteStats": p2ws,
                   "operationType": operation.upper(),
                   "timestampMs": time.time_ns() // 1_000_000,
                   "extraMetadata": encode_extra_metadata(extra)}
        if removes:
            payload["partitionToReplacedFilePaths"] = p2rf
        self._schema = cur_schema
        if properties:
            self._props.update({k: str(v) for k, v in properties.items()})
            self._props_dirty = True
        instant = new_instant()
        self._pending.append({"instant": instant, "action": action,
                              "payload": json.dumps(payload).encode()})
        return instant

    # ---------------------------------------------------------------- flush
    def flush(self) -> None:
        """Land every buffered instant (see class docstring for the order)."""
        hdir = join(self.t.base, HOODIE_DIR)
        for _ in range(self._max_retries):
            if not self._pending:
                break
            # one pipelined round for ALL pending markers (idempotent:
            # marker content is constant, so restaging after a collision
            # re-allocation is safe with overwrite)
            staged = []
            for p in self._pending:
                stem = join(hdir, f"{p['instant']}.{p['action']}")
                staged.append((f"{stem}.requested", b"{}"))
                staged.append((f"{stem}.inflight", b"{}"))
            flush_many(self.t.fs, staged, overwrite=True)
            collided = False
            while self._pending:
                p = self._pending[0]
                try:
                    self.t.fs.write_bytes(
                        join(hdir, f"{p['instant']}.{p['action']}"),
                        p["payload"])
                except PutIfAbsentError:
                    # a foreign writer owns this timestamp: re-allocate it
                    # and every later pending instant (monotonic allocation
                    # keeps timeline order), then restage their markers
                    for q in self._pending:
                        q["instant"] = new_instant()
                    collided = True
                    break
                self._pending.pop(0)
            if not collided:
                break
        else:
            raise CommitConflict("hudi transactional commit retries exhausted")
        if self._props_dirty:
            self.t._write_props(self._props)
            self._props_dirty = False

    def close(self) -> None:
        self.flush()
