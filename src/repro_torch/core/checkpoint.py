# Copy of repro/core/checkpoint.py; the port imports nothing of repro.
"""Durable daemon checkpoints: crash-safe warm restarts.

A crashed or roll-restarted daemon loses only *derived* state — sync tokens
are already persisted in each target's own metadata (the targets are
self-describing), and every target commit is an atomic put-if-absent, so
correctness never depended on daemon memory.  What a cold restart loses is
*time*: the :class:`~repro_torch.core.metadata_cache.TableMetadataIndex` rebuilds
from a full O(history) log replay per table.  This module persists the
cheap-to-save, expensive-to-recompute remainder through the same storage
layer the daemon already writes targets with:

* per-table watch state (last clean-drain token, pending flag, lag),
* an index *seed* — the folded :class:`TableState` at an anchor just behind
  the head plus the tail of :class:`CommitEntry`\\ s from the anchor to the
  head (wide enough to cover the table's pending backlog),
* the breaker states (``core/health.py``) and the fleet's per-table EWMA
  commit rates.

**The write is the same single-atomic-commit-point discipline the targets
use**: one ``gen-N.json`` object per save, created with a conditional put
(put-if-absent), so concurrent daemons race on the generation number and a
crash mid-save leaves at worst a missing or partial *newest* generation —
``load()`` walks generations newest-first and skips anything unreadable or
unparseable.  Older generations are pruned best-effort.

**The checkpoint is advisory; the live head always wins.**  Restoring only
seeds in-memory state: the first cycle's head probe re-verifies against the
real table, a moved head replays just the new tail (O(new commits)), and an
anchor the log no longer reaches (vacuum, divergent rewrite, a head behind
the checkpoint) falls back to a full rebuild — a stale or lying checkpoint
can cost a rebuild, never a wrong splice.
"""

from __future__ import annotations

import json
import threading

from repro_torch.lst.chunkfile import ColumnStats, DataFileMeta
from repro_torch.lst.schema import (CommitEntry, Field, PartitionField,
                              PartitionSpec, Schema, TableState)
from repro_torch.lst.storage.base import PutIfAbsentError, join

__all__ = ["CHECKPOINT_VERSION", "CheckpointStore", "encode_seed",
           "decode_seed", "entry_to_json", "entry_from_json",
           "state_to_json", "state_from_json"]

CHECKPOINT_VERSION = 1

_GEN_PREFIX = "gen-"
_GEN_SUFFIX = ".json"


# --------------------------------------------------------------- JSON codecs
def _schema_to_json(s: Schema) -> dict:
    return {"schemaId": s.schema_id,
            "fields": [{"name": f.name, "type": f.type,
                        "nullable": f.nullable, "fieldId": f.field_id}
                       for f in s.fields]}


def _schema_from_json(d: dict) -> Schema:
    return Schema([Field(f["name"], f["type"], f.get("nullable", True),
                         f.get("fieldId"))
                   for f in d["fields"]], d.get("schemaId", 0))


def _spec_to_json(p: PartitionSpec) -> dict:
    return {"fields": [{"source": f.source, "transform": f.transform,
                        "name": f.name} for f in p.fields]}


def _spec_from_json(d: dict) -> PartitionSpec:
    return PartitionSpec([PartitionField(f["source"],
                                         f.get("transform", "identity"),
                                         f.get("name"))
                          for f in d["fields"]])


def _stats_to_json(stats: dict) -> dict:
    # column_stats values are ColumnStats instances or raw JSON-safe
    # values, depending on which handle parsed them; tag the typed ones so
    # the round trip reconstructs exactly what was serialized
    return {k: ({"__cs__": v.to_dict()} if isinstance(v, ColumnStats) else v)
            for k, v in stats.items()}


def _stats_from_json(d: dict) -> dict:
    return {k: (ColumnStats.from_dict(v["__cs__"])
                if isinstance(v, dict) and "__cs__" in v else v)
            for k, v in d.items()}


def _file_to_json(f: DataFileMeta) -> dict:
    return {"path": f.path, "sizeBytes": f.size_bytes,
            "recordCount": f.record_count,
            "partitionValues": dict(f.partition_values),
            "columnStats": _stats_to_json(f.column_stats),
            "extra": dict(f.extra)}


def _file_from_json(d: dict) -> DataFileMeta:
    return DataFileMeta(d["path"], d["sizeBytes"], d["recordCount"],
                        dict(d.get("partitionValues", {})),
                        _stats_from_json(d.get("columnStats", {})),
                        dict(d.get("extra", {})))


def entry_to_json(e: CommitEntry) -> dict:
    return {"version": e.version, "timestampMs": e.timestamp_ms,
            "operation": e.operation,
            "adds": [_file_to_json(f) for f in e.adds],
            "removes": list(e.removes),
            "schema": _schema_to_json(e.schema),
            "partitionSpec": _spec_to_json(e.partition_spec),
            "properties": dict(e.properties), "info": dict(e.info)}


def entry_from_json(d: dict) -> CommitEntry:
    return CommitEntry(
        version=d["version"], timestamp_ms=d["timestampMs"],
        operation=d["operation"],
        adds=tuple(_file_from_json(f) for f in d["adds"]),
        removes=tuple(d["removes"]),
        schema=_schema_from_json(d["schema"]),
        partition_spec=_spec_from_json(d["partitionSpec"]),
        properties=dict(d.get("properties", {})),
        info=dict(d.get("info", {})))


def state_to_json(s: TableState) -> dict:
    return {"format": s.format, "version": s.version,
            "timestampMs": s.timestamp_ms,
            "schema": _schema_to_json(s.schema),
            "partitionSpec": _spec_to_json(s.partition_spec),
            "files": [_file_to_json(f) for f in s.files.values()],
            "properties": dict(s.properties)}


def state_from_json(d: dict) -> TableState:
    files = [_file_from_json(f) for f in d["files"]]
    return TableState(d["format"], d["version"], d["timestampMs"],
                      _schema_from_json(d["schema"]),
                      _spec_from_json(d["partitionSpec"]),
                      {f.path: f for f in files},
                      dict(d.get("properties", {})))


def encode_seed(seed: tuple[TableState, list[CommitEntry]] | None) -> dict | None:
    """JSON form of ``TableMetadataIndex.snapshot_seed()``'s result."""
    if seed is None:
        return None
    base, entries = seed
    return {"base": state_to_json(base),
            "entries": [entry_to_json(e) for e in entries]}


def decode_seed(d: dict | None) -> tuple[TableState, list[CommitEntry]] | None:
    if not d:
        return None
    return (state_from_json(d["base"]),
            [entry_from_json(e) for e in d["entries"]])


# ------------------------------------------------------------ durable store
class CheckpointStore:
    """Generation-numbered checkpoint documents under one storage prefix.

    ``save()`` is one conditional put of ``gen-{N+1}.json`` — the atomic
    commit point; two daemons racing the same prefix see exactly one
    winner per generation and the loser re-reads the latest and takes the
    next number.  ``load()`` returns the newest *parseable* generation, so
    a crash mid-save (or a corrupt object) silently falls back one
    generation instead of poisoning the restart.
    """

    def __init__(self, fs, base_path: str, *, retain: int = 3):
        if retain < 1:
            raise ValueError("retain must be >= 1")
        self.fs = fs
        self.base_path = base_path.rstrip("/")
        self.retain = retain
        self._lock = threading.Lock()
        self._gen: int | None = None      # highest generation we know exists
        self.saves = 0
        self.load_fallbacks = 0           # corrupt generations skipped

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

    # ---------------------------------------------------------------- load
    def load(self) -> tuple[int, dict] | None:
        """``(generation, payload)`` of the newest readable+parseable
        generation, or ``None`` for a cold start.  Unreadable newest
        generations (crash mid-save, corruption) are skipped, not fatal."""
        gens = self._scan()
        with self._lock:
            self._gen = gens[-1] if gens else 0
        for gen in reversed(gens):
            try:
                payload = json.loads(self.fs.read_bytes(self._path(gen)))
                if payload.get("version") != CHECKPOINT_VERSION:
                    raise ValueError(f"unknown checkpoint version "
                                     f"{payload.get('version')!r}")
                return gen, payload
            except Exception:
                with self._lock:
                    self.load_fallbacks += 1
                continue
        return None

    # ---------------------------------------------------------------- save
    def save(self, payload: dict) -> int:
        """Persist ``payload`` as the next generation (atomic conditional
        put); returns the generation written.  Prunes the generation that
        just fell off the retention window, best-effort."""
        payload = dict(payload)
        payload["version"] = CHECKPOINT_VERSION
        data = json.dumps(payload, sort_keys=True).encode()
        with self._lock:
            gen = self._gen
        if gen is None:
            gens = self._scan()
            gen = gens[-1] if gens else 0
        while True:
            gen += 1
            try:
                self.fs.write_bytes(self._path(gen), data)
                break
            except PutIfAbsentError:
                # another daemon landed this generation first: jump past
                # everything that exists and try the next slot
                gens = self._scan()
                gen = gens[-1] if gens else gen
        with self._lock:
            self._gen = gen
            self.saves += 1
        stale = gen - self.retain
        if stale >= 1:
            try:
                self.fs.delete(self._path(stale))
            except Exception:
                pass        # retention is best-effort; never fail a save
        return gen
