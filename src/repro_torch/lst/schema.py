# Copy of repro/lst/schema.py; the port imports nothing of repro.
"""Logical table definition shared by the engine layer.

Each LST format keeps its *own on-disk encoding* of this information (Delta
schemaString / Iceberg field-id schema / Hudi Avro record schema — see the
format modules); these classes are the in-memory logical view an engine works
with, and the vocabulary the tests use to compare table states across formats.

Canonical types: int32 int64 float32 float64 string bool binary timestamp
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Mapping

CANONICAL_TYPES = ("int32", "int64", "float32", "float64", "string", "bool",
                   "binary", "timestamp")

NUMPY_TO_CANONICAL = {"<i4": "int32", "<i8": "int64", "<f4": "float32",
                      "<f8": "float64", "|b1": "bool"}


@dataclass(frozen=True)
class Field:
    name: str
    type: str
    nullable: bool = True
    field_id: int | None = None   # Iceberg needs stable column ids

    def __post_init__(self):
        if self.type not in CANONICAL_TYPES:
            raise ValueError(f"unknown type {self.type!r}")


@dataclass(frozen=True)
class Schema:
    fields: tuple[Field, ...]
    schema_id: int = 0

    def __init__(self, fields, schema_id: int = 0):
        object.__setattr__(self, "fields", tuple(fields))
        object.__setattr__(self, "schema_id", schema_id)

    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def with_ids(self) -> "Schema":
        """Assign sequential field ids where missing (Delta/Hudi -> Iceberg)."""
        used = [f.field_id for f in self.fields if f.field_id is not None]
        nxt = max(used, default=0) + 1
        out = []
        for f in self.fields:
            if f.field_id is None:
                f = replace(f, field_id=nxt)
                nxt += 1
            out.append(f)
        return Schema(out, self.schema_id)

    def add_field(self, f: Field) -> "Schema":
        return Schema(self.fields + (f,), self.schema_id + 1).with_ids()

    def logical_eq(self, other: "Schema") -> bool:
        """Equality up to field ids (ids are an Iceberg-only concept)."""
        return [(f.name, f.type, f.nullable) for f in self.fields] == \
               [(f.name, f.type, f.nullable) for f in other.fields]


@dataclass(frozen=True)
class PartitionField:
    source: str                  # source column name
    transform: str = "identity"  # identity | truncate[w] | bucket[n] (identity used)
    name: str | None = None

    @property
    def out_name(self) -> str:
        return self.name or self.source


@dataclass(frozen=True)
class PartitionSpec:
    fields: tuple[PartitionField, ...] = ()

    def __init__(self, fields=()):
        object.__setattr__(self, "fields", tuple(
            PartitionField(f) if isinstance(f, str) else f for f in fields))

    def column_names(self) -> list[str]:
        return [f.source for f in self.fields]

    def path_for(self, partition_values: Mapping) -> str:
        """Hive-style partition path: col=value/..."""
        return "/".join(f"{f.out_name}={partition_values[f.out_name]}"
                        for f in self.fields)


@dataclass(frozen=True)
class CommitEntry:
    """One commit of an LST log, as produced by a single-pass ``replay()``.

    The per-format handles emit these in commit order so the metadata cache
    can serve every ``snapshot(commit)`` / ``changes(commit)`` question from
    ONE scan of the log instead of re-replaying per commit.  ``schema`` /
    ``partition_spec`` / ``properties`` / ``timestamp_ms`` are *as of* this
    commit (i.e. what ``snapshot(version)`` would report).
    """
    version: str
    timestamp_ms: int
    operation: str
    adds: tuple                       # tuple[DataFileMeta]
    removes: tuple                    # tuple[str] — removed file paths
    schema: Schema
    partition_spec: PartitionSpec
    properties: dict
    info: dict                        # commit user-metadata (format-native)


@dataclass
class TableState:
    """A point-in-time logical snapshot of an LST (any format)."""
    format: str
    version: str                      # format-native commit/snapshot/instant id
    timestamp_ms: int
    schema: Schema
    partition_spec: PartitionSpec
    files: dict                       # rel path -> DataFileMeta (live files only)
    properties: dict = field(default_factory=dict)

    def total_records(self) -> int:
        return sum(f.record_count for f in self.files.values())

    def total_bytes(self) -> int:
        return sum(f.size_bytes for f in self.files.values())
