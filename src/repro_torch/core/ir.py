# Copy of repro/core/ir.py; the port imports nothing of repro.
"""XTable's Unified Internal Representation (paper §3, "Extensible").

The IR is the hub of the hub-and-spoke design: source readers produce it,
target writers consume it, and no format ever needs to know about another.
Adding format N+1 costs one reader + one writer instead of 2N translators.

The IR deliberately captures the *intersection semantics* the paper
identifies as shared across Delta/Iceberg/Hudi metadata layers:
schema, partition spec, versioned file lists with per-column statistics,
and per-commit change sets (adds/removes).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.lst.chunkfile import ColumnStats, DataFileMeta
from repro_torch.lst.schema import PartitionSpec, Schema

# Schema / PartitionSpec / ColumnStats are format-neutral already; the IR
# adopts them as its canonical vocabulary.
InternalSchema = Schema
InternalPartitionSpec = PartitionSpec
InternalColumnStats = ColumnStats


@dataclass(frozen=True)
class InternalDataFile:
    """One immutable data file as the IR sees it (format-independent)."""
    physical_path: str            # relative to the table base path
    file_size_bytes: int
    record_count: int
    partition_values: dict = field(default_factory=dict)
    column_stats: dict = field(default_factory=dict)   # name -> ColumnStats
    extra: dict = field(default_factory=dict)

    @staticmethod
    def from_meta(m: DataFileMeta) -> "InternalDataFile":
        return InternalDataFile(m.path, m.size_bytes, m.record_count,
                                dict(m.partition_values), dict(m.column_stats),
                                dict(m.extra))

    def to_meta(self) -> DataFileMeta:
        return DataFileMeta(self.physical_path, self.file_size_bytes,
                            self.record_count, dict(self.partition_values),
                            dict(self.column_stats), dict(self.extra))


@dataclass(frozen=True)
class InternalSnapshot:
    """Full table state at one source commit (drives FULL sync)."""
    source_format: str
    source_commit: str            # format-native commit/snapshot/instant id
    timestamp_ms: int
    schema: InternalSchema
    partition_spec: InternalPartitionSpec
    files: tuple                  # tuple[InternalDataFile]
    properties: dict = field(default_factory=dict)

    def file_paths(self) -> set[str]:
        return {f.physical_path for f in self.files}


@dataclass(frozen=True)
class TableChange:
    """One source commit's delta (drives INCREMENTAL sync).

    A coalesced change (see :func:`fold_changes`) represents a whole commit
    RANGE folded to its net effect; ``lineage`` then lists the folded source
    commits in order, and target writers persist it in the target commit's
    extra metadata so per-commit provenance survives the fold.
    """
    source_format: str
    source_commit: str
    timestamp_ms: int
    operation: str
    adds: tuple                   # tuple[InternalDataFile]
    removes: tuple                # tuple[str] — physical paths
    schema: InternalSchema | None = None   # set when the commit evolved schema
    extra: dict = field(default_factory=dict)  # source commit user-metadata
    lineage: tuple = ()           # source commits folded into this change


def fold_changes(changes: list) -> TableChange:
    """Fold an ordered commit range into ONE net TableChange.

    Dict-fold of the per-commit adds/removes: a file added then removed
    inside the range disappears entirely; a file removed then re-added
    becomes a replace (listed in both removes and adds — targets apply
    removes before adds within a commit); everything else carries through.
    The result advances a target from just-before ``changes[0]`` to exactly
    ``changes[-1]`` in a single target commit.
    """
    if not changes:
        raise ValueError("cannot fold an empty change list")
    if len(changes) == 1:
        return changes[0]
    net_adds: dict[str, InternalDataFile] = {}
    net_removes: list[str] = []
    seen_removes: set[str] = set()
    extra: dict = {}
    for ch in changes:
        for p in ch.removes:
            if p in net_adds:          # born and died within the range
                del net_adds[p]
            elif p not in seen_removes:
                seen_removes.add(p)
                net_removes.append(p)
        for f in ch.adds:
            net_adds[f.physical_path] = f
        extra.update(ch.extra)
    last = changes[-1]
    schema = next((c.schema for c in reversed(changes)
                   if c.schema is not None), None)
    return TableChange(
        source_format=last.source_format, source_commit=last.source_commit,
        timestamp_ms=last.timestamp_ms, operation="coalesced",
        adds=tuple(net_adds.values()), removes=tuple(net_removes),
        schema=schema, extra=extra,
        lineage=tuple(c.source_commit for c in changes))


@dataclass(frozen=True)
class InternalTable:
    """Static identity of a dataset under translation."""
    base_path: str
    name: str = "table"
