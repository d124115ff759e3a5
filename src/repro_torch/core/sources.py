# Copy of repro/core/sources.py; the port imports nothing of repro.
"""Source readers (paper §3.1): format -> Unified Internal Representation.

One reader per LST format. Each uses the format's own access layer (the way
real XTable links the Delta Kernel / Iceberg API / Hudi client) and emits IR
snapshots and per-commit change sets.

Readers sit on a :class:`~repro_torch.core.metadata_cache.TableMetadataIndex`: the
source log is replayed once per table and every snapshot/change question —
for every commit, for every target — is answered from that single pass.
The index is shared across all targets of a dataset via the run's
``MetadataCache``, so N targets still cost one replay.
"""

from __future__ import annotations

from typing import Protocol

from repro_torch.core.ir import InternalDataFile, InternalSnapshot, TableChange
from repro_torch.core.metadata_cache import TableMetadataIndex
from repro_torch.lst.delta import DeltaTable
from repro_torch.lst.hudi import HudiTable
from repro_torch.lst.iceberg import IcebergTable
from repro_torch.lst.schema import CommitEntry


class ConversionSource(Protocol):
    format: str

    def current_commit(self) -> str: ...
    def get_snapshot(self, commit: str | None = None) -> InternalSnapshot: ...
    def get_commits_since(self, token: str | None) -> list[str]: ...
    def get_changes(self, commit: str) -> TableChange: ...
    def has_commit(self, token: str) -> bool: ...


def _change_extra(info: dict) -> dict:
    """Commit user-metadata carried into targets (strings, minus internals)."""
    return {k: v for k, v in (info or {}).items()
            if isinstance(v, str) and not k.startswith("xtable.")
            and k not in ("schema", "timestamp", "operation")}


class _HandleSource:
    """Shared implementation over the common format-handle protocol."""

    handle_cls = None
    format = "?"

    def __init__(self, fs, base_path: str, index: TableMetadataIndex | None = None):
        self.fs = fs
        self.base = base_path
        if index is not None:
            self.index = index
            self.handle = index.handle
        else:
            self.handle = self.handle_cls.open(fs, base_path)
            self.index = TableMetadataIndex(self.handle)

    # -- snapshots ---------------------------------------------------------
    def current_commit(self) -> str:
        return self.index.head()

    def get_snapshot(self, commit: str | None = None) -> InternalSnapshot:
        st = self.index.state_at(commit)
        props = dict(st.properties)
        props.update(self._latest_commit_meta())
        return InternalSnapshot(
            source_format=self.format, source_commit=st.version,
            timestamp_ms=st.timestamp_ms, schema=st.schema,
            partition_spec=st.partition_spec,
            files=tuple(InternalDataFile.from_meta(f)
                        for f in st.files.values()),
            properties=props)

    def _latest_commit_meta(self) -> dict:
        """User metadata of the head commit (carried into targets)."""
        versions = self.index.versions()
        if not versions:
            return {}
        return _change_extra(self.index.entry(versions[-1]).info)

    # -- incremental -------------------------------------------------------
    def get_commits_since(self, token: str | None) -> list[str]:
        versions = self.index.versions()
        if token is None:
            return versions
        if token not in versions:
            raise KeyError(f"token {token} not in source history")
        return versions[versions.index(token) + 1:]

    def has_commit(self, token: str) -> bool:
        return self.index.has(token)

    def get_changes(self, commit: str) -> TableChange:
        e: CommitEntry = self.index.entry(commit)
        return TableChange(
            source_format=self.format, source_commit=commit,
            timestamp_ms=e.timestamp_ms, operation=e.operation,
            adds=tuple(InternalDataFile.from_meta(f) for f in e.adds),
            removes=tuple(e.removes), schema=e.schema,
            extra=_change_extra(e.info))


class DeltaSource(_HandleSource):
    handle_cls = DeltaTable
    format = "delta"


class IcebergSource(_HandleSource):
    handle_cls = IcebergTable
    format = "iceberg"

    def get_commits_since(self, token: str | None) -> list[str]:
        # iceberg "-1" denotes the empty pre-first-snapshot state
        if token == "-1":
            return self.index.versions()
        return super().get_commits_since(token)

    def has_commit(self, token: str) -> bool:
        return token == "-1" or super().has_commit(token)


class HudiSource(_HandleSource):
    handle_cls = HudiTable
    format = "hudi"

    def get_commits_since(self, token: str | None) -> list[str]:
        # hudi "0" denotes the empty pre-first-instant state
        if token == "0":
            return self.index.versions()
        return super().get_commits_since(token)

    def has_commit(self, token: str) -> bool:
        return token == "0" or super().has_commit(token)


SOURCES = {"delta": DeltaSource, "iceberg": IcebergSource, "hudi": HudiSource}


def make_source(fmt: str, fs, base_path: str,
                index: TableMetadataIndex | None = None) -> ConversionSource:
    return SOURCES[fmt](fs, base_path, index)
