# Copy of repro/lst/table.py; the port imports nothing of repro.
"""The "engine" role: a format-agnostic table API over any LST.

Plays the part Spark/Trino/Flink play in the paper's demo — an engine that
reads/writes a table *through one format's connector*.  Scan planning uses
the metadata layer only (partition pruning + column min/max stats), which is
the mechanism behind the paper's Scenario 3 (Trino running faster on Iceberg
statistics): after an XTable sync, the same pruning power is available in
every target format because the statistics were translated with the metadata.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Iterator, Mapping

import numpy as np

from repro_torch.lst import chunkfile, delta, hudi, iceberg
from repro_torch.lst.chunkfile import DataFileMeta
from repro_torch.lst.schema import PartitionSpec, Schema, TableState

FORMATS = {"delta": delta.DeltaTable, "iceberg": iceberg.IcebergTable,
           "hudi": hudi.HudiTable}


@dataclass(frozen=True)
class Predicate:
    """column <op> value; op in {==, <=, >=, <, >}. Stats-prunable."""
    column: str
    op: str
    value: object

    def may_match_file(self, f: DataFileMeta) -> bool:
        # partition pruning
        if self.column in f.partition_values:
            pv = f.partition_values[self.column]
            try:
                pv = type(self.value)(pv)
            except (TypeError, ValueError):
                pass
            return _cmp(pv, self.op, self.value, exact=True)
        st = f.column_stats.get(self.column)
        if st is None or st.min is None or st.max is None:
            return True  # no stats -> cannot prune
        if self.op == "==":
            return st.min <= self.value <= st.max
        if self.op in ("<", "<="):
            return _cmp(st.min, self.op, self.value, exact=False)
        if self.op in (">", ">="):
            return _cmp(st.max, self.op, self.value, exact=False)
        return True

    def mask(self, col: np.ndarray) -> np.ndarray:
        return _cmp(col, self.op, self.value, exact=True)


def _cmp(lhs, op, rhs, exact: bool):
    if op == "==":
        return lhs == rhs if exact else True
    return {"<": lhs < rhs, "<=": lhs <= rhs,
            ">": lhs > rhs, ">=": lhs >= rhs}[op]


class LakeTable:
    """Engine-facing handle: open with ANY format, same logical table."""

    def __init__(self, fs, base_path: str, handle):
        self.fs = fs
        self.base = base_path
        self.handle = handle

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def create(cls, fs, base_path: str, schema: Schema, fmt: str,
               partition_spec: PartitionSpec = PartitionSpec(),
               properties: dict | None = None) -> "LakeTable":
        handle = FORMATS[fmt].create(fs, base_path, schema, partition_spec,
                                     properties)
        return cls(fs, base_path, handle)

    @classmethod
    def open(cls, fs, base_path: str, fmt: str) -> "LakeTable":
        return cls(fs, base_path, FORMATS[fmt].open(fs, base_path))

    @property
    def format(self) -> str:
        return self.handle.format

    def state(self, version: str | None = None) -> TableState:
        return self.handle.snapshot(version)

    def history(self) -> list[str]:
        return self.handle.versions()

    # ----------------------------------------------------------------- write
    def append(self, columns: Mapping[str, np.ndarray], *,
               rows_per_file: int | None = None) -> str:
        """Append rows; splits into partition-directory chunk files."""
        st = self.state()
        pcols = st.partition_spec.column_names()
        n = len(next(iter(columns.values())))
        groups: dict[tuple, np.ndarray] = {(): np.arange(n)}
        if pcols:
            keys = np.stack([np.asarray(columns[c]).astype(str) for c in pcols], 1)
            groups = {}
            for i, k in enumerate(map(tuple, keys)):
                groups.setdefault(k, []).append(i)
            groups = {k: np.array(v) for k, v in groups.items()}
        version = self.handle.current_version()
        files = []
        for key, idx in groups.items():
            pv = dict(zip(pcols, key))
            sub = {c: np.asarray(a)[idx] for c, a in columns.items()}
            splits = [sub] if not rows_per_file else [
                {c: a[i:i + rows_per_file] for c, a in sub.items()}
                for i in range(0, len(idx), rows_per_file)]
            for part in splits:
                fid = uuid.uuid4().hex[:12]
                pdir = st.partition_spec.path_for(pv) if pv else "data"
                files.append((f"{pdir}/{fid}_{version}.chunk", part, pv, None))
        # all chunk files of the commit flushed in one pipelined round; the
        # metadata commit below is what makes them visible
        adds = chunkfile.write_chunks(self.fs, self.base, files)
        return self.handle.commit(adds, operation="WRITE")

    def delete_where(self, pred: Predicate) -> str:
        """Copy-on-write delete (paper §2, Listing 1 line 3)."""
        st = self.state()
        version = self.handle.current_version()
        removes, rewrites = [], []
        for f in st.files.values():
            if not pred.may_match_file(f):
                continue
            cols, extra = chunkfile.read_chunk(self.fs, self.base, f.path)
            keep = ~pred.mask(cols[pred.column])
            if keep.all():
                continue
            removes.append(f.path)
            if keep.any():
                fid = uuid.uuid4().hex[:12]
                pdir = f.path.rsplit("/", 1)[0]
                rel = f"{pdir}/{fid}_{version}.chunk"
                rewrites.append((rel, {c: a[keep] for c, a in cols.items()},
                                 f.partition_values, extra))
        if not removes:
            return self.handle.current_version()
        # the copied (COW-rewritten) chunk files flush in one pipelined round
        adds = chunkfile.write_chunks(self.fs, self.base, rewrites)
        return self.handle.commit(adds, removes, operation="DELETE")

    def evolve_schema(self, new_schema: Schema) -> str:
        return self.handle.commit(schema=new_schema, operation="ALTER")

    # ------------------------------------------------------------------ read
    def scan(self, *predicates: Predicate,
             version: str | None = None,
             columns: list[str] | None = None) -> Iterator[dict]:
        """Yield per-file column dicts; files pruned via metadata stats.

        All surviving files are fetched in ONE pipelined batch round, and
        a ``columns`` projection is pushed below the round trip: only the
        requested + predicate columns' byte ranges are read through the
        CHK3 column index (CHK2 files fall back to full bodies in the
        same round) — the local-API scan gets the same economics as the
        read plane's.
        """
        st = self.state(version)
        plan = self.plan_files(st, predicates)
        paths = [f.path for f in plan]
        if columns:
            need = sorted({*columns, *(p.column for p in predicates)})
            bodies = [cols for cols, _nbytes in chunkfile.read_chunks_columns(
                self.fs, self.base, paths, need)]
        else:
            bodies = [cols for cols, _extra in chunkfile.read_chunks(
                self.fs, self.base, paths)]
        for f, cols in zip(plan, bodies):
            mask = np.ones(f.record_count, bool)
            for p in predicates:
                if p.column in cols:
                    mask &= p.mask(cols[p.column])
            if columns:
                cols = {c: cols[c] for c in columns if c in cols}
            yield {c: a[mask] if a.shape[:1] == mask.shape else a
                   for c, a in cols.items()}

    def plan_files(self, st: TableState,
                   predicates: tuple[Predicate, ...] = ()) -> list[DataFileMeta]:
        """Scan planning over metadata only — the Scenario-3 mechanism."""
        return [f for f in st.files.values()
                if all(p.may_match_file(f) for p in predicates)]

    def read_all(self, *predicates: Predicate, version: str | None = None,
                 columns: list[str] | None = None) -> dict:
        batches = list(self.scan(*predicates, version=version,
                                 columns=columns))
        if not batches:
            return {}
        return {c: np.concatenate([b[c] for b in batches])
                for c in batches[0]}

    def verify_stats(self, version: str | None = None) -> list[str]:
        """Cross-check the metadata layer against the data files' own
        stats footers; returns the paths that disagree.

        This is the integrity check behind metadata-only translation: every
        format's metadata must carry the same nrows/min/max/null counts the
        chunk footers do, or pruning gives wrong answers after a sync.  The
        footers are fetched with batched ranged reads
        (:func:`~repro_torch.lst.chunkfile.read_chunks_stats`) — two pipelined
        rounds for the whole table, never touching column data.
        """
        st = self.state(version)
        metas = list(st.files.values())
        footers = chunkfile.read_chunks_stats(self.fs, self.base,
                                              [f.path for f in metas])

        def disagree(meta_stats: dict, footer_stats: dict) -> bool:
            # a format may carry no stats for a column (that only weakens
            # pruning); corruption is carrying DIFFERENT values
            for c, fstat in footer_stats.items():
                m = meta_stats.get(c)
                if m is not None and (m.min, m.max, m.nan_count) != \
                        (fstat.min, fstat.max, fstat.nan_count):
                    return True
            return False

        return [f.path for f, (nrows, stats) in zip(metas, footers)
                if f.record_count != nrows or disagree(f.column_stats, stats)]
