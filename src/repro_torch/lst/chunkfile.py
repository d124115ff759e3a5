# Copy of repro/lst/chunkfile.py; the port imports nothing of repro.
"""Immutable columnar data-file format ("chunkfile") with a statistics footer.

Plays the role Parquet/ORC play in the paper: a write-once columnar container
holding the table's records (or, in the checkpoint integration, a tensor
shard), carrying per-column min/max/count statistics that engines use for
scan planning (Scenario 3 of the paper: Trino exploiting Iceberg column
statistics).

Layout v3 (single object, written atomically):

    [4-byte magic "CHK3"] [msgpack header] [column blobs, concatenated]
    [msgpack footer] [8-byte LE footer offset] [4-byte magic]

The header is a msgpack map ``{schema, nrows, extra}`` (``schema`` is the
column declaration list ``[{name, dtype, shape, ...}]``, ``extra`` arbitrary
user metadata — tensor shard coords, tokenizer id, ...).  Each column's
encoded bytes are laid out *outside* the header, one contiguous blob per
column in schema order, so any column is addressable by a byte range.

The footer is a msgpack map

    {nrows, stats, hdr_end, cols, schema}

with ``stats: {name: {min, max, count, nan_count}}``, ``cols: [[name,
offset, length], ...]`` — the **column-offset index** (absolute byte range
of every column blob) — and ``schema`` duplicating the header's column
declarations, so a reader holding only the footer can decode any subset of
columns from ranged reads without ever touching the header or the other
columns' bytes.  The trailing 8-byte little-endian integer is the footer's
byte offset from the start of the object; ``read_chunk_stats`` therefore
needs two ranged reads (suffix trailer + footer, no ``size`` request) and
never fetches column data — the Parquet-footer access pattern — while
:func:`read_chunks_columns` turns the index into *projection pushdown*:
only the requested columns' ranges are fetched (adjacent ranges coalesced
into single ranged GETs, all files in one pipelined batch round).

Layout v2 ("CHK2", still readable) kept the columns inside one msgpack
body map and its footer carried only ``{nrows, stats}``: no column index,
so projected reads of v2 files transparently fall back to full-body
fetches.  New files always write v3.

Statistics live in the same object but are *also* duplicated into every
format's metadata layer by the commit path, which is what makes
metadata-only translation carry pruning power across formats.
"""

from __future__ import annotations

import struct
import threading
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping

import numpy as np

from repro_torch.lst._msgpack import packb, unpackb

MAGIC = b"CHK3"       # v3: column-offset index in the footer
MAGIC_V2 = b"CHK2"    # v2: stats footer, columns inline in the msgpack body
_MAGIC_V1 = b"CHK1"   # v1 had stats inline in the body and no footer
_STR_KIND = "U"


def _magic_version(tag: bytes) -> int:
    if tag == MAGIC:
        return 3
    if tag == MAGIC_V2:
        return 2
    if tag == _MAGIC_V1:
        raise ValueError("chunkfile v1 (CHK1, no stats footer) is "
                         "unsupported; rewrite the data file")
    raise ValueError("not a chunkfile (bad magic)")


@dataclass(frozen=True)
class ColumnStats:
    min: Any = None
    max: Any = None
    count: int = 0
    nan_count: int = 0

    def to_dict(self) -> dict:
        return {"min": self.min, "max": self.max, "count": self.count,
                "nan_count": self.nan_count}

    @staticmethod
    def from_dict(d: Mapping) -> "ColumnStats":
        return ColumnStats(d.get("min"), d.get("max"), d.get("count", 0),
                           d.get("nan_count", 0))


@dataclass(frozen=True)
class DataFileMeta:
    """What the metadata layer records about one immutable data file."""
    path: str                      # RELATIVE to the table base path
    size_bytes: int
    record_count: int
    partition_values: dict = field(default_factory=dict)
    column_stats: dict = field(default_factory=dict)   # name -> ColumnStats
    extra: dict = field(default_factory=dict)

    def stats_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, ColumnStats) else v)
                for k, v in self.column_stats.items()}


@dataclass(frozen=True)
class ChunkFooter:
    """One file's parsed stats footer (+ the v3 column-offset index).

    ``columns`` is the ordered ``(name, offset, length)`` index of the
    column blobs (absolute object byte ranges) and ``schema`` maps each
    column name to its decode declaration — both ``None`` for v2 files,
    which carry no index (projected reads fall back to full bodies).

    Iterating yields ``(nrows, stats)`` so the footer unpacks exactly like
    the pre-v3 ``read_chunk_stats`` tuple.
    """
    nrows: int
    stats: dict                             # name -> ColumnStats
    columns: tuple | None = None            # ((name, offset, length), ...)
    schema: Mapping | None = None           # name -> decl

    def __iter__(self) -> Iterator:
        return iter((self.nrows, self.stats))

    @property
    def projectable(self) -> bool:
        return self.columns is not None


def _scalar(x):
    """Make numpy scalars msgpack-serializable."""
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.str_):
        return str(x)
    return x


def _column_stats(arr: np.ndarray) -> ColumnStats:
    count = int(arr.shape[0]) if arr.ndim else 1
    if arr.dtype.kind in "iuf" and arr.size:
        flat = arr.reshape(-1)
        if arr.dtype.kind == "f":
            nan = int(np.isnan(flat).sum())
            ok = flat[~np.isnan(flat)] if nan else flat
            if ok.size == 0:
                return ColumnStats(None, None, count, nan)
            return ColumnStats(_scalar(ok.min()), _scalar(ok.max()), count, nan)
        return ColumnStats(_scalar(flat.min()), _scalar(flat.max()), count, 0)
    if arr.dtype.kind == _STR_KIND and arr.size:
        # tolist() already yields Python str for U dtype (no per-string
        # conversion pass needed), and builtin min/max order by code point
        # exactly like numpy's U comparisons
        vals = arr.reshape(-1).tolist()
        return ColumnStats(min(vals), max(vals), count, 0)
    if arr.dtype.kind == "S" and arr.size:
        vals = [str(v) for v in arr.reshape(-1).tolist()]
        return ColumnStats(min(vals), max(vals), count, 0)
    return ColumnStats(None, None, count, 0)


def _encode_str_legacy(arr: np.ndarray) -> bytes:
    """The pre-fleet string encoding: a per-string Python loop into a
    msgpack list.  Kept for decode back-compat tests and as the
    benchmark's comparison arm — new files always use the vectorized
    fixed-width path below."""
    return packb([str(s) for s in arr.reshape(-1)])


def _encode_array(arr: np.ndarray, compress: bool) -> tuple[dict, bytes]:
    if arr.dtype.kind == _STR_KIND:
        # unicode -> fixed-width columns via C-level casts, instead of the
        # legacy per-string Python listcomp into msgpack (that loop held
        # the GIL for the whole column — the convoy that made concurrent
        # CPU-bound bootstraps slower than serial).  ASCII columns cast to
        # 1-byte-per-char S dtype in one shot; anything else ships the
        # array's native fixed-width UCS4 buffer (a plain memcpy).
        # Trailing NULs are not representable in numpy's U dtype to begin
        # with, so fixed-width padding loses nothing.
        flat = np.ascontiguousarray(arr.reshape(-1))
        width = max(1, flat.dtype.itemsize // 4)
        decl = {"dtype": "str", "shape": list(arr.shape), "width": width}
        try:
            raw = flat.astype(f"S{width}").tobytes()
            decl["enc"] = "ascii"
        except UnicodeEncodeError:
            raw = flat.tobytes()
            decl["enc"] = "ucs4"
            decl["udtype"] = flat.dtype.str   # preserves byte order
    else:
        raw = np.ascontiguousarray(arr).tobytes()
        decl = {"dtype": arr.dtype.str, "shape": list(arr.shape)}
    if compress:
        raw = zlib.compress(raw, level=1)
        decl["codec"] = "zlib"
    return decl, raw


def _decode_array(decl: Mapping, raw: bytes) -> np.ndarray:
    if decl.get("codec") == "zlib":
        raw = zlib.decompress(raw)
    shape = tuple(decl["shape"])
    if decl["dtype"] == "str":
        enc = decl.get("enc")
        if enc == "ascii":
            w = decl["width"]
            return np.frombuffer(raw, dtype=f"S{w}") \
                .astype(f"U{w}").reshape(shape)
        if enc == "ucs4":
            return np.frombuffer(
                raw, dtype=np.dtype(decl["udtype"])).reshape(shape)
        # legacy files: length-delimited msgpack list of strings
        return np.array(unpackb(raw), dtype=np.str_).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(decl["dtype"])).reshape(shape)


def empty_column(decl: Mapping) -> np.ndarray:
    """A zero-row array with the dtype/trailing shape ``decl`` decodes to —
    exactly what an all-False row mask leaves of the column, synthesized
    without fetching a byte of it (the late-materialized scan's dropped
    chunks still contribute dtype-exact empties to concatenation)."""
    shape = (0,) + tuple(decl["shape"][1:])
    if decl["dtype"] == "str":
        if decl.get("enc") == "ucs4":
            return np.empty(shape, dtype=np.dtype(decl["udtype"]))
        return np.empty(shape, dtype=f"U{decl.get('width', 1)}")
    return np.empty(shape, dtype=np.dtype(decl["dtype"]))


def serialize_chunk(columns: Mapping[str, np.ndarray], *, extra: dict | None = None,
                    compress: bool = False,
                    version: int = 3) -> tuple[bytes, int, dict]:
    """Encode columns -> (payload bytes, nrows, stats dict).

    ``version=2`` writes the legacy CHK2 layout (columns inside the msgpack
    body, no column index) — kept so back-compat tests can mint old files;
    production writers always emit v3.
    """
    nrows = None
    decls, blobs, stats = [], {}, {}
    for name, arr in columns.items():
        arr = np.asarray(arr)
        if nrows is None:
            nrows = int(arr.shape[0]) if arr.ndim else 1
        decl, raw = _encode_array(arr, compress)
        decl["name"] = name
        decls.append(decl)
        blobs[name] = raw
        stats[name] = _column_stats(arr)
    stats_packed = {k: v.to_dict() for k, v in stats.items()}
    if version == 2:
        body = {"schema": decls, "nrows": nrows or 0, "columns": blobs,
                "extra": extra or {}}
        body_packed = packb(body)
        footer = {"nrows": nrows or 0, "stats": stats_packed}
        footer_off = len(MAGIC_V2) + len(body_packed)
        payload = (MAGIC_V2 + body_packed + packb(footer) +
                   struct.pack("<Q", footer_off) + MAGIC_V2)
        return payload, nrows or 0, stats
    if version != 3:
        raise ValueError(f"unsupported chunkfile version: {version}")
    header = packb({"schema": decls, "nrows": nrows or 0,
                            "extra": extra or {}})
    hdr_end = len(MAGIC) + len(header)
    off = hdr_end
    cols_index = []
    for d in decls:
        raw = blobs[d["name"]]
        cols_index.append([d["name"], off, len(raw)])
        off += len(raw)
    footer = {"nrows": nrows or 0, "stats": stats_packed,
              "hdr_end": hdr_end, "cols": cols_index, "schema": decls}
    payload = (MAGIC + header + b"".join(blobs[d["name"]] for d in decls) +
               packb(footer) + struct.pack("<Q", off) + MAGIC)
    return payload, nrows or 0, stats


def write_chunk(fs, base_path: str, rel_path: str,
                columns: Mapping[str, np.ndarray], *,
                partition_values: dict | None = None,
                extra: dict | None = None, compress: bool = False,
                version: int = 3) -> DataFileMeta:
    """Write one immutable data file; returns its metadata-layer description."""
    payload, nrows, stats = serialize_chunk(columns, extra=extra,
                                            compress=compress, version=version)
    full = f"{base_path}/{rel_path}"
    fs.write_bytes(full, payload)  # put-if-absent: data files are write-once
    return DataFileMeta(path=rel_path, size_bytes=len(payload), record_count=nrows,
                        partition_values=dict(partition_values or {}),
                        column_stats=stats, extra=dict(extra or {}))


def write_chunks(fs, base_path: str,
                 files: list[tuple[str, Mapping[str, np.ndarray], dict, dict]],
                 *, compress: bool = False) -> list[DataFileMeta]:
    """Batched ``write_chunk``: serialize every file, then flush all payloads
    in ONE pipelined ``write_many`` round (put-if-absent — data files are
    write-once), instead of one round trip per file.

    ``files`` is ``[(rel_path, columns, partition_values, extra)]``.  Data
    files are commit-*staged* objects: unreferenced until the metadata
    commit that names them lands, so pipelining them cannot tear a table.
    """
    from repro_torch.lst.storage.base import flush_many

    metas, staged = [], []
    for rel_path, columns, partition_values, extra in files:
        payload, nrows, stats = serialize_chunk(columns, extra=extra,
                                                compress=compress)
        staged.append((f"{base_path}/{rel_path}", payload))
        metas.append(DataFileMeta(
            path=rel_path, size_bytes=len(payload), record_count=nrows,
            partition_values=dict(partition_values or {}),
            column_stats=stats, extra=dict(extra or {})))
    flush_many(fs, staged)
    return metas


_TRAILER_LEN = 8 + len(MAGIC)   # footer offset + closing magic


def _parse_full(data: bytes) -> tuple[dict, dict]:
    """Full-object parse -> (decoded columns, extra) for either version."""
    version = _magic_version(data[:4])
    _magic_version(data[-4:])
    (footer_off,) = struct.unpack("<Q", data[-_TRAILER_LEN:-len(MAGIC)])
    if not len(MAGIC) <= footer_off <= len(data) - _TRAILER_LEN:
        raise ValueError("not a chunkfile (bad footer offset)")
    if version == 2:
        body = unpackb(data[len(MAGIC):footer_off],
                               strict_map_key=False)
        cols = {d["name"]: _decode_array(d, body["columns"][d["name"]])
                for d in body["schema"]}
        return cols, body.get("extra", {})
    footer = unpackb(data[footer_off:-_TRAILER_LEN],
                             strict_map_key=False)
    header = unpackb(data[len(MAGIC):footer["hdr_end"]],
                             strict_map_key=False)
    decls = {d["name"]: d for d in footer["schema"]}
    cols = {name: _decode_array(decls[name], data[off:off + ln])
            for name, off, ln in footer["cols"]}
    return cols, header.get("extra", {})


def read_chunk(fs, base_path: str, rel_path: str) -> tuple[dict, dict]:
    """Read columns + extra metadata of a data file."""
    return _parse_full(fs.read_bytes(f"{base_path}/{rel_path}"))


def read_chunks(fs, base_path: str,
                rel_paths: list[str]) -> list[tuple[dict, dict]]:
    """Batched ``read_chunk``: all surviving bodies fetched in ONE
    pipelined ``read_many`` round instead of a round trip per file — the
    read plane's scan path is RTT-bound exactly like the write path was."""
    from repro_torch.lst.storage.base import fetch_many

    blobs = fetch_many(fs, [f"{base_path}/{p}" for p in rel_paths])
    return [_parse_full(blob) for blob in blobs]


def _parse_footer(blob: bytes, version: int, path: str) -> ChunkFooter:
    if len(blob) <= _TRAILER_LEN:
        raise ValueError(f"not a chunkfile (bad footer offset): {path}")
    footer = unpackb(blob[:-_TRAILER_LEN], strict_map_key=False)
    stats = {k: ColumnStats.from_dict(v) for k, v in footer["stats"].items()}
    if version == 2 or "cols" not in footer:
        return ChunkFooter(footer["nrows"], stats)
    return ChunkFooter(footer["nrows"], stats,
                       tuple((c[0], c[1], c[2]) for c in footer["cols"]),
                       {d["name"]: d for d in footer["schema"]})


def read_chunks_footers(fs, base_path: str,
                        rel_paths: list[str]) -> list[ChunkFooter]:
    """Batched footer fetch over many files: two pipelined rounds of
    ranged reads (all trailers, then all footers) via the FileSystem's
    batch API, instead of (size + 2 ranged reads) sequential round trips
    per file.

    Round 1 suffix-reads each trailer (no ``size`` request needed); round 2
    reads from each footer offset to end-of-object and strips the trailer —
    so N files cost ~2 batch round trips on a pipelined object store.  The
    returned :class:`ChunkFooter` carries nrows + stats for both versions
    and, for v3 files, the column-offset index that powers
    :func:`read_chunks_columns`.
    """
    from repro_torch.lst.storage.base import fetch_many_ranges

    fulls = [f"{base_path}/{p}" for p in rel_paths]
    tails = fetch_many_ranges(
        fs, [(f, -_TRAILER_LEN, _TRAILER_LEN) for f in fulls])
    versions, footer_offs = [], []
    for p, tail in zip(fulls, tails):
        if len(tail) < _TRAILER_LEN:
            raise ValueError(f"not a chunkfile (truncated): {p}")
        versions.append(_magic_version(tail[-4:]))
        (off,) = struct.unpack("<Q", tail[:8])
        footer_offs.append(off)
    blobs = fetch_many_ranges(
        fs, [(f, off, -1) for f, off in zip(fulls, footer_offs)])
    return [_parse_footer(blob, ver, p)
            for p, ver, blob in zip(fulls, versions, blobs)]


def read_chunks_stats(fs, base_path: str,
                      rel_paths: list[str]) -> list[tuple[int, dict]]:
    """Batched ``read_chunk_stats``: ``[(nrows, stats)]`` per file via the
    two-round footer fetch of :func:`read_chunks_footers`."""
    return [(f.nrows, f.stats)
            for f in read_chunks_footers(fs, base_path, rel_paths)]


def read_chunk_stats(fs, base_path: str, rel_path: str) -> tuple[int, dict]:
    """Read only nrows + stats via two ranged reads (suffix trailer, then
    footer-to-EOF); no ``size`` request, and the column data is never
    fetched."""
    footer = read_chunks_footers(fs, base_path, [rel_path])[0]
    return footer.nrows, footer.stats


def read_chunks_columns(fs, base_path: str, rel_paths: list[str],
                        columns: list[str] | None = None, *,
                        footers: list[ChunkFooter] | None = None,
                        exclude: frozenset | set | None = None,
                        ) -> list[tuple[dict, int]]:
    """Projection pushdown: fetch only the requested ``columns`` of each
    file through the v3 column-offset index.

    Per file, the requested columns' byte ranges are looked up in its
    footer index, adjacent ranges are coalesced into single ranged reads,
    and every file's ranges go out in ONE pipelined ``read_many_ranges``
    round — a scan projecting k of N columns moves O(k/N) of the bytes a
    full-body fetch would.  ``columns=None`` selects every column (still
    ranged: the header/footer bytes are skipped); ``exclude`` removes
    columns from the selection *after* that (the two-phase scan uses it to
    avoid refetching predicate columns it already holds).

    v2 files carry no index and transparently fall back to a full-body
    read **in the same batch round** (a to-EOF range); every column of
    such a file comes back, whatever was requested — callers project
    after the fact.

    ``footers`` (aligned with ``rel_paths``) reuses already-fetched
    footers — e.g. the read plane's :class:`ChunkStatsCache` entries —
    otherwise they are fetched first via :func:`read_chunks_footers`
    (two extra batch rounds).

    Returns ``[(columns dict, bytes fetched)]`` aligned with
    ``rel_paths``; decoded columns keep the file's schema order.
    """
    from repro_torch.lst.storage.base import coalesce_ranges, fetch_many_ranges

    if footers is None:
        footers = read_chunks_footers(fs, base_path, rel_paths)
    fulls = [f"{base_path}/{p}" for p in rel_paths]
    want = None if columns is None else set(columns)
    drop = frozenset(exclude or ())
    plans: list = []            # per file: list of index entries | "full"
    range_reqs: list[tuple[str, int, int]] = []
    range_owner: list[tuple[int, str]] = []   # (file idx, column name)
    full_files: list[int] = []
    for i, (full, ftr) in enumerate(zip(fulls, footers)):
        if ftr.columns is None:               # v2: no index, whole body
            plans.append("full")
            full_files.append(i)
            continue
        entries = [e for e in ftr.columns
                   if (want is None or e[0] in want) and e[0] not in drop]
        plans.append(entries)
        for name, off, ln in entries:
            range_reqs.append((full, off, ln))
            range_owner.append((i, name))
    merged, slices = coalesce_ranges(range_reqs)
    batch = merged + [(fulls[i], 0, -1) for i in full_files]
    blobs = fetch_many_ranges(fs, batch)

    out: list = [None] * len(fulls)
    pieces: dict[tuple[int, str], bytes] = {}
    for (owner, (mi, off, ln)) in zip(range_owner, slices):
        start = off - merged[mi][1]
        pieces[owner] = blobs[mi][start:start + ln]
    for i, ftr in enumerate(footers):
        if plans[i] == "full":
            continue
        cols = {name: _decode_array(ftr.schema[name], pieces[(i, name)])
                for name, _off, _ln in plans[i]}
        out[i] = (cols, sum(ln for _n, _o, ln in plans[i]))
    for j, i in enumerate(full_files):
        blob = blobs[len(merged) + j]
        cols, _extra = _parse_full(blob)
        out[i] = (cols, len(blob))
    return out


def stats_refute(stats: Mapping[str, ColumnStats], column: str, op: str,
                 value) -> bool:
    """True only when the footer stats PROVE no row of the chunk matches
    ``column <op> value`` — the predicate-pushdown primitive behind the
    read plane's pruned ``scan()``.

    Strictly conservative: a column with no stats entry, a None min/max
    (all-NaN or non-comparable dtype), an unknown op, or a type-mismatched
    comparison all answer False (keep the chunk).  NaN rows never satisfy
    a comparison predicate, and min/max are computed over the non-NaN
    values, so refuting by min/max stays sound for float columns with any
    ``nan_count``.
    """
    st = stats.get(column)
    if st is None or st.min is None or st.max is None:
        return False
    try:
        if op == "==":
            return bool(value < st.min or value > st.max)
        if op == "<":
            return bool(st.min >= value)
        if op == "<=":
            return bool(st.min > value)
        if op == ">":
            return bool(st.max <= value)
        if op == ">=":
            return bool(st.max < value)
    except TypeError:
        return False
    return False


def _footer_cost(footer: ChunkFooter, path: str) -> int:
    """Approximate retained bytes of one cached footer entry."""
    cost = 96 + len(path)
    for name, st in footer.stats.items():
        cost += 64 + len(name)
        for v in (st.min, st.max):
            cost += len(v) * 4 if isinstance(v, str) else 8
    if footer.columns is not None:
        # column-offset index + decode decls ride along in the entry
        cost += sum(88 + 2 * len(name) for name, _o, _l in footer.columns)
    return cost


class ChunkStatsCache:
    """Byte-budgeted LRU of chunk footers, keyed by full chunk path.

    Chunk files are write-once and uniquely named, so a cached footer is
    valid forever — the cache only ever *evicts* (over budget), never
    invalidates.  ``get_many`` serves hits from memory and fetches all
    misses through :func:`read_chunks_footers`'s two pipelined ranged-read
    rounds, so a scan over N files costs at most 2 batch round trips on
    its first pass and ZERO footer requests on every later pass.  Each
    entry is a full :class:`ChunkFooter` — for v3 files the column-offset
    index rides along for free, which is what lets a warm projected scan
    go straight to its single column-range round.

    Thread-safe; concurrent misses on the same path may fetch twice, but
    both fetch the same immutable bytes, so last-insert-wins is correct.
    """

    def __init__(self, max_bytes: int = 16 * 2**20):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # path -> (footer, cost); OrderedDict end = most recent
        self._entries: OrderedDict[str, tuple[ChunkFooter, int]] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get_many(self, fs, base_path: str,
                 rel_paths: list[str]) -> list[ChunkFooter]:
        """:class:`ChunkFooter` per path, aligned with ``rel_paths``."""
        fulls = [f"{base_path}/{p}" for p in rel_paths]
        out: list = [None] * len(fulls)
        missing: list[int] = []
        with self._lock:
            for i, full in enumerate(fulls):
                ent = self._entries.get(full)
                if ent is not None:
                    self._entries.move_to_end(full)
                    self.hits += 1
                    out[i] = ent[0]
                else:
                    missing.append(i)
        if not missing:
            return out
        fetched = read_chunks_footers(fs, base_path,
                                      [rel_paths[i] for i in missing])
        with self._lock:
            self.misses += len(missing)
            for i, footer in zip(missing, fetched):
                out[i] = footer
                full = fulls[i]
                if full not in self._entries:
                    cost = _footer_cost(footer, full)
                    self._entries[full] = (footer, cost)
                    self._bytes += cost
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                _, (_, cost) = self._entries.popitem(last=False)
                self._bytes -= cost
                self.evictions += 1
        return out
