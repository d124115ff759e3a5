"""The port's lake layer against the reference's: the msgpack codec, CHK3
chunk files, Delta / Iceberg / Hudi translation and checkpoints, each
written by one package and read by the other.

Equality is exact throughout (bytes, table states, tensor bits): both
packages implement one on-disk format.
"""

import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.checkpoint.manager as jax_manager  # noqa: E402
import repro_torch.checkpoint.manager as manager  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.core import SyncConfig as JaxSyncConfig  # noqa: E402
from repro.core import run_sync as jax_run_sync  # noqa: E402
from repro.lst import LakeTable as JaxLakeTable  # noqa: E402
from repro.lst import LocalFS as JaxLocalFS  # noqa: E402
from repro.lst import chunkfile as jax_chunkfile  # noqa: E402
from repro.lst.schema import Field as JaxField  # noqa: E402
from repro.lst.schema import PartitionSpec as JaxPartitionSpec  # noqa: E402
from repro.lst.schema import Schema as JaxSchema  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.param import template_shapes  # noqa: E402
from repro_torch.checkpoint import LSTCheckpointManager, leaf_paths  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import SyncConfig, run_sync  # noqa: E402
from repro_torch.lst import LakeTable, LocalFS, MemoryFS, chunkfile  # noqa: E402
from repro_torch.lst import _msgpack  # noqa: E402
from repro_torch.lst.schema import Field, PartitionSpec, Schema  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

torch.set_num_threads(2)

FORMATS = ("hudi", "iceberg", "delta")
PORT, REF = "port", "ref"


# -------------------------------------------------------------------- codec
def _columns(kind: str) -> dict:
    rng = np.random.default_rng(7)
    if kind == "numeric":
        f = rng.standard_normal(40)
        f[3] = np.nan
        return {"i": rng.integers(-2**40, 2**40, 40),
                "u8": rng.integers(0, 255, 40).astype(np.uint8),
                "f32": rng.standard_normal(40).astype(np.float32),
                "f64": f, "b": rng.integers(0, 2, 40).astype(bool)}
    if kind == "strings":
        return {"ascii": np.array([f"row-{i}" * (i % 5 + 1)
                                   for i in range(30)]),
                "unicode": np.array([f"zeile-{i}-é中"
                                     for i in range(30)]),
                "raw": np.array([b"k%d" % i for i in range(30)])}
    if kind == "tensor_bf16":                 # the checkpoint's uint16 view
        return {"tensor": rng.integers(0, 2**16, 5000).astype(np.uint16)}
    if kind == "tensor_f32":
        return {"tensor": rng.standard_normal((700,)).astype(np.float32)}
    if kind == "nan_only":
        return {"x": np.full(4, np.nan)}
    assert kind == "empty"
    return {"x": np.zeros(0, np.int32)}


COLUMN_KINDS = ("numeric", "strings", "tensor_bf16", "tensor_f32", "nan_only",
                "empty")
EXTRA = {"leaf": "params/blocks/s0/attn/wq", "global_shape": [2, 64, 4, 16],
         "dtype": "bfloat16", "offset": 4096, "nshards": 3,
         "neg": -70000, "big": 2**63 + 5, "pi": 3.25, "ok": True, "none": None,
         "nested": {"a": [1, 2.5, "x", b"\x00\x01"], "b": {}}}


def _frames(payload: bytes) -> list:
    """The msgpack frames of a CHK3 or CHK2 payload."""
    footer_off = int.from_bytes(payload[-12:-4], "little")
    frames = [payload[footer_off:-12]]
    if payload[:4] == b"CHK3":
        footer = msgpack.unpackb(frames[0], strict_map_key=False)
        frames.append(payload[4:footer["hdr_end"]])
    else:
        frames.append(payload[4:footer_off])
    return frames


@pytest.mark.parametrize("version", (3, 2))
@pytest.mark.parametrize("kind", COLUMN_KINDS)
def test_codec_bytes_equal_msgpack_on_chunk_frames(kind, version):
    payload, _, _ = jax_chunkfile.serialize_chunk(
        _columns(kind), extra=EXTRA, version=version)
    for frame in _frames(payload):
        obj = msgpack.unpackb(frame, strict_map_key=False)
        assert _msgpack.unpackb(frame, strict_map_key=False) == obj
        assert _msgpack.packb(obj) == frame


# ints at every encoding edge, str / bin / array / map at every length edge
EDGE_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**63 - 1, 2**63, 2**64 - 1, -1, -32, -33, -128, -129, -32768,
             -32769, -2**31, -2**31 - 1, -2**63]
EDGE_LENS = [0, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("obj", (
    [None, True, False, 0.0, -0.0, 1.5, float("inf"), 1e300] + EDGE_INTS
    + ["x" * n for n in EDGE_LENS] + [b"\xff" * n for n in EDGE_LENS]
    + [list(range(n)) for n in EDGE_LENS]
    + [{str(i): i for i in range(n)} for n in (0, 15, 16, 65535, 65536)]
    + [(1, "a"), bytearray(b"ab"), memoryview(b"cd"), {1: "int key"}]),
    ids=lambda o: type(o).__name__ + (f"{len(o)}" if hasattr(o, "__len__")
                                      else f"{o!r}"[:24]))
def test_codec_bytes_equal_msgpack_at_encoding_edges(obj):
    want = msgpack.packb(obj)
    assert _msgpack.packb(obj) == want
    assert _msgpack.unpackb(want, strict_map_key=False) == \
        msgpack.unpackb(want, strict_map_key=False)


def test_codec_rejects_what_msgpack_rejects():
    for bad in (np.int64(3), np.bool_(True), object()):
        with pytest.raises(TypeError):
            msgpack.packb(bad)
        with pytest.raises(TypeError):
            _msgpack.packb(bad)
    for big in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            _msgpack.packb(big)
    # numpy scalars go through the chunkfile's _scalar first
    assert _msgpack.packb(chunkfile._scalar(np.int64(-5))) == \
        msgpack.packb(jax_chunkfile._scalar(np.int64(-5)))
    assert _msgpack.packb(chunkfile._scalar(np.float32(0.5))) == \
        msgpack.packb(jax_chunkfile._scalar(np.float32(0.5)))
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb([1, 2]) + b"\x01")   # extra data
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb({1: 2}))             # strict keys
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb("abc")[:-1])         # truncated


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2**63, max_value=2**64 - 1)
            | st.floats(allow_nan=False) | st.text() | st.binary())
_values = st.recursive(
    _scalars, lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=8), inner, max_size=20),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_values)
def test_codec_bytes_equal_msgpack_on_drawn_values(obj):
    want = msgpack.packb(obj)
    assert _msgpack.packb(obj) == want
    assert _msgpack.unpackb(want, strict_map_key=False) == \
        msgpack.unpackb(want, strict_map_key=False)


# ------------------------------------------------------------------- chunks
@pytest.mark.parametrize("compress", (False, True))
@pytest.mark.parametrize("version", (3, 2))
@pytest.mark.parametrize("kind", COLUMN_KINDS)
def test_chunk_files_are_byte_identical_and_cross_readable(kind, version,
                                                           compress):
    cols = _columns(kind)
    root = tempfile.mkdtemp()
    kw = dict(partition_values={"step": "3"}, extra=EXTRA, compress=compress,
              version=version)
    meta_ref = jax_chunkfile.write_chunk(JaxLocalFS(), root, "ref.chunk",
                                         cols, **kw)
    meta_port = chunkfile.write_chunk(LocalFS(), root, "port.chunk", cols,
                                      **kw)
    with open(f"{root}/ref.chunk", "rb") as a, \
            open(f"{root}/port.chunk", "rb") as b:
        assert a.read() == b.read()
    assert meta_port.size_bytes == meta_ref.size_bytes
    assert meta_port.stats_dict() == meta_ref.stats_dict()
    # each package reads the other's file: whole, footer only, projected
    for name, read_chunk, footers, columns, fs in (
            ("ref.chunk", chunkfile.read_chunk, chunkfile.read_chunks_footers,
             chunkfile.read_chunks_columns, LocalFS()),
            ("port.chunk", jax_chunkfile.read_chunk,
             jax_chunkfile.read_chunks_footers,
             jax_chunkfile.read_chunks_columns, JaxLocalFS())):
        back, extra = read_chunk(fs, root, name)
        assert extra == EXTRA
        assert list(back) == list(cols)
        for k in cols:
            np.testing.assert_array_equal(back[k], cols[k])
            assert back[k].dtype == cols[k].dtype
        footer = footers(fs, root, [name])[0]
        assert footer.nrows == meta_ref.record_count
        assert {k: v.to_dict() for k, v in footer.stats.items()} == \
            meta_ref.stats_dict()
        first = list(cols)[:1]
        (proj, _), = columns(fs, root, [name], first)
        for k in first:
            np.testing.assert_array_equal(proj[k], cols[k])


def test_legacy_string_column_reads_in_the_port():
    arr = np.array(["a", "bb", "é"])
    raw = jax_chunkfile._encode_str_legacy(arr)
    assert chunkfile._encode_str_legacy(arr) == raw
    decl = {"dtype": "str", "shape": [3]}
    np.testing.assert_array_equal(chunkfile._decode_array(decl, raw), arr)


# -------------------------------------------------------------- translation
SALES = {"s_id": np.arange(1, 13, dtype=np.int64),
         "s_type": np.array(list("aabbccaabbcc")),
         "price": np.linspace(10.0, 120.0, 12)}


def _pkg(side: str) -> dict:
    if side == PORT:
        return dict(fs=LocalFS(), LakeTable=LakeTable, Schema=Schema,
                    Field=Field, PartitionSpec=PartitionSpec,
                    SyncConfig=SyncConfig, run_sync=run_sync)
    return dict(fs=JaxLocalFS(), LakeTable=JaxLakeTable, Schema=JaxSchema,
                Field=JaxField, PartitionSpec=JaxPartitionSpec,
                SyncConfig=JaxSyncConfig, run_sync=jax_run_sync)


def _write_and_sync(side: str, source: str) -> str:
    """A partitioned table with three commits (two appends and a delete)
    in ``source``, synced to the other two formats by ``side``."""
    p = _pkg(side)
    base = tempfile.mkdtemp() + "/sales"
    schema = p["Schema"]([p["Field"]("s_id", "int64"),
                          p["Field"]("s_type", "string"),
                          p["Field"]("price", "float64")])
    t = p["LakeTable"].create(p["fs"], base, schema, source,
                              p["PartitionSpec"](["s_type"]))
    t.append({k: v[:6] for k, v in SALES.items()})
    t.append({k: v[6:] for k, v in SALES.items()})
    from repro.lst.table import Predicate as JaxPredicate
    from repro_torch.lst.table import Predicate
    pred = (Predicate if side == PORT else JaxPredicate)("s_id", "==", 4)
    t.delete_where(pred)
    others = [f.upper() for f in FORMATS if f != source]
    results = p["run_sync"](p["SyncConfig"].from_dict({
        "sourceFormat": source.upper(), "targetFormats": others,
        "datasets": [{"tableBasePath": base}]}), p["fs"])
    assert all(r.ok for r in results), results
    return base


def _state_view(st) -> dict:
    return {"schema": [(f.name, f.type) for f in st.schema.fields],
            "partition": list(st.partition_spec.column_names()),
            "files": {p: (f.size_bytes, f.record_count,
                          dict(f.partition_values), f.stats_dict(),
                          dict(f.extra))
                      for p, f in st.files.items()}}


@pytest.mark.parametrize("source", FORMATS)
@pytest.mark.parametrize("writer", (REF, PORT))
def test_translated_tables_read_the_same_in_both_packages(writer, source):
    base = _write_and_sync(writer, source)
    for fmt in FORMATS:
        ref = JaxLakeTable.open(JaxLocalFS(), base, fmt)
        port = LakeTable.open(LocalFS(), base, fmt)
        assert _state_view(port.state()) == _state_view(ref.state())
        assert port.state().version == ref.state().version
        rows_ref, rows_port = ref.read_all(), port.read_all()
        order_ref = np.argsort(rows_ref["s_id"])
        order_port = np.argsort(rows_port["s_id"])
        for k in SALES:
            np.testing.assert_array_equal(rows_port[k][order_port],
                                          rows_ref[k][order_ref])
        assert sorted(rows_port["s_id"].tolist()) == \
            [i for i in range(1, 13) if i != 4]


def test_port_sync_is_incremental_over_a_reference_sync():
    """The reference syncs two commits, the port the third: the port's
    translation continues from the state the reference persisted."""
    base = tempfile.mkdtemp() + "/sales"
    schema = JaxSchema([JaxField("s_id", "int64"),
                        JaxField("s_type", "string"),
                        JaxField("price", "float64")])
    t = JaxLakeTable.create(JaxLocalFS(), base, schema, "hudi",
                            JaxPartitionSpec(["s_type"]))
    cfg = {"sourceFormat": "HUDI", "targetFormats": ["ICEBERG", "DELTA"],
           "datasets": [{"tableBasePath": base}]}
    t.append({k: v[:6] for k, v in SALES.items()})
    t.append({k: v[6:9] for k, v in SALES.items()})
    jax_run_sync(JaxSyncConfig.from_dict(cfg), JaxLocalFS())
    t.append({k: v[9:] for k, v in SALES.items()})
    results = run_sync(SyncConfig.from_dict(cfg), LocalFS())
    assert {r.mode for r in results} == {"INCREMENTAL"}
    for fmt in ("iceberg", "delta"):
        assert LakeTable.open(LocalFS(), base, fmt).state().total_records() \
            == 12


# -------------------------------------------------------------- checkpoints
def _ref_tree():
    rng = np.random.default_rng(5)
    return {
        "params": {
            "w32": jnp.asarray(rng.standard_normal((3, 5)), jnp.float32),
            "w16": jnp.asarray(rng.standard_normal((4, 2, 3)), jnp.bfloat16),
            "big": jnp.asarray(rng.standard_normal((64, 64)), jnp.float32),
            "blocks": {"s0": {"scale": jnp.ones((7,), jnp.float32)}},
        },
        "opt": {"step": jnp.asarray(12, jnp.int32),
                "mu": [jnp.zeros((2,), jnp.float32),
                       jnp.full((3,), 2.5, jnp.bfloat16)]},
    }


def _port_tree():
    gen = torch.Generator().manual_seed(5)
    return {
        "params": {
            "w32": torch.randn((3, 5), generator=gen),
            "w16": torch.randn((4, 2, 3), generator=gen).to(torch.bfloat16),
            "big": torch.randn((64, 64), generator=gen),
            "blocks": {"s0": {"scale": torch.ones(7)}},
            "ids": torch.arange(10, dtype=torch.int32).reshape(2, 5),
        },
        "opt": {"step": torch.tensor(12, dtype=torch.int64),
                "mu": [torch.zeros(2), torch.full((3,), 2.5,
                                                  dtype=torch.bfloat16)]},
    }


def _bits(x) -> tuple:
    """(dtype name, shape, raw bytes) of a tensor or array, bf16 as uint16."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, tuple(t.shape), t.numpy().tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


@pytest.mark.parametrize("fmt", FORMATS)
def test_reference_checkpoint_restores_bit_identical_in_the_port(fmt,
                                                                 monkeypatch):
    monkeypatch.setattr(jax_manager, "MAX_CHUNK_BYTES", 1024)
    base = tempfile.mkdtemp() + "/ckpt"
    tree = _ref_tree()
    mgr = jax_manager.LSTCheckpointManager(JaxLocalFS(), base, fmt=fmt,
                                           sync_targets=FORMATS)
    mgr.save(2, jax.tree.map(lambda x: x * 0, tree))
    mgr.save(4, tree, extra_meta={"loader.row": "17"})
    assert len([f for f in mgr.handle.snapshot().files.values()
                if f.extra["leaf"] == "params/big"]) == 32      # 16 per step
    want = dict(jax_manager._leaf_paths(tree))
    for view in FORMATS:
        port = LSTCheckpointManager(LocalFS(), base, fmt=view,
                                    sync_targets=())
        assert port.steps() == [2, 4]
        step, flat = port.restore(fmt=view)
        assert step == 4
        assert sorted(flat) == sorted(want)
        for name, leaf in want.items():
            assert _bits(flat[name]) == _bits(leaf), (view, name)
        ref = jax_manager.LSTCheckpointManager(JaxLocalFS(), base, fmt=view,
                                               sync_targets=())
        assert port.latest_meta() == ref.latest_meta()


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_checkpoint_restores_bit_identical_in_the_reference(fmt,
                                                                 monkeypatch):
    monkeypatch.setattr(manager, "MAX_CHUNK_BYTES", 1024)
    base = tempfile.mkdtemp() + "/ckpt"
    tree = _port_tree()
    mgr = LSTCheckpointManager(LocalFS(), base, fmt=fmt, sync_targets=FORMATS)
    mgr.save(4, tree)
    assert len([f for f in mgr.handle.snapshot().files.values()
                if f.extra["leaf"] == "params/big"]) == 16
    template = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), jnp.float32), tree)
    for view in FORMATS:
        ref = jax_manager.LSTCheckpointManager(JaxLocalFS(), base, fmt=view,
                                               sync_targets=())
        step, back = ref.restore_pytree(template, fmt=view)
        assert step == 4
        got = dict(jax_manager._leaf_paths(back))
        for name, leaf in leaf_paths(tree):
            assert _bits(got[name]) == _bits(leaf), (view, name)


def test_port_checkpoint_round_trips_in_the_port(monkeypatch):
    """save -> restore_pytree in the port (MemoryFS, sharded, re-saved
    step, GC), on the CPU."""
    monkeypatch.setattr(manager, "MAX_CHUNK_BYTES", 1024)
    fs = MemoryFS()
    mgr = LSTCheckpointManager(fs, "mem/ckpt", fmt="hudi",
                               sync_targets=("iceberg",), keep_last=1)
    tree = _port_tree()
    mgr.save(1, tree)
    mgr.save(1, tree)                                 # a replace-commit
    mgr.save(2, tree)
    assert mgr.gc() == [1]
    assert mgr.steps() == mgr.steps("iceberg") == [2]
    step, back = mgr.restore_pytree(tree, fmt="iceberg", device="cpu")
    assert step == 2
    for (name, a), (name_b, b) in zip(leaf_paths(tree), leaf_paths(back)):
        assert name == name_b and _bits(a) == _bits(b)
    assert isinstance(back["opt"]["mu"], list)
    bad = {"params": {"w32": torch.zeros(5, 3)}}
    with pytest.raises(ValueError, match="shape"):
        mgr.restore_pytree(bad, device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore_pytree({"nope": torch.zeros(1)}, device="cpu")


@pytest.mark.parametrize("arch", ("yi-9b", "mamba2-2.7b"))
def test_leaf_walker_gives_reference_names_and_order(arch):
    jm = JaxModel(jax_smoke_config(arch))
    tm = Model(smoke_config(arch), device="cpu")
    want = [(n, tuple(s.shape)) for n, s in jax_manager._leaf_paths(
        {"params": template_shapes(jm.param_template())})]
    got = [(n, tuple(s.shape)) for n, s in leaf_paths(
        {"params": tm.param_template()})]
    assert got == want
    mixed = {"b": [1, (2, None, {"z": 3, "a": 4})], "a": None, "c": {},
             "d": np.zeros(2)}
    got = leaf_paths(mixed)
    want = jax_manager._leaf_paths(mixed)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [id(x) for _, x in got] == [id(x) for _, x in want]


def test_full_width_leaf_names_match_reference():
    """The names at full width and depth (from templates, nothing
    allocated) are those a full-size checkpoint carries."""
    for arch in ("yi-9b", "mamba2-2.7b"):
        from repro.configs import get_config as jax_get_config
        from repro_torch.configs import get_config
        jm = JaxModel(jax_get_config(arch))
        tm = Model(get_config(arch), device="cpu")
        want = [(n, tuple(s.shape)) for n, s in jax_manager._leaf_paths(
            {"params": template_shapes(jm.param_template())})]
        got = [(n, tuple(s.shape)) for n, s in leaf_paths(
            {"params": tm.param_template()})]
        assert got == want


def test_lake_paths_run_without_msgpack_or_ml_dtypes():
    """A port checkpoint saved, synced and restored in a process where
    ``msgpack``, ``ml_dtypes`` and ``jax`` cannot be imported, as on a
    machine that has only the port's dependencies."""
    import subprocess
    import sys
    import textwrap
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    probe = textwrap.dedent("""
        import sys, tempfile
        for m in ("jax", "msgpack", "ml_dtypes"):
            sys.modules[m] = None
        import torch
        from repro_torch.checkpoint import LSTCheckpointManager
        from repro_torch.lst import LocalFS
        base = tempfile.mkdtemp() + "/ckpt"
        tree = {"w": torch.arange(6, dtype=torch.float32).to(torch.bfloat16),
                "s": {"x": torch.ones(3)}}
        LSTCheckpointManager(LocalFS(), base, fmt="hudi").save(0, tree)
        for fmt in ("iceberg", "delta", "hudi"):
            mgr = LSTCheckpointManager(LocalFS(), base, fmt=fmt,
                                       sync_targets=())
            _, back = mgr.restore_pytree(tree, device="cpu")
            assert torch.equal(back["w"], tree["w"]), fmt
            assert back["w"].dtype == torch.bfloat16
            assert torch.equal(back["s"]["x"], tree["s"]["x"]), fmt
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    r = subprocess.run([sys.executable, "-c", probe], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr
