"""The port's ``ServeEngine.from_lake`` against the reference's, on one
lake checkpoint: the reference trains nothing but saves its smoke
parameters as a Hudi checkpoint table synced to Iceberg and Delta, and
both engines restore them through a translated view and serve the same
prompts.  Greedy tokens must be equal; the restored weights bit-equal.

The smoke configs run in fp32 (``vocab_size=256`` as in
``tests/test_integration_e2e.py``), as the other engine parity tests do.
"""

import tempfile
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import LSTCheckpointManager as JaxManager  # noqa: E402
from repro.checkpoint.manager import _leaf_paths as jax_leaf_paths  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.lst import LocalFS as JaxLocalFS  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.checkpoint import LSTCheckpointManager, leaf_paths  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import MetadataCache  # noqa: E402
from repro_torch.lst import LocalFS  # noqa: E402
from repro_torch.lst.catalog import Catalog, TablePointer, ViewRef  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import Request, ServeEngine, SnapshotServer  # noqa: E402

torch.set_num_threads(2)

PROMPTS = ([5, 6, 7], [1, 2], [9, 8, 7, 6, 5], [200, 3, 44])
MAX_NEW = (6, 3, 5, 4)
CACHE = 48


def _reqs(cls):
    return [cls(list(p), n) for p, n in zip(PROMPTS, MAX_NEW)]


def _world(arch: str) -> dict:
    """The reference's smoke params of ``arch`` saved as step 7 of a Hudi
    checkpoint synced to Iceberg and Delta, and the reference engine's
    tokens served from its Iceberg view."""
    jcfg = replace(jax_smoke_config(arch), vocab_size=256, dtype="float32")
    jm = JaxModel(jcfg)
    jp = jax_init_params(jm.param_template(), jax.random.PRNGKey(1))
    root = tempfile.mkdtemp()
    path = f"{root}/ckpt"
    JaxManager(JaxLocalFS(), path, fmt="hudi",
               sync_targets=("iceberg", "delta")).save(7, {"params": jp})
    want = JaxServeEngine.from_lake(jm, JaxLocalFS(), path, fmt="iceberg",
                                    cache_len=CACHE).generate(
        _reqs(JaxRequest))
    tm = Model(replace(smoke_config(arch), vocab_size=256, dtype="float32"),
               device="cpu")
    return dict(root=root, path=path, jm=jm, jp=jp, tm=tm, want=want)


@pytest.fixture(scope="module")
def yi():
    return _world("yi-9b")


def _bits(t) -> bytes:
    return np.asarray(t).tobytes() if not isinstance(t, torch.Tensor) \
        else t.detach().cpu().numpy().tobytes()


def _assert_weights_equal(engine, jp):
    got = leaf_paths(engine.params)
    want = jax_leaf_paths(jp)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.device.type == "cpu" and a.dtype == torch.float32, name
        assert _bits(a) == _bits(b), name


@pytest.mark.parametrize("fmt", ("iceberg", "delta", "hudi"))
def test_from_lake_by_path_serves_reference_tokens(yi, fmt):
    eng = ServeEngine.from_lake(yi["tm"], LocalFS(), yi["path"], fmt=fmt,
                                cache_len=CACHE)
    _assert_weights_equal(eng, yi["jp"])
    assert eng.generate(_reqs(Request)) == yi["want"]
    assert [len(o) for o in yi["want"]] == list(MAX_NEW)


def test_from_lake_through_read_plane_serves_reference_tokens(yi):
    fs = LocalFS()
    server = SnapshotServer(fs)
    eng = ServeEngine.from_lake(yi["tm"], fs, yi["path"], fmt="iceberg",
                                cache_len=CACHE, read_plane=server)
    _assert_weights_equal(eng, yi["jp"])
    assert eng.generate(_reqs(Request)) == yi["want"]
    assert server.stats.reads >= 1


def _register(fs, yi, name: str, fmt: str = "iceberg"):
    """A catalog pointer at the current ``fmt`` head of the checkpoint
    (as ``tests/test_integration_e2e.py`` registers one) and a read plane
    on the same metadata cache."""
    cache = MetadataCache(fs)
    idx = cache.index(fmt, yi["path"])
    token = idx.probe()
    idx.refresh_to(token)
    head, _state = idx.pinned_state()
    idx.end_cycle()
    catalog = Catalog(fs, tempfile.mkdtemp() + "/catalog")
    catalog.register_table(
        TablePointer(name=name, base_path=yi["path"], source_format=fmt,
                     views={fmt: ViewRef(token, head)}),
        group="serving")
    return catalog, SnapshotServer(fs, cache=cache)


def test_from_lake_by_catalog_name_serves_reference_tokens(yi):
    fs = LocalFS()
    catalog, server = _register(fs, yi, "yi-9b-ckpt")
    eng = ServeEngine.from_lake(yi["tm"], fs, fmt="iceberg", cache_len=CACHE,
                                read_plane=server, catalog=catalog,
                                table="yi-9b-ckpt")
    _assert_weights_equal(eng, yi["jp"])
    assert eng.generate(_reqs(Request)) == yi["want"]
    # without a read plane the name still resolves (live head, same step)
    eng2 = ServeEngine.from_lake(yi["tm"], fs, fmt="iceberg",
                                 cache_len=CACHE, catalog=catalog,
                                 table="yi-9b-ckpt")
    assert eng2.generate(_reqs(Request)) == yi["want"]


def test_from_lake_by_catalog_name_stays_pinned_at_the_published_head():
    """A later save lands and syncs after the catalog published step 7:
    the name-based restore through the read plane still serves step 7."""
    world = _world("yi-9b")
    fs = LocalFS()
    catalog, server = _register(fs, world, "pinned")
    later = jax.tree.map(lambda x: x * 0.5, world["jp"])
    JaxManager(JaxLocalFS(), world["path"], fmt="hudi",
               sync_targets=("iceberg", "delta")).save(8, {"params": later})
    pinned = ServeEngine.from_lake(world["tm"], fs, fmt="iceberg",
                                   cache_len=CACHE, read_plane=server,
                                   catalog=catalog, table="pinned")
    _assert_weights_equal(pinned, world["jp"])
    live = ServeEngine.from_lake(world["tm"], fs, world["path"],
                                 fmt="iceberg", cache_len=CACHE)
    _assert_weights_equal(live, later)


def test_from_lake_argument_errors(yi):
    fs = LocalFS()
    catalog, _ = _register(fs, yi, "named")
    with pytest.raises(ValueError, match="table=<name>"):
        ServeEngine.from_lake(yi["tm"], fs, catalog=catalog)
    with pytest.raises(ValueError, match="need ckpt_path"):
        ServeEngine.from_lake(yi["tm"], fs)


def test_reference_serves_a_checkpoint_the_port_saved(yi):
    """The other direction: the port saves the same weights (as its own
    tensors) and the reference engine restores them from the Delta view."""
    path = tempfile.mkdtemp() + "/ckpt"
    tp = params_from_jax(jax.tree.map(np.asarray, yi["jp"]), device="cpu")
    LSTCheckpointManager(LocalFS(), path, fmt="hudi").save(7, {"params": tp})
    got = JaxServeEngine.from_lake(yi["jm"], JaxLocalFS(), path, fmt="delta",
                                   cache_len=CACHE).generate(
        _reqs(JaxRequest))
    assert got == yi["want"]


def test_mamba2_from_lake_serves_reference_tokens():
    world = _world("mamba2-2.7b")
    eng = ServeEngine.from_lake(world["tm"], LocalFS(), world["path"],
                                fmt="iceberg", cache_len=CACHE)
    _assert_weights_equal(eng, world["jp"])
    assert eng.generate(_reqs(Request)) == world["want"]
