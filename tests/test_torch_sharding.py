"""The port's ``Sharder`` against the reference's, on the CPU.

Resolution is pure arithmetic, so specs must equal the reference's entry
for entry: the reference's resolver cases, and every leaf of every arch's
param, train-state and cache templates on both production meshes
({data: 16, model: 16} and {pod: 2, data: 16, model: 16}) under each
cell's rule overrides.  Meshes here are stand-ins carrying only axis names
and sizes (the reference reads ``axis_names`` / ``devices.shape``, the port
``mesh_dim_names`` / ``shape``): resolution needs no process group.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.cells import make_cell_sharder as jax_make_cell_sharder  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.param import is_spec  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch.cells import make_cell_sharder  # noqa: E402
from repro_torch.models.config import SHAPE_CELLS  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.parallel import P, Sharder, placements  # noqa: E402
from repro_torch.train.loop import train_state_template  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

torch.set_num_threads(2)

MESHES = {"pod1": {"data": 16, "model": 16},
          "pod2": {"pod": 2, "data": 16, "model": 16}}


def _meshes(axes: dict):
    """(reference-style, port-style) stand-ins of a mesh of ``axes``."""
    names, sizes = tuple(axes), tuple(axes.values())
    ref = SimpleNamespace(axis_names=names,
                          devices=SimpleNamespace(shape=sizes))
    port = SimpleNamespace(mesh_dim_names=names, shape=sizes)
    return ref, port


# --------------------------------------------- the reference's resolver cases
def test_sharder_divisibility_fallback():
    sh = Sharder({"data": 16, "model": 16})
    # kv=4 cannot shard 16 ways -> replicated
    assert sh.resolve(("embed", "kv_heads", "head_dim"),
                      (4096, 4, 128)) == P("data")
    # heads=32 shard over model
    assert sh.resolve(("embed", "heads", "head_dim"),
                      (4096, 32, 128)) == P("data", "model")


def test_sharder_duplicate_axis_avoidance():
    sh = Sharder({"data": 16, "model": 16})
    # experts takes model; mlp then cannot reuse it
    assert sh.resolve(("experts", "embed", "mlp"),
                      (16, 6144, 10752)) == P("model", "data")
    # 40 experts: unshardable -> mlp gets model instead
    assert sh.resolve(("experts", "embed", "mlp"),
                      (40, 1536, 512)) == P(None, "data", "model")


def test_sharder_batch_multi_axis():
    sh = Sharder({"pod": 2, "data": 16, "model": 16})
    assert sh.resolve(("batch", "seq"), (256, 4096)) == P(("pod", "data"))
    # batch=1 (long_500k): replicate
    assert sh.resolve(("batch",), (1,)) == P()


def test_sharder_null_noop():
    sh = Sharder.null()
    x = torch.ones((4, 4))
    assert sh(x, "batch", "seq") is x
    assert sh.local_call(lambda t: t, [(x, ("batch", "seq"))],
                         [(("batch", "seq"), x.shape)]) is x
    tpl = Model(get_config("yi-9b"), device="cpu").cache_template(2, 8)
    assert sh.full((2, 3), ("batch", None), 7, torch.int32, "cpu") \
        .eq(7).all()
    assert sh.distribute({"a": x}, tpl) == {"a": x}


# ------------------------------------------------- parity on every template
def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _jax_specs(sh, tpl) -> dict:
    specs = sh.template_pspecs(tpl)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(k.key for k in path): tuple(s) for path, s in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_template_specs_equal_the_reference(arch):
    """Every leaf of the param, train-state and cache templates (each shape
    cell's batch and length), on both meshes, under the cell's overrides:
    0 leaves whose spec differs."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jmodel, model = JaxModel(jcfg), Model(cfg, device="cpu")
    jptpl = jmodel.param_template()
    ptpl, otpl = train_state_template(model)
    compared, differ = 0, []
    for mesh_name, axes in MESHES.items():
        ref_mesh, port_mesh = _meshes(axes)
        for cell in SHAPE_CELLS:
            jsh = jax_make_cell_sharder(ref_mesh, arch, cell.name)
            sh = make_cell_sharder(port_mesh, arch, cell.name)
            assert sh.rules == jsh.rules
            b, s = cell.global_batch, cell.seq_len
            pairs = [(jptpl, ptpl),
                     (jmodel.cache_template(b, s), model.cache_template(b, s))]
            for jtpl, tpl in pairs:
                want = _jax_specs(jsh, jtpl)
                got = {path: tuple(spec) for path, spec in
                       _leaves(sh.template_pspecs(tpl))}
                assert got.keys() == want.keys()
                differ += [(mesh_name, cell.name, p) for p in want
                           if got[p] != want[p]]
                compared += len(want)
            # the optimizer state's m / v / master take the params' specs
            opt = sh.template_pspecs(otpl)
            assert opt["m"] == opt["v"] == opt["master"] == \
                sh.template_pspecs(ptpl)
            assert opt["step"] == P()
    n_ref = sum(1 for _ in jax.tree_util.tree_leaves(jptpl, is_leaf=is_spec))
    assert compared >= 2 * len(SHAPE_CELLS) * n_ref
    assert differ == []


# ------------------------------------------------------------ placements
def test_placements_multi_axis_batch():
    _, mesh = _meshes(MESHES["pod2"])
    sh = Sharder({"pod": 2, "data": 16, "model": 16})
    spec = sh.resolve(("batch", "seq", "heads", None), (256, 4096, 32, 128))
    assert spec == P(("pod", "data"), None, "model")
    assert placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    # a dim's axes must come in the mesh's order (major first)
    with pytest.raises(ValueError):
        placements(P(("data", "pod")), mesh)


def test_resolve_matches_reference_on_random_axes():
    """Random logical-axis tuples and shapes: the same spec as the
    reference's resolver, with and without a cell's overrides."""
    from repro.parallel.sharding import Sharder as JaxSharder
    rng = np.random.default_rng(0)
    names = [n for n in Sharder({}).rules] + ["unknown"]
    for axes in MESHES.values():
        for rules in ({}, {"batch": (("pod", "data", "model"),
                                     ("pod", "data")), "embed": ()}):
            jsh = JaxSharder(dict(axes))
            jsh.rules.update(rules)
            sh = Sharder(dict(axes))
            sh.rules.update(rules)
            for _ in range(200):
                n = int(rng.integers(1, 5))
                ax = tuple(names[i] for i in rng.integers(0, len(names), n))
                shape = tuple(int(x) for x in rng.choice(
                    [1, 2, 4, 8, 12, 16, 24, 32, 40, 64, 256, 4096], n))
                assert tuple(sh.resolve(ax, shape)) == \
                    tuple(jsh.resolve(ax, shape)), (ax, shape)
