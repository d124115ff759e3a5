"""The port's launch tooling on the CPU: the kernel formulas, the cells'
arithmetic against the reference's, the cost counter and the dry run.

The dry run joins a fake process group, which is process-global, so its
cells run in a subprocess (the CLI) with a time limit; the records it
writes are then read here.  The counter on an unsharded ``meta`` model
needs no group.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import cells as jax_cells  # noqa: E402
from repro.models.config import get_shape_cell as jax_get_shape_cell  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.train.loop import train_state_template as jax_train_state  # noqa: E402
from repro_torch.configs import ARCHS, get_config, smoke_config  # noqa: E402
from repro_torch.device import DTYPES  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.launch import cells, cost, roofline  # noqa: E402
from repro_torch.models.config import SHAPE_CELLS, ShapeCell  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.parallel import Sharder  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod1": {"data": 16, "model": 16},
          "pod2": {"pod": 2, "data": 16, "model": 16}}


def _meshes(axes: dict):
    names, sizes = tuple(axes), tuple(axes.values())
    return (SimpleNamespace(axis_names=names,
                            devices=SimpleNamespace(shape=sizes)),
            SimpleNamespace(mesh_dim_names=names, shape=sizes))


# --------------------------------------------------------- kernel formulas
def test_kernel_formulas_give_perf_md_numbers():
    """The bounds of PERF.md's kernel table at the served shapes."""
    flops, _ = cost.flash_work(4, 2048, 2048, 32, 4, 128, True, 0)
    assert f"{flops:.4g}" == "1.375e+11"
    # chip_smoke's decode lengths: its first draw from default_rng(seed 0)
    lengths = np.random.default_rng(0).integers(2049, 2080, 4)
    _, nbytes = cost.decode_work(int(lengths.sum()), 4, 32, 4, 128)
    assert round(nbytes / 1e6, 2) == 16.99
    _, nbytes = cost.ssd_work(4, 2048, 80, 64, 1, 128, 256)      # mamba2
    assert round(nbytes / 1e6, 2) == 185.07
    _, nbytes = cost.ssd_work(4, 2048, 8192, 1, 1, 16, 16)       # jamba
    assert round(nbytes / 1e6, 1) == 539.5
    # the backward: 2.5x the forward's products
    bwd, _ = cost.flash_bwd_work(4, 2048, 2048, 32, 4, 128, True, 0)
    assert bwd == 2.5 * flops


def test_flash_visible_pairs_counts_masks():
    assert cost.flash_visible_pairs(4, 4, True, 0) == 10
    assert cost.flash_visible_pairs(4, 4, False, 0) == 16
    assert cost.flash_visible_pairs(5, 5, True, 2) == 9
    assert cost.flash_visible_pairs(2, 6, False, 0) == 12


# ------------------------------------------------- cells' arithmetic
@pytest.mark.parametrize("arch", ARCHS)
def test_counted_params_and_attention_bytes_equal_the_reference(arch):
    assert cells._counted_params(Model(get_config(arch), device="cpu")) == \
        jax_cells._counted_params(JaxModel(jax_get_config(arch)))
    for axes in MESHES.values():
        ref_mesh, port_mesh = _meshes(axes)
        for cell in SHAPE_CELLS:
            want = jax_cells.attn_intermediate_bytes(
                jax_cells._arch_cfg(arch, cell.name),
                jax_get_shape_cell(cell.name),
                jax_cells.make_cell_sharder(ref_mesh, arch, cell.name))
            got = cells.attn_intermediate_bytes(
                cells._arch_cfg(arch, cell.name), cell,
                cells.make_cell_sharder(port_mesh, arch, cell.name))
            assert got == want
            assert cells.is_applicable(arch, cell.name) == \
                jax_cells.is_applicable(arch, cell.name)


# ------------------------------------------------------------- the counter
def test_counter_on_a_dense_smoke_prefill():
    """Counted dot FLOPs of yi-9b's smoke prefill on ``meta``: the
    projections (2 N per token, the head at the last position only) plus
    the attention pairs, within 1%; the flash operator counted once a
    layer and launched nothing."""
    cfg = smoke_config("yi-9b")
    b, s = 2, 64
    cb = cells.build_step(cfg, ShapeCell("t", "prefill", s, b),
                          Sharder.null())
    launches = flash_attention.launches
    _, c = cost.analyze(cb.fn, *cb.args)
    d, V = cfg.d_model, cfg.vocab_size
    n_layer = (d * cfg.n_heads * cfg.head_dim * 2
               + d * cfg.n_kv_heads * cfg.head_dim * 2
               + d * cfg.d_ff * (3 if cfg.gated else 2))
    pairs = cost.flash_visible_pairs(s, s, True, 0)
    want = (2.0 * b * s * n_layer * cfg.n_layers + 2.0 * b * d * V
            + 4.0 * b * cfg.n_heads * cfg.head_dim * pairs * cfg.n_layers)
    assert abs(c["dot_flops"] - want) <= 0.01 * want, (c["dot_flops"], want)
    assert c["kernels"]["flash_attention"]["calls"] == cfg.n_layers
    assert c["n_collectives"] == 0 and c["hbm_bytes"] > 0
    assert flash_attention.launches == launches


def test_counter_sees_the_ssd_and_decode_kernels():
    cfg = smoke_config("mamba2-2.7b")
    cb = cells.build_step(cfg, ShapeCell("t", "prefill", 32, 2),
                          Sharder.null())
    _, c = cost.analyze(cb.fn, *cb.args)
    ssm = cfg.ssm
    want = cost.ssd_work(2, 32, ssm.n_heads, ssm.head_dim, ssm.n_groups,
                         ssm.d_state, ssm.chunk,
                         DTYPES[cfg.dtype].itemsize)
    assert c["kernels"]["ssd_chunk_scan"] == {
        "calls": cfg.n_layers, "flops": cfg.n_layers * want[0],
        "bytes": cfg.n_layers * want[1]}
    cfg = replace(smoke_config("yi-9b"), dtype="bfloat16")
    cb = cells.build_step(cfg, ShapeCell("t", "decode", 40, 2),
                          Sharder.null())
    _, c = cost.analyze(cb.fn, *cb.args)
    want = cost.decode_work(2 * 40, 2, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim)
    assert c["kernels"]["decode_attention"]["flops"] == \
        cfg.n_layers * want[0]


def test_counter_frees_temporaries():
    counter = cost.CostCounter()
    with counter:
        for _ in range(3):
            x = torch.empty((1024, 1024), device="meta")
            y = x + 1
            del x, y
    assert counter.peak == 2 * 1024 * 1024 * 4
    assert counter.live == 0
    assert counter.elem_flops == 3 * 1024 * 1024


# ------------------------------------------------------------ the roofline
def test_from_record_on_a_hand_made_record():
    rec = {"ok": True, "arch": "a", "shape": "train_4k", "mesh": "pod1",
           "step": "train_step", "n_active_params": 1_000_000,
           "tokens_per_step": 256 * 4096,
           "cost": {"flops": 989e12, "hbm_bytes": 3.35e12 / 2,
                    "coll_nvlink_bytes": 450e9 / 4,
                    "coll_net_bytes": 50e9 * 2},
           "memory": {"peak_bytes_est": 2**31}}
    r = roofline.from_record(rec)
    assert (r.compute_s, r.memory_s, r.nvlink_s, r.net_s) == \
        (1.0, 0.5, 0.25, 2.0)
    assert r.dominant == "net" and r.step_time_s == 2.0
    assert r.memory_kernel_s == r.memory_s
    assert r.roofline_frac == 0.5 and r.mem_gib == 2.0
    want = 6.0 * 1_000_000 * 256 * 4096 / 256
    assert r.model_flops_dev == want
    assert r.mfu == want / (2.0 * roofline.PEAK_FLOPS)
    assert roofline.from_record({"ok": False}) is None
    assert "net" in roofline.table([rec]) and rec["arch"] in \
        roofline.table([rec])
    both = roofline.meshes_table(
        [rec, dict(rec, mesh="pod2", ok=False),
         {"arch": "a", "shape": "long_500k", "mesh": "pod1", "skipped": True}])
    assert "| a | train_4k | train | 2.00 | 9.890e+14 |" in both
    assert "| FAIL |" in both and both.endswith("a x long_500k.")


# ------------------------------------------------------------- the dry run
def _dryrun(tmp_path, *args) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(tmp_path), *args], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]


@pytest.fixture(scope="module")
def dryrun_records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    _dryrun(tmp, "--arch", "yi-9b", "--shape", "all", "--mesh", "single")
    _dryrun(tmp, "--arch", "mamba2-2.7b", "--shape", "long_500k", "--mesh",
            "single")
    _dryrun(tmp, "--arch", "granite-moe-3b-a800m", "--shape", "all",
            "--mesh", "single")
    return {p.stem: json.loads(p.read_text()) for p in tmp.glob("*.json")}


@pytest.mark.parametrize("name", [
    "yi-9b__train_4k__pod1", "yi-9b__prefill_32k__pod1",
    "yi-9b__decode_32k__pod1", "mamba2-2.7b__long_500k__pod1",
    "granite-moe-3b-a800m__prefill_32k__pod1",
    "granite-moe-3b-a800m__train_4k__pod1",
    "granite-moe-3b-a800m__decode_32k__pod1"])
def test_dryrun_cells_write_ok_records(dryrun_records, name):
    rec = dryrun_records[name]
    assert rec["ok"], rec.get("error")
    c = rec["cost"]
    assert c["flops"] > 0 and c["hbm_bytes"] > 0 and c["n_collectives"] > 0
    assert rec["memory"]["peak_bytes_est"] > rec["memory"]["argument_bytes"]
    # CommDebugMode's census and the counter's agree on the kinds counted
    counts = {k.split(".")[-1]: v for k, v in rec["comm_counts"].items()}
    kinds = {"all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_reduce": "all-reduce", "all_to_all_single": "all-to-all"}
    assert {kinds[k] for k in counts if k in kinds} == set(c["coll_by_kind"])
    assert roofline.from_record(rec).step_time_s > 0
    assert dryrun_records["yi-9b__long_500k__pod1"]["skipped"]


def test_granite_train_cell_fits_the_einsum_combine_count(dryrun_records):
    """granite x train_4k on (data 16, model 16) counts at most 65.97 GiB
    a device, what the MoE combine's einsum on whole tensors counted (an
    H100 holds 80 GB): ``moe_mlp`` dispatches and combines each rank's own
    rows (``Sharder.local_call``), where DTensor's gather backward held
    whole (G, E C + 1, d) tensors on every rank (115.36 GiB).  Its other
    cells stay ok, long_500k not applicable."""
    cells_of = {shape: dryrun_records[f"granite-moe-3b-a800m__{shape}__pod1"]
                for shape in ("train_4k", "prefill_32k", "decode_32k",
                              "long_500k")}
    assert cells_of["train_4k"]["memory"]["peak_bytes_est"] \
        <= 65.97 * 2**30
    assert all(cells_of[s]["ok"] for s in ("train_4k", "prefill_32k",
                                           "decode_32k"))
    assert cells_of["long_500k"]["skipped"]


def test_dryrun_argument_bytes_equal_the_reference_specs(dryrun_records):
    """yi-9b train_4k on (data 16, model 16): this device's argument bytes
    (params, AdamW state, batch) equal the local shard sizes the
    reference's specs give."""
    ref_mesh, _ = _meshes(MESHES["pod1"])
    sh = jax_cells.make_cell_sharder(ref_mesh, "yi-9b", "train_4k")
    model = JaxModel(jax_get_config("yi-9b"), sh)
    params, opt = jax_train_state(model)
    pspecs = sh.template_pspecs(model.param_template())
    cell = jax_get_shape_cell("train_4k")
    tok = jax.ShapeDtypeStruct((cell.global_batch, cell.seq_len), "int32")
    tok_spec = sh.resolve(("batch", "seq"), tok.shape)

    def local_bytes(x, spec) -> int:
        n = 1
        for dim, entry in zip(x.shape, tuple(spec) + (None,) * x.ndim):
            axes = entry if isinstance(entry, tuple) else \
                ((entry,) if entry else ())
            n *= dim // int(np.prod([sh.mesh_axes[a] for a in axes]))
        return n * x.dtype.itemsize

    want = sum(jax.tree.leaves(jax.tree.map(local_bytes, params, pspecs)))
    for k in ("m", "v", "master"):
        want += sum(jax.tree.leaves(jax.tree.map(local_bytes, opt[k],
                                                 pspecs)))
    want += 4 + 2 * local_bytes(tok, tok_spec)
    rec = dryrun_records["yi-9b__train_4k__pod1"]
    assert rec["memory"]["argument_bytes"] == want
