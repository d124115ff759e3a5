"""Multi-pod dry run: run every (arch x shape x mesh) cell once on ``meta``
DTensors under a fake process group of 256 or 512 ranks, and count it.

Per cell this shows:
* the sharding is coherent (every op of the step has a DTensor rule, and
  the kernels get the local shards they take),
* the per-device memory (argument bytes exact from the placements; the
  step's temporary peak from the live storages ``launch.cost`` tracks),
* and the roofline's raw terms per device (FLOPs, HBM bytes, collective
  bytes by kind and reach) from ``launch.cost.CostCounter``, with the
  collective counts of ``CommDebugMode`` beside them.

Nothing touches a GPU: the tensors are ``meta`` and the mesh's device type
is ``cpu``.  Results land in ``experiments/dryrun_torch/<arch>__<shape>__
<mesh>.json``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID|all]
        [--shape NAME|all] [--mesh single|multi|both] [--out DIR]
        [--grad-accum N]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch.distributed as dist
from torch.distributed.tensor.debug import CommDebugMode
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import ARCHS
from repro_torch.launch.cells import build_cell, is_applicable
from repro_torch.launch.cost import analyze
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPE_CELLS


def _fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks (this process is rank 0),
    replacing one of another size."""
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _nbytes(tree) -> int:
    """This device's bytes of the tensors in a (nested) result."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    local = tree.to_local() if hasattr(tree, "to_local") else tree
    return local.numel() * local.element_size()


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             grad_accum: int = 1, save: bool = True,
             overrides=None) -> dict:
    mesh_name = "pod2" if multi_pod else "pod1"
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "ok": False}
    ok, why = is_applicable(arch, shape)
    if not ok:
        rec.update({"skipped": True, "reason": why})
        if save:
            _save(out_dir, rec)
        return rec
    t0 = time.time()
    try:
        _fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        cb = build_cell(arch, shape, mesh, grad_accum=grad_accum)
        if overrides:
            cb = overrides(cb)
        t1 = time.time()
        with CommDebugMode() as comm:
            out, cost = analyze(cb.fn, *cb.args)
        t2 = time.time()
        args = cb.argument_bytes
        # the train step updates params and state in place, the decode
        # step its cache: those results alias arguments
        alias = {"train_step": _nbytes(cb.args[:2]),
                 "serve_step": _nbytes(cb.args[1])}.get(cb.step_name, 0)
        rec.update({
            "ok": True,
            "step": cb.step_name,
            "n_params": cb.n_params,
            "n_active_params": cb.n_active_params,
            "attn_hbm_bytes": cb.attn_hbm_bytes,
            "tokens_per_step": cb.cell.global_batch *
            (cb.cell.seq_len if cb.cell.step != "decode" else 1),
            "build_s": round(t1 - t0, 2),
            "run_s": round(t2 - t1, 2),
            "memory": {
                "argument_bytes": args,
                "output_bytes": _nbytes(out),
                "temp_bytes": cost["temp_peak_bytes"],
                "alias_bytes": alias,
                "peak_bytes_est": args + cost["temp_peak_bytes"],
            },
            "comm_counts": {str(k): v
                            for k, v in comm.get_comm_counts().items()},
            "cost": cost,
        })
    except Exception as e:  # record the failure, keep sweeping
        rec.update({"error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:]})
    if save:
        _save(out_dir, rec)
    return rec


def _save(out_dir: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def summarize(rec: dict) -> str:
    if rec.get("skipped"):
        return (f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:5s} "
                f"SKIP ({rec['reason'][:40]}...)")
    if not rec.get("ok"):
        return (f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:5s} "
                f"FAIL {rec.get('error', '?')[:80]}")
    m = rec["memory"]
    c = rec["cost"]
    return (f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:5s} OK "
            f"run={rec['run_s']:6.1f}s "
            f"mem/dev={m['peak_bytes_est'] / 2**30:7.2f}GiB "
            f"flops/dev={c['flops']:.3e} hbm={c['hbm_bytes']:.3e} "
            f"nvlink={c['coll_nvlink_bytes']:.3e} "
            f"net={c['coll_net_bytes']:.3e}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--grad-accum", type=int, default=1)
    args = ap.parse_args()

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = [c.name for c in SHAPE_CELLS] if args.shape == "all" \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_fail = 0
    for multi in meshes:              # one fake group per mesh
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, multi, args.out,
                               grad_accum=args.grad_accum)
                print(summarize(rec), flush=True)
                if not rec.get("ok") and not rec.get("skipped"):
                    n_fail += 1
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"\ndry-run complete, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
