"""The port's sharded train step and prefill, over two CPU ranks (gloo).

Two spawned processes join a gloo group through a ``FileStore`` under
``tmp_path`` (no TCP port to collide with other test workers) and place
the smoke models' params and state as DTensors on a mesh of (data 2) or
(model 2).  Each rank runs the single-device step beside the sharded one
on the same seeded weights and batch; rank 0 writes the differences.

Held (fp32): the loss within 1e-5 relative; the params after two AdamW
steps within 1e-5 of the largest param; the prefill's last-position
logits within 1e-5 of their largest; every gradient within 1e-4 of its
leaf's largest entry (the model-mesh sums run in another order, and at
the init's std the smoke model's gradients are ill-conditioned, ROADMAP
C-k: the worst leaf misses by 1e-5 to 3e-5 on either mesh's order).  The AdamW eps is 1e-3: its first steps divide each
gradient by its own size, so an entry near 0 would turn rounding in the
sums' order into +-lr; with eps 1e-3 the update is a smooth function of
the gradient.

Cases: yi-9b's smoke config; two with kv heads that do not divide
``model`` (6 q / 3 kv: each rank's heads need kv heads 0,0,1 and 1,2,2;
4 q / 1 kv: one kv head for all); mamba2's smoke prefill, and its step-0
loss and gradients (the sharded SSM backward: the chunked scan on each
rank's heads, with B, C and A's partial gradients summed over the head
shards).  mamba2 takes no optimizer step: the smoke model's own
single-device loss goes NaN by step 2 at this learning rate.
"""

import json
import os
import time
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

torch.set_num_threads(2)

WORLD = 2
TIMEOUT_S = 240
# name -> (arch, config updates, what is compared: the prefill's logits,
# the step-0 loss and gradients, the losses and params of two AdamW steps)
FULL = ("logits", "loss", "grads", "step_loss", "params")
CASES = {"yi-9b": ("yi-9b", {}, FULL),
         "gqa_6q_3kv": ("yi-9b", {"n_heads": 6, "n_kv_heads": 3}, FULL),
         "gqa_4q_1kv": ("yi-9b", {"n_heads": 4, "n_kv_heads": 1}, FULL),
         "mamba2-2.7b": ("mamba2-2.7b", {}, ("logits", "loss", "grads"))}


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _case(sh, arch: str, updates: dict, checks: tuple) -> dict:
    """One case on this rank: the single-device and the sharded results'
    differences."""
    import numpy as np

    from repro_torch.checkpoint import leaf_paths
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import Model
    from repro_torch.models.param import init_params, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.loop import (_value_and_grad, make_loss_fn,
                                        make_train_step, train_state_template)

    cfg = replace(smoke_config(arch), dtype="float32", **updates)
    single, sharded = Model(cfg, device="cpu"), Model(cfg, sh, device="cpu")
    ptpl, otpl = train_state_template(single)
    p1 = init_params(ptpl, torch.Generator().manual_seed(0), device="cpu")
    p2 = sh.distribute(tree_map(lambda t: t.clone(), p1), ptpl)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 33)))
    out = {}
    want, _ = single.prefill(p1, toks[:, :32], cache_len=40)
    got, _ = sharded.prefill(p2, toks[:, :32], cache_len=40)
    out["logits"] = _rel(got.full_tensor(), want)
    batch = {"inputs": toks[:, :32], "targets": toks[:, 1:]}
    l1, g1 = _value_and_grad(make_loss_fn(single), p1, batch)
    with sh.region():
        l2, g2 = _value_and_grad(make_loss_fn(sharded), p2, batch)
    out["loss"] = abs(float(l2.full_tensor()) - float(l1)) / abs(float(l1))
    out["grads"] = max(_rel(b.full_tensor(), a) for (_, a), (_, b) in
                       zip(leaf_paths(g1), leaf_paths(g2)))
    if "step_loss" not in checks:
        return out
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
    s1, s2 = adamw_init(p1), sh.distribute(adamw_init(p1), otpl)
    step1 = make_train_step(single, opt)
    step2 = make_train_step(sharded, opt)
    losses = []
    for _ in range(2):
        p1, s1, m1 = step1(p1, s1, batch)
        p2, s2, m2 = step2(p2, s2, batch)
        losses.append(abs(float(m2["loss"].full_tensor()) - float(m1["loss"]))
                      / abs(float(m1["loss"])))
    out["step_loss"] = max(losses)
    top = max(float(a.abs().max()) for _, a in leaf_paths(p1))
    out["params"] = max(float((b.full_tensor() - a).abs().max()) / top
                        for (_, a), (_, b) in zip(leaf_paths(p1),
                                                  leaf_paths(p2)))
    return out


def _worker(rank: int, store_path: str, mesh_name: str, out_path: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel import Sharder

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=(mesh_name,))
        sh = Sharder.for_mesh(mesh)
        res = {name: _case(sh, *case) for name, case in CASES.items()}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _run(tmp_path, mesh_name: str) -> dict:
    out = tmp_path / f"{mesh_name}.json"
    ctx = mp.start_processes(
        _worker, args=(str(tmp_path / f"{mesh_name}.store"), mesh_name,
                       str(out)),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        # join returns False while a rank is still running
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise AssertionError(f"ranks still running after "
                                     f"{TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    return {m: _run(tmp, m) for m in ("data", "model")}


@pytest.mark.parametrize("mesh", ["data", "model"])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_equals_single_device(results, mesh, case):
    res = results[mesh][case]
    bad = {k: v for k, v in res.items()
           if not v <= (1e-4 if k == "grads" else 1e-5)}
    assert not bad, (mesh, case, res)
    assert set(res) == set(CASES[case][2])


def test_the_run_leaves_no_process(results):
    assert os.environ.get("MASTER_PORT") is None
    assert set(results) == {"data", "model"}
