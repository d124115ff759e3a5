"""Where a bf16 SSM train step's gradients and losses part from fp32's.

    python3 tools/ssd_train_diag.py        (from a tree's root, on one GPU)

1. At full width and 4 layers, on one seeded batch of b 4 x s 2048, the
   relative norm difference of every parameter's gradient between a bf16
   and an fp32 model at the same (bf16) weights: mamba2-2.7b through the
   SSD kernels; mamba2-2.7b in bf16 with the plain backward
   (``ssd_bwd_ref``) in place of the backward kernels; the kernels against
   that plain backward in each dtype; and yi-9b as a baseline with no SSD.
2. chip_smoke phase 15's run (mamba2-2.7b, 4 layers, its Delta corpus and
   seed) for 6 steps in bf16 and fp32 at peak learning rates 1e-3 (phase
   7's) and 3e-4 (phase 15's): the losses.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import leaf_paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import LakeDataLoader, write_synth_corpus  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_bwd_ref  # noqa: E402
from repro_torch.lst import LocalFS  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import (init_params, tree_leaves,  # noqa: E402
                                      tree_map)
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig, make_loss_fn  # noqa: E402

LAYERS, BATCH, SEQ = 4, 4, 2048


class PlainBackward(torch.autograd.Function):
    """The SSD forward kernels with the plain backward (``ssd_bwd_ref``)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, q, init):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.q = q
        return torch.ops.repro_torch.ssd_chunk_scan(x, dt, A, B, C, q, init)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C = ctx.saved_tensors
        g = ssd_bwd_ref(x, dt, A, B, C, None, dy, dstate, chunk=ctx.q)
        return (g[0].to(x.dtype), g[1], g[2], g[3].to(B.dtype),
                g[4].to(C.dtype), None, None)


def plain_backward_scan(x, dt, A, B, C, *, chunk, init=None):
    return PlainBackward.apply(x, dt, A, B, C, min(chunk, x.shape[1]), init)


def grads(arch, dtype, params, batch, plain=False) -> list:
    model = Model(replace(get_config(arch), n_layers=LAYERS, dtype=dtype))
    kernel_scan = S.ssd_chunk_scan
    if plain:
        S.ssd_chunk_scan = plain_backward_scan
    try:
        live = tree_map(lambda t: t.detach().to(
            torch.float32 if dtype == "float32" else t.dtype)
            .clone().requires_grad_(True), params)
        loss, _ = make_loss_fn(model, ce_chunk=128)(live, batch)
        return [g.float() for g in
                torch.autograd.grad(loss, tree_leaves(live))]
    finally:
        S.ssd_chunk_scan = kernel_scan


def gaps(params, a, b) -> dict:
    return {n: round(float((x - y).norm() / y.norm()), 5)
            for (n, _), x, y in zip(leaf_paths(params), a, b)}


def gradient_gaps() -> None:
    for arch in ("mamba2-2.7b", "yi-9b"):
        cfg = replace(get_config(arch), n_layers=LAYERS)
        params = init_params(Model(cfg).param_template(),
                             torch.Generator(device="cuda").manual_seed(0))
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (BATCH, SEQ + 1))).cuda()
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        f32 = grads(arch, "float32", params, batch)
        b16 = grads(arch, "bfloat16", params, batch)
        print(f"{arch}: bf16 vs fp32 " + json.dumps(gaps(params, b16, f32)),
              flush=True)
        if arch == "mamba2-2.7b":
            b16p = grads(arch, "bfloat16", params, batch, plain=True)
            f32p = grads(arch, "float32", params, batch, plain=True)
            for name, a, b in (
                    ("bf16 with the plain backward vs fp32", b16p, f32),
                    ("bf16 kernels vs bf16 plain backward", b16, b16p),
                    ("fp32 kernels vs fp32 plain backward", f32, f32p)):
                print(f"{arch}: {name} " + json.dumps(gaps(params, a, b)),
                      flush=True)
        del params
        torch.cuda.empty_cache()


def losses() -> None:
    cfg = replace(get_config("mamba2-2.7b"), n_layers=LAYERS)
    root = Path(tempfile.mkdtemp(prefix="ssd_train_diag_"))
    try:
        fs, corpus = LocalFS(), str(root / "corpus")
        write_synth_corpus(fs, corpus, fmt="delta", n_docs=32,
                           pack_len=SEQ + 1, vocab=cfg.vocab_size, seed=0)
        for dtype in ("bfloat16", "float32"):
            for lr in (1e-3, 3e-4):
                tr = Trainer(
                    Model(replace(cfg, dtype=dtype)),
                    LakeDataLoader(fs, corpus, "delta", batch_size=BATCH,
                                   seq_len=SEQ),
                    fs, str(root / "ckpt"),
                    TrainerConfig(steps=6, save_every=0, ce_chunk=128,
                                  opt=AdamWConfig(peak_lr=lr, warmup_steps=2,
                                                  total_steps=10)))
                tr.init_or_restore(seed=0)
                out = []
                for _ in range(6):
                    tr.params, tr.opt_state, met = tr.step_fn(
                        tr.params, tr.opt_state, tr.next_batch())
                    out.append(round(float(met["loss"]), 4))
                print(f"mamba2-2.7b {dtype} peak lr {lr}: losses {out}",
                      flush=True)
                del tr
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_train_diag: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    gradient_gaps()
    losses()
    return 0


if __name__ == "__main__":
    sys.exit(main())
