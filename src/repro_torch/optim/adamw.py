"""AdamW with fp32 master weights and moments, compute params in their own
dtype (bf16 on the card).

The reference's ``repro/optim/adamw.py`` in torch: the same state tree
``{"step", "m", "v", "master"}`` (``step`` a 0-d int32 tensor, the others
nested dicts like the params), so a state saves under the reference's leaf
names; fp32 math, global-norm clipping, bias correction, decoupled weight
decay on the master, params re-cast from the master.

Where it differs: ``adamw_update`` updates the state and the params in
place and returns them.  At full width a functional update would hold two
copies of the fp32 state (12 B a parameter) at once.  ``compress_int8``
draws its noise from an explicit ``torch.Generator``; ``compress_grads``
stays inert, as in the reference (ROADMAP C-c).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.optim.schedule import warmup_cosine

f32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress_grads: bool = False   # int8 stochastic-rounding all-reduce model


def adamw_init(params) -> dict:
    """Zero moments and an fp32 master copy of ``params`` (a fresh copy
    also for fp32 params, so the update never writes through to them)."""
    dev = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=f32, device=p.device)

    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "master": tree_map(lambda p: p.detach().to(f32, copy=True), params),
    }


def _global_norm(tree):
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(f32)))
                          for g in tree_leaves(tree)))


def compress_int8(g, generator: torch.Generator):
    """Stochastic-rounding int8 quantization (gradient compression model):
    a per-tensor scale, uniform noise in [-0.5, 0.5) from ``generator``."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    noise = torch.rand(g.shape, generator=generator, dtype=f32,
                       device=g.device) - 0.5
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q.to(f32) * scale


def _zip_leaves(first, *others):
    """Matching leaves of trees with the same keys, by key (not by dict
    order, which a restored tree need not share)."""
    if isinstance(first, dict):
        for key, sub in first.items():
            yield from _zip_leaves(sub, *(o[key] for o in others))
    else:
        yield (first, *others)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr=None):
    """One AdamW step; grads may be bf16, the math is fp32.

    Updates ``state`` (m, v, master, step) and ``params`` in place and
    returns ``(params, state, {"grad_norm", "lr"})``, the last two 0-d fp32
    tensors on the params' device."""
    step = state["step"] + 1
    stepf = step.to(f32)
    if lr is None:
        lr = warmup_cosine(step, peak_lr=cfg.peak_lr,
                           warmup_steps=cfg.warmup_steps,
                           total_steps=cfg.total_steps)
    gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=f32, device=stepf.device),
                        stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=f32, device=stepf.device),
                        stepf)
    for p, g, m, v, master in _zip_leaves(params, grads, state["m"],
                                          state["v"], state["master"]):
        g = g.to(f32) * clip
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        upd.add_(cfg.weight_decay * master)
        master.sub_(lr * upd)
        del upd
        p.copy_(master)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
