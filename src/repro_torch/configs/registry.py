"""Architecture registry of the port: the archs ported so far.

``yi-9b`` (slice 1) and ``mamba2-2.7b`` (slice 2) run in the port; the
other eight archs of the reference registry are queued in ROADMAP.md.
"""

from __future__ import annotations

import importlib
from dataclasses import replace

from repro_torch.models.config import ModelConfig

ARCH_MODULES = {
    "yi-9b": "yi_9b",
    "mamba2-2.7b": "mamba2_2_7b",
}

ARCHS = tuple(ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: tiny dims, same cycle structure."""
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.smoke()


def _shrink_common(cfg: ModelConfig, **kw) -> ModelConfig:
    base = dict(
        d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=16,
        d_ff=128 if cfg.d_ff else 0, vocab_size=256,
        n_layers=2 * len(cfg.cycle), remat="none", attn_q_blocks=2)
    base.update(kw)
    return replace(cfg, **base)
