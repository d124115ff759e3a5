"""Architecture registry of the port: the archs ported so far.

``yi-9b`` (slice 1), ``mamba2-2.7b`` (slice 2), ``stablelm-3b`` (slice
6; its head_dim 80 on the card since slice 12), ``gemma2-27b``,
``starcoder2-15b``, ``chameleon-34b`` and ``whisper-small`` (slice 8) and
the MoE archs ``dbrx-132b``, ``granite-moe-3b-a800m`` and
``jamba-v0.1-52b`` (slice 9) run on both the card and the CPU.  The order
is the reference registry's.
"""

from __future__ import annotations

import importlib
from dataclasses import replace

from repro_torch.models.config import ModelConfig

ARCH_MODULES = {
    "gemma2-27b": "gemma2_27b",
    "stablelm-3b": "stablelm_3b",
    "yi-9b": "yi_9b",
    "starcoder2-15b": "starcoder2_15b",
    "dbrx-132b": "dbrx_132b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "chameleon-34b": "chameleon_34b",
    "whisper-small": "whisper_small",
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
