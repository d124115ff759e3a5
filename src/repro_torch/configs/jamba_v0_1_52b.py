"""jamba-v0.1-52b: 32L hybrid, attn:mamba 1:7 interleave (attn at offset 4
of each 8-layer period), MoE 16e top-2 on every other layer, vocab 65536.
Mamba-1-style mixer = SSD with head_dim 1 (see models/ssm.py).
[arXiv:2403.19887; hf]"""
from dataclasses import replace

from repro_torch.configs.registry import _shrink_common
from repro_torch.models.config import LayerSpec, ModelConfig, SSMConfig

_D_INNER = 8192

CYCLE = tuple(
    LayerSpec(kind=("attn" if i == 4 else "ssm"), moe=(i % 2 == 1), mlp=True)
    for i in range(8))

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    cycle=CYCLE,
    mlp_act="silu", gated=True,
    n_experts=16, top_k=2,
    ssm=SSMConfig(d_inner=_D_INNER, d_state=16, n_heads=_D_INNER, head_dim=1,
                  n_groups=1, conv_width=4, chunk=16),
)


def smoke():
    cfg = _shrink_common(CONFIG, n_experts=4, top_k=2, n_layers=8)
    return replace(cfg, ssm=SSMConfig(d_inner=128, d_state=8, n_heads=128,
                                      head_dim=1, n_groups=1, conv_width=4,
                                      chunk=16))
