"""mamba2-2.7b: 64L attention-free SSD blocks, d_model 2560, d_inner 5120,
ssm_state 128, head_dim 64 (80 heads), vocab 50280. [arXiv:2405.21060]"""
from dataclasses import replace

from repro_torch.configs.registry import _shrink_common
from repro_torch.models.config import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    d_model=2560, n_layers=64, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    cycle=(LayerSpec(kind="ssm", mlp=False),),
    ssm=SSMConfig(d_inner=5120, d_state=128, n_heads=80, head_dim=64,
                  n_groups=1, conv_width=4, chunk=256),
    tie_embeddings=True,
)


def smoke():
    cfg = _shrink_common(CONFIG, n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0)
    return replace(cfg, ssm=SSMConfig(d_inner=128, d_state=16, n_heads=8,
                                      head_dim=16, n_groups=1, conv_width=4,
                                      chunk=16))
