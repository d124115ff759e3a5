# Copy of repro/configs/stablelm_3b.py; the port imports nothing of repro.
"""stablelm-3b: 32L, 32H (kv=32, i.e. MHA), d_ff 6912, vocab 50304.
[hf:stabilityai/stablelm-2-1_6b family; unverified]"""
from repro_torch.configs.registry import _shrink_common
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    d_model=2560, n_layers=32, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab_size=50304,
    cycle=(LayerSpec(kind="attn"),),
    mlp_act="silu", gated=True,
)


def smoke():
    return _shrink_common(CONFIG, n_kv_heads=4)
