# Copy of repro/configs/starcoder2_15b.py; the port imports nothing of repro.
"""starcoder2-15b: 40L, GQA 48H/4KV, RoPE, vocab 49152.
[arXiv:2402.19173; hf]"""
from repro_torch.configs.registry import _shrink_common
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    d_model=6144, n_layers=40, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152,
    cycle=(LayerSpec(kind="attn"),),
    mlp_act="gelu", gated=False, norm_type="ln", rope_theta=100_000.0,
)


def smoke():
    return _shrink_common(CONFIG, n_kv_heads=2)
