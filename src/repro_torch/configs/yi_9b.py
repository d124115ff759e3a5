"""yi-9b: 48L, GQA 32H/4KV, llama-arch SwiGLU, vocab 64000.
[arXiv:2403.04652; hf]"""
from repro_torch.configs.registry import _shrink_common
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    d_model=4096, n_layers=48, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000,
    cycle=(LayerSpec(kind="attn"),),
    mlp_act="silu", gated=True, rope_theta=5_000_000.0,
)


def smoke():
    return _shrink_common(CONFIG, n_kv_heads=2)
