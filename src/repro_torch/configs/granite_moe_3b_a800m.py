"""granite-moe-3b-a800m: 32L, GQA 24H/8KV, MoE 40 experts top-8, d_ff 512
per expert, vocab 49155. [hf:ibm-granite family; hf]"""
from repro_torch.configs.registry import _shrink_common
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    d_model=1536, n_layers=32, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    cycle=(LayerSpec(kind="attn", moe=True),),
    mlp_act="silu", gated=True,
    n_experts=40, top_k=8,
)


def smoke():
    return _shrink_common(CONFIG, n_experts=8, top_k=2)
