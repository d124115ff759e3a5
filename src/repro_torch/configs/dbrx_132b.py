"""dbrx-132b: 40L, GQA 48H/8KV, fine-grained MoE 16 experts top-4,
d_ff 10752 per expert, vocab 100352. [hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.registry import _shrink_common
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    d_model=6144, n_layers=40, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    cycle=(LayerSpec(kind="attn", moe=True),),
    mlp_act="silu", gated=True, rope_theta=500_000.0,
    n_experts=16, top_k=4,
)


def smoke():
    return _shrink_common(CONFIG, n_experts=4, top_k=2)
