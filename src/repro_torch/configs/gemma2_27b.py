# Copy of repro/configs/gemma2_27b.py; the port imports nothing of repro.
"""gemma2-27b: 46L, GQA 32H/16KV, local(4096)+global alternating, logit
softcaps, tied embeddings. [arXiv:2408.00118; hf]"""
from repro_torch.configs.registry import _shrink_common
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    d_model=4608, n_layers=46, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    cycle=(LayerSpec(kind="attn", window=4096),      # local sliding
           LayerSpec(kind="attn", window=0)),        # global
    mlp_act="gelu", gated=True,
    attn_softcap=50.0, final_softcap=30.0,
    post_block_norm=True, tie_embeddings=True, embed_scale=True,
)


def smoke() -> ModelConfig:
    return _shrink_common(CONFIG, d_ff=128)
