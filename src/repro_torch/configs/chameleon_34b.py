# Copy of repro/configs/chameleon_34b.py; the port imports nothing of repro.
"""chameleon-34b: 48L, GQA 64H/8KV, early-fusion VQ image tokens in the
shared vocab, qk-norm (training stability fix from the paper), vocab 65536.
The VQ-VAE image tokenizer is a STUB: input_specs() provides token ids that
already include image codebook entries. [arXiv:2405.09818; unverified]"""
from repro_torch.configs.registry import _shrink_common
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    d_model=8192, n_layers=48, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65536,
    cycle=(LayerSpec(kind="attn"),),
    mlp_act="silu", gated=True, qk_norm=True,
)


def smoke():
    return _shrink_common(CONFIG)
