# Copy of repro/configs/whisper_small.py; the port imports nothing of repro.
"""whisper-small: enc-dec 12L+12L, d_model 768, 12H, d_ff 3072, vocab 51865.
Conv audio frontend is a STUB: input_specs() provides precomputed
(batch, 1500, d_model) frame embeddings. RoPE replaces Whisper's absolute
positions (TPU-native backbone; deviation noted in DESIGN.md).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.registry import _shrink_common
from repro_torch.models.config import EncoderConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    d_model=768, n_layers=12, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    cycle=(LayerSpec(kind="attn", cross_attn=True),),
    mlp_act="gelu", gated=False, norm_type="ln",
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
    tie_embeddings=True,
)


def smoke():
    from dataclasses import replace
    cfg = _shrink_common(CONFIG)
    return replace(cfg, encoder=EncoderConfig(n_layers=2, n_frames=16))
