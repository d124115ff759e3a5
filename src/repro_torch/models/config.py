"""Model configuration: one composable schema covering all ten architectures.

A copy of the reference schema (same fields, same defaults), so that the
port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating cycle."""
    kind: str = "attn"          # "attn" | "ssm"
    window: int = 0             # 0 = global causal attention; >0 sliding window
    moe: bool = False           # MoE MLP instead of dense MLP
    mlp: bool = True            # False: mixer-only block (mamba2)
    cross_attn: bool = False    # decoder cross-attention (whisper)
    causal: bool = True         # False for encoder self-attention


@dataclass(frozen=True)
class SSMConfig:
    d_inner: int
    d_state: int
    n_heads: int
    head_dim: int
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256            # SSD chunk length


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder over a stub modality frontend."""
    n_layers: int
    n_frames: int = 1500        # precomputed frame embeddings (conv stub)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | vlm | audio | ssm
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    cycle: tuple = (LayerSpec(),)    # repeated n_layers / len(cycle) times
    # --- mlp ---
    mlp_act: str = "silu"
    gated: bool = True
    # --- attention ---
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qk_norm: bool = False
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- ssm / encoder ---
    ssm: SSMConfig | None = None
    encoder: EncoderConfig | None = None
    # --- misc ---
    norm_type: str = "rms"      # rms | ln
    norm_eps: float = 1e-6
    embed_scale: bool = False   # gemma-style sqrt(d) embedding scaling
    post_block_norm: bool = False   # gemma2-style post-norms
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- training-time knobs (hillclimb surface) ---
    remat: str = "block"        # none | block | full
    attn_q_blocks: int = 8      # block-causal attention q-splits
    attn_impl: str = "blocked"  # blocked | dense (xla paths) | pallas (tpu)
    long_context_seq_shard: bool = False  # shard KV seq over 'data' in decode

    def __post_init__(self):
        assert self.n_layers % len(self.cycle) == 0, \
            (self.name, self.n_layers, len(self.cycle))

    @property
    def n_cycles(self) -> int:
        return self.n_layers // len(self.cycle)

    def layer_specs(self) -> list:
        return [self.cycle[i % len(self.cycle)]
                for i in range(self.n_layers)]

    def with_updates(self, **kw) -> "ModelConfig":
        return replace(self, **kw)
