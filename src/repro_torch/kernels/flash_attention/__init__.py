from repro_torch.kernels.flash_attention.ops import (
    FlashAttentionFn, flash_attention, flash_attention_bwd,
    flash_attention_with_lse)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_bwd",
           "flash_attention_with_lse", "attention_ref", "attention_bwd_ref"]
