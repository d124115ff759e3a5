"""Device resolution and the config-string -> torch dtype map."""

from __future__ import annotations

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for the card without one raises:
    the port never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path")
        if dev.index is None:       # as tensors report it: cuda:<index>
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
