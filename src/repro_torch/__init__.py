"""PyTorch + CUDA port of the ``repro`` model stack.

The JAX package ``repro`` is the reference; this package grows beside it
one slice at a time and imports nothing of it (nor of JAX).  Slice 1 is the
serving path of a dense GQA decoder (``yi-9b``): prefill through a
hand-written CUDA flash-attention kernel and decode through a hand-written
CUDA decode-attention kernel.  Slice 2 serves ``mamba2-2.7b``: the SSD
chunk scan of prefill through a hand-written CUDA kernel, the decode step
in plain PyTorch.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper takes its
plain PyTorch version.
"""

from repro_torch.device import DTYPES, resolve_device

__all__ = ["DTYPES", "resolve_device"]
