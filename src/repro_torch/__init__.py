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

Importing the package does not import ``torch``: the lake layer and the
sync daemon (``lst/``, ``core/``) never touch a tensor, and the fleet's
process-mode children import only them.  ``DTYPES`` and
``resolve_device`` load ``device.py`` on first use.
"""

__all__ = ["DTYPES", "resolve_device"]


def __getattr__(name):
    if name in __all__:
        from repro_torch import device
        return getattr(device, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
