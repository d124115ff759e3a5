"""Carry the reference package's parameters across to the port.

The reference keeps parameters as a nested dict of arrays; handed over as
numpy arrays (``np.asarray`` of each leaf), they become the port's nested
dict of tensors with the same keys and layouts (``wq`` stays
``(L, d, h, dh)``, and so on).  A bfloat16 leaf arrives as an
``ml_dtypes`` array; it travels as its ``uint16`` view, reinterpreted as
``torch.bfloat16``, so this module never imports ``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)                       # owned, writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree, device=None):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return _leaf(tree, dev)
