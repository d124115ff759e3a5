"""Parameter templates: every parameter is declared once as a ``ParamSpec``.

The leaf names, shapes, dtypes and init kinds follow the reference
templates exactly, so weights carry across leaf for leaf.  Init *values*
cannot match ``jax.random``: the port draws from an explicit
``torch.Generator``, one leaf after another in template order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.device import DTYPES, resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple            # logical axis name (str) or None per dim
    dtype: str = "bfloat16"
    init: str = "normal"   # normal | zeros | ones | neg_ones
    scale: float | None = None   # stddev; default fan-in

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a nested dict (ParamSpecs or tensors)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _init_one(spec: ParamSpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    dtype = DTYPES[spec.dtype]
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "neg_ones":
        return torch.full(spec.shape, -1, dtype=dtype, device=device)
    # fan-in is the leading dim, as in the reference (for a stacked cycle
    # leaf that is the layer count)
    fan_in = spec.shape[0] if spec.shape else 1
    std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


def init_params(tpl, generator: torch.Generator, device=None):
    """Template -> nested dict of initialized tensors on ``device`` (the
    card unless ``device="cpu"``). ``generator`` must live on that device."""
    dev = resolve_device(device)
    return tree_map(lambda s: _init_one(s, generator, dev), tpl)


def count_params(tpl) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(tpl))


def stack_cycle(tpl, n_cycles: int):
    """Add a leading scan ('layers') dim to every param in a cycle template."""
    return tree_map(
        lambda s: ParamSpec((n_cycles,) + s.shape, ("layers",) + s.axes,
                            s.dtype, s.init, s.scale), tpl)
