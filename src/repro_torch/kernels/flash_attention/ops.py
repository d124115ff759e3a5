"""Public wrapper of the flash attention kernel.

CPU tensors take the plain version (``ref.attention_ref``); CUDA tensors
launch the CUDA kernel or raise.  ``flash_attention.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (64, 128)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + \
    [ctypes.c_float, ctypes.c_void_p]


@functools.cache
def _entry(dtype):
    """The C entry for ``dtype``, with its argument types declared."""
    fn = getattr(_build.library("flash_attention"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (b,sq,h,dh), k/v (b,sk,kv,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[2]:
        raise ValueError(f"shapes do not pair: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported by the CUDA kernel "
                         f"(supported: {HEAD_DIMS})")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want all "
                        "float32 or all bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} is not on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (b, sq, h, dh); k/v: (b, sk, kv, dh) -> (b, sq, h, dh)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    _check(q, k, v)
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _entry(q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, sq, sk, h, kv, dh, int(causal), int(window), float(softcap),
             stream)
    flash_attention.launches += 1
    _build.check(err, "flash_attention")
    return out


flash_attention.launches = 0
