"""Public wrapper of the decode attention kernel.

CPU tensors take the plain version (``ref.decode_attention_ref``); CUDA
tensors launch the CUDA kernel or raise.  ``decode_attention.launches``
counts the kernel launches (one per call: the split pass and its merge).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (64, 128)
MAX_GROUP = 16          # query heads per kv head the kernel serves
TILE = 64               # cache rows per stage of the kernel's ring
MAX_SPLITS = 1024       # splits the merge kernel takes
_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


@functools.cache
def _entry(dtype):
    """The C entry for ``dtype``, with its argument types declared."""
    fn = getattr(_build.library("decode_attention"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def split_plan(S: int, num_sms: int, pairs: int) -> tuple:
    """(rows per split, number of splits) for a cache of ``S`` rows on a
    card of ``num_sms`` SMs, for ``pairs`` = b x kv (batch, kv head) pairs.

    Depends on the shapes and the SM count alone, never on ``lengths``
    (which stay on the device), so a CUDA graph replays it for any lengths.
    About one wave of blocks in all: ``num_sms // pairs`` splits of whole
    tiles, at least one, never more than ``MAX_SPLITS`` (which the merge
    takes).  At the serving shape (S 4096, 4 x 4 pairs, 132 SMs) that is 8
    splits of 512 rows, of which the ~5 that hold rows of ~2060-row
    prefixes run ~80 blocks: on the H100 that beat splits of 128, 256 and
    1024 rows, since each block's fixed costs and the merge's partials,
    not the bytes in flight, set the time there.  A smaller batch gets
    more, shorter splits, so the blocks that hold rows stay near that
    count."""
    if S < 1 or num_sms < 1 or pairs < 1:
        raise ValueError(f"need S, num_sms, pairs >= 1; got {S}, {num_sms}, "
                         f"{pairs}")
    rows = max(-(-S // max(1, num_sms // pairs)), -(-S // MAX_SPLITS))
    chunk = TILE * -(-rows // TILE)
    return chunk, -(-S // chunk)


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k_cache, v_cache, lengths):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"want q (b,h,dh), k/v cache (b,S,kv,dh); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, h, dh = q.shape
    kv = k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != dh or h % kv:
        raise ValueError(f"shapes do not pair: q {tuple(q.shape)}, "
                         f"cache {tuple(k_cache.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported by the CUDA kernel "
                         f"(supported: {HEAD_DIMS})")
    if h // kv > MAX_GROUP:
        raise ValueError(f"{h // kv} query heads per kv head; the kernel "
                         f"serves at most {MAX_GROUP}")
    if q.dtype not in _ENTRY or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}: want all float32 or all bfloat16")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise TypeError(f"lengths must be int32 of shape ({b},)")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} is not on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "lengths" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0,
                     softcap: float = 0.0):
    """q: (b, h, dh); k/v_cache: (b, S, kv, dh); lengths: (b,) int32
    -> (b, h, dh)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths,
                                    window=window, softcap=softcap)
    _check(q, k_cache, v_cache, lengths)
    b, h, dh = q.shape
    S, kv = k_cache.shape[1], k_cache.shape[2]
    chunk, nsplit = split_plan(S, _num_sms(q.device.index), b * kv)
    out = torch.empty_like(q)
    part_m = torch.empty((b, h, nsplit), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, nsplit, dh), dtype=torch.float32,
                           device=q.device)
    fn = _entry(q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), part_m.data_ptr(),
             part_l.data_ptr(), part_acc.data_ptr(), b, h, kv, S, dh,
             int(window), float(softcap), chunk, stream)
    decode_attention.launches += 1
    _build.check(err, "decode_attention")
    return out


decode_attention.launches = 0
