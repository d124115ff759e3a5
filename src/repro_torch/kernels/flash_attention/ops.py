"""Public wrappers of the flash attention kernels, forward and backward.

CPU tensors take the plain versions (``ref.attention_ref``,
``ref.attention_bwd_ref``); other tensors go to the operators
``torch.ops.repro_torch.flash_attention`` / ``.flash_attention_bwd``,
whose one implementation launches the CUDA kernels on CUDA tensors and
refuses any other device.  (``launch.cost``'s counter intercepts the
operators on ``meta`` tensors, before that implementation, and counts
their work by formula.)
``flash_attention`` on CUDA inputs that need a gradient (grad mode on and
an input requiring grad) goes through ``FlashAttentionFn``: the forward
kernel also writes the row log-sum-exp, and the backward is the
hand-written kernel in ``csrc/flash_attention_bwd.cu``, never a plain
path.  ``flash_attention.launches`` counts forward launches and
``flash_attention_bwd.launches`` backward calls (three kernels each).
``launch_bwd_bf16`` launches chosen kernels of a bf16 backward on given
buffers, uncounted, so that ``chip_smoke.py`` can time each alone.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

HEAD_DIMS = (64, 80, 128)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + \
    [ctypes.c_float, ctypes.c_void_p]
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + \
    [ctypes.c_float, ctypes.c_void_p]
# the bf16 backward's kernels, as bits of the ``stages`` of launch_bwd_bf16
BWD_STAGES = {"delta": 1, "dkdv": 2, "dq": 4}
BWD_ALL_STAGES = 7


@functools.cache
def _entry(dtype):
    """The forward C entry for ``dtype``, with its argument types declared."""
    fn = getattr(_build.library("flash_attention"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry(dtype):
    """The backward C entry for ``dtype``, with its argument types declared."""
    fn = getattr(_build.library("flash_attention_bwd"), _BWD_ENTRY[dtype])
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_stages_entry():
    """The bf16 backward's C entry that takes a ``stages`` mask."""
    fn = _build.library("flash_attention_bwd").flash_attention_bwd_bf16_stages
    fn.argtypes = _BWD_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_tensor(name, t, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} is not on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check(q, k, v):
    """Shapes and dtypes, whatever the device."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (b,sq,h,dh), k/v (b,sk,kv,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[2]:
        raise ValueError(f"shapes do not pair: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want all "
                        "float32 or all bfloat16")


def _check_launch(q, k, v):
    """What the card's kernels take besides: head_dim, device, layout."""
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[3]} not supported by the CUDA "
                         f"kernel (supported: {HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, t, q.device)


def _fwd_op(q, k, v, causal, window, softcap, with_lse):
    """``repro_torch::flash_attention``: one forward launch -> (out, lse
    (b, h, sq) fp32, or an empty tensor without ``with_lse``)."""
    _check_launch(q, k, v)
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq) if with_lse else (0,), dtype=torch.float32,
                      device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, b, sq, sk, h, kv, dh,
        int(causal), int(window), float(softcap), stream)
    flash_attention.launches += 1
    _build.check(err, "flash_attention")
    return out, lse


def _launch_fwd(q, k, v, causal, window, softcap, with_lse):
    """One forward launch -> (out, lse (b, h, sq) fp32 or None)."""
    _check(q, k, v)
    out, lse = torch.ops.repro_torch.flash_attention(
        q, k, v, bool(causal), int(window), float(softcap), bool(with_lse))
    return out, lse if with_lse else None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (b, sq, h, dh); k/v: (b, sk, kv, dh) -> (b, sq, h, dh)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap)
    return _launch_fwd(q, k, v, causal, window, softcap, False)[0]


flash_attention.launches = 0


def flash_attention_with_lse(q, k, v, *, causal: bool = True, window: int = 0,
                             softcap: float = 0.0):
    """One forward launch on CUDA tensors -> (out, lse (b, h, sq) fp32):
    the row log-sum-exp of the logits, +inf for a row that sees no key.
    Counted in ``flash_attention.launches``; carries no gradient."""
    return _launch_fwd(q, k, v, causal, window, softcap, True)


def _check_bwd(q, k, v, out, dout, lse):
    _check(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: want "
                             f"{tuple(q.shape)} {q.dtype}")
    b, sq, h = q.shape[:3]
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: want "
                         f"({b}, {h}, {sq}) float32")


def _check_bwd_launch(q, k, v, out, dout, lse):
    _check_launch(q, k, v)
    for name, t in (("out", out), ("dout", dout), ("lse", lse)):
        _check_tensor(name, t, q.device)


def bwd_buffers(q, k):
    """(dq, dk, dv, delta) of one backward call: the gradients and the
    (b, h, sq) fp32 scratch of D = rowsum(dO o O)."""
    b, sq, h, _ = q.shape
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(k),
            torch.empty((b, h, sq), dtype=torch.float32, device=q.device))


def _bwd_args(q, k, v, out, dout, lse, buffers, causal, window, softcap):
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(),
            *(t.data_ptr() for t in buffers), b, sq, sk, h, kv, dh,
            int(causal), int(window), float(softcap))


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) for the output
    gradient ``dout``; ``out`` and ``lse`` (b, h, sq) fp32 come from the
    forward.  dk / dv sum over the query heads of each kv head.  CPU
    tensors take ``attention_bwd_ref`` (which needs neither ``out`` nor
    ``lse``)."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, dout, causal=causal, window=window,
                                 softcap=softcap)
    _check_bwd(q, k, v, out, dout, lse)
    return torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, out, dout, lse, bool(causal), int(window), float(softcap))


flash_attention_bwd.launches = 0


def _bwd_op(q, k, v, o, dout, lse, causal, window, softcap):
    """``repro_torch::flash_attention_bwd``: one backward call (three
    kernels) -> (dq, dk, dv)."""
    _check_bwd_launch(q, k, v, o, dout, lse)
    buffers = bwd_buffers(q, k)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_entry(q.dtype)(
        *_bwd_args(q, k, v, o, dout, lse, buffers, causal, window, softcap),
        stream)
    flash_attention_bwd.launches += 1
    _build.check(err, "flash_attention_bwd")
    return buffers[:3]


# the operators, one implementation for every device (the kernels check it)
_lib = torch.library.Library("repro_torch", "FRAGMENT")
_lib.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, float softcap, bool with_lse) -> (Tensor, Tensor)")
_lib.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, "
            "Tensor dout, Tensor lse, bool causal, int window, "
            "float softcap) -> (Tensor, Tensor, Tensor)")
_lib.impl("flash_attention", _fwd_op, "CompositeExplicitAutograd")
_lib.impl("flash_attention_bwd", _bwd_op, "CompositeExplicitAutograd")


def launch_bwd_bf16(q, k, v, out, dout, lse, buffers, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0,
                    stages: int = BWD_ALL_STAGES) -> None:
    """Launch the bf16 backward kernels named by ``stages`` (bits of
    ``BWD_STAGES``) on ``buffers`` (``bwd_buffers``); all three are
    ``flash_attention_bwd``.  Counts nothing: ``chip_smoke.py`` times each
    kernel alone on one set of buffers with it."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"launch_bwd_bf16 takes bfloat16, not {q.dtype}")
    _check_bwd(q, k, v, out, dout, lse)
    _check_bwd_launch(q, k, v, out, dout, lse)
    err = _bwd_stages_entry()(
        *_bwd_args(q, k, v, out, dout, lse, buffers, causal, window, softcap),
        stages, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient, on CUDA tensors only: both
    directions are the hand-written kernels.  On the CPU, autograd through
    ``attention_ref`` (what ``flash_attention`` returns there) is the
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = flash_attention_with_lse(q, k, v, causal=causal,
                                            window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         **ctx.opts)
        return dq, dk, dv, None, None, None
