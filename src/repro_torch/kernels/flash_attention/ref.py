"""Plain PyTorch versions of the flash attention kernels, forward and
backward (autograd through the forward)."""

from __future__ import annotations

import math

import torch

f32 = torch.float32


def _scores(q, k, causal: bool, window: int, softcap: float):
    """Masked fp32 logits (b, h, sq, sk) and the visibility mask (sq, sk)."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    kh = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
    s = torch.einsum("bqhd,bshd->bhqs", q.to(f32), kh.to(f32))
    s = s / math.sqrt(dh)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
        if window:
            mask &= (qpos - kpos) < window
    return s.masked_fill(~mask[None, None], -1e30), mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0):
    """q: (b, sq, h, dh); k/v: (b, sk, kv, dh) -> (b, sq, h, dh)."""
    h, kv = q.shape[2], k.shape[2]
    g = h // kv
    vh = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
    s, _ = _scores(q, k, causal, window, softcap)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, vh.to(f32)).to(q.dtype)


def attention_lse_ref(q, k, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0):
    """The row log-sum-exp of the logits, (b, h, sq) fp32, as the forward
    kernel writes it for the backward: +inf for a row that sees no key."""
    s, mask = _scores(q, k, causal, window, softcap)
    lse = torch.logsumexp(s, dim=-1)
    return lse.masked_fill(~mask.any(-1)[None, None], float("inf"))


def attention_bwd_ref(q, k, v, dout, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0):
    """(dq, dk, dv) of ``attention_ref`` at (q, k, v) for the output
    gradient ``dout``, by autograd, in the inputs' dtype.

    Autograd runs on fp32 copies of the inputs and each gradient is rounded
    to the input dtype once, as the kernel does: on bf16 inputs autograd
    would round each query head's dK / dV to bf16 before the GQA sum over
    the group (g roundings instead of one).  A row that sees no key gets a
    uniform softmax here (the masked scores are all equal) but zero output
    and zero gradients from the kernels; compare rows that see a key."""
    with torch.enable_grad():
        leaves = [t.detach().to(f32).requires_grad_(True) for t in (q, k, v)]
        out = attention_ref(*leaves, causal=causal, window=window,
                            softcap=softcap)
        grads = torch.autograd.grad(out, leaves, dout.to(f32))
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))
