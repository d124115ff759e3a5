"""Plain PyTorch version of the flash attention kernel."""

from __future__ import annotations

import math

import torch

f32 = torch.float32


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0):
    """q: (b, sq, h, dh); k/v: (b, sk, kv, dh) -> (b, sq, h, dh)."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    kh = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
    vh = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
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
    s = s.masked_fill(~mask[None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, vh.to(f32)).to(q.dtype)
