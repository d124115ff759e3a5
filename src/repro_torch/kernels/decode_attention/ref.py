"""Plain PyTorch version of the decode attention kernel."""

from __future__ import annotations

import math

import torch

f32 = torch.float32


def decode_attention_ref(q, k_cache, v_cache, lengths, *, window: int = 0,
                         softcap: float = 0.0):
    """q: (b, h, dh); k/v_cache: (b, S, kv, dh); lengths: (b,) valid prefix.

    Attends to cache positions [max(0, len-window), len) per sequence.  A
    sequence with no visible position gets 0, as the kernel returns (the
    reference package's oracle would give the mean of v there).
    """
    b, h, dh = q.shape
    S, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    kh = torch.repeat_interleave(k_cache, g, dim=2) if g > 1 else k_cache
    vh = torch.repeat_interleave(v_cache, g, dim=2) if g > 1 else v_cache
    s = torch.einsum("bhd,bshd->bhs", q.to(f32), kh.to(f32))
    s = s / math.sqrt(dh)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S, device=q.device)[None, :]
    lens = lengths.to(q.device)[:, None]
    valid = pos < lens
    if window:
        valid &= pos >= (lens - window)
    s = s.masked_fill(~valid[:, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, vh.to(f32))
    out = out.masked_fill(~valid.any(-1)[:, None, None], 0.0)
    return out.to(q.dtype)
