"""Dense model layers: norms, RoPE, attention (plain path), MLP.

Pure functions on tensors with parameters passed explicitly, as in the
reference.  ``blocked_attention`` and ``decode_attention`` here are the
plain PyTorch versions: the model takes them on the CPU and the CUDA
kernels in ``repro_torch.kernels`` on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamSpec

f32 = torch.float32


# --------------------------------------------------------------------- norms
def rms_norm(x, w, eps: float = 1e-6):
    xf = x.to(f32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + w.to(x.dtype))


def layer_norm(x, w, b, eps: float = 1e-6):
    xf = x.to(f32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


def apply_norm(x, p, cfg: ModelConfig):
    if cfg.norm_type == "ln":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def norm_template(cfg: ModelConfig, d: int | None = None) -> dict:
    d = d or cfg.d_model
    t = {"scale": ParamSpec((d,), (None,), "float32", "zeros")}
    if cfg.norm_type == "ln":
        t = {"scale": ParamSpec((d,), (None,), "float32", "ones"),
             "bias": ParamSpec((d,), (None,), "float32", "zeros")}
    return t


# ---------------------------------------------------------------------- rope
def rope(x, positions, theta: float):
    """x: (..., s, nheads, head_dim); positions: broadcastable to (..., s).

    Half-split rotation (not interleaved), angles in fp32."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=f32, device=x.device) / half)
    angles = positions.to(f32)[..., None] * freq             # (..., s, half)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)        # (..., s, 1, half)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x


# ----------------------------------------------------------------- attention
def _repeat_kv(k, n_heads: int):
    """(b, s, kv, dh) -> (b, s, h, dh): flat-head GQA."""
    g = n_heads // k.shape[2]
    if g == 1:
        return k
    return torch.repeat_interleave(k, g, dim=2)


def _attend(q, k, v, mask, cap: float):
    """q: (b,sq,h,dh) pre-scaled; k/v: (b,sk,h,dh); mask broadcastable to
    (b,h,sq,sk). Scores in fp32, probabilities cast to the v dtype."""
    s = torch.einsum("bqhd,bshd->bhqs", q.to(f32), k.to(f32))
    s = softcap(s, cap)
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, v)


def blocked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      cap: float = 0.0, q_blocks: int = 8, q_offset: int = 0):
    """Block attention with static per-block key ranges.

    q: (b, sq, h, dh), k/v: (b, sk, kv, dh). Returns (b, sq, h, dh)."""
    b, sq, h, dh = q.shape
    qs = q * (1.0 / math.sqrt(dh))
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    dev = q.device

    q_blocks = max(1, min(q_blocks, sq))
    while sq % q_blocks:
        q_blocks -= 1
    qb = sq // q_blocks
    outs = []
    for i in range(q_blocks):
        q_lo = q_offset + i * qb
        if causal:
            k_hi = min(q_lo + qb, k.shape[1])
            k_lo = max(0, q_lo - window) if window else 0
        else:
            k_lo, k_hi = 0, k.shape[1]
        qi = qs[:, i * qb:(i + 1) * qb]
        ki = k[:, k_lo:k_hi]
        vi = v[:, k_lo:k_hi]
        if causal:
            qpos = q_lo + torch.arange(qb, device=dev)
            kpos = k_lo + torch.arange(k_hi - k_lo, device=dev)
            m = kpos[None, :] <= qpos[:, None]
            if window:
                m &= (qpos[:, None] - kpos[None, :]) < window
            m = m[None, None]
        else:
            m = torch.ones((1, 1, 1, k_hi - k_lo), dtype=torch.bool, device=dev)
        outs.append(_attend(qi, ki, vi, m, cap))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, kpos, pos, *, window: int = 0,
                     cap: float = 0.0):
    """Single-token attention over a (possibly ring-buffered) KV cache.

    q: (b, 1, h, dh); k/v_cache: (b, S, kv, dh); kpos: (b, S) absolute
    positions of cached keys (-1 = empty); pos: (b,) current positions.
    """
    b, _, h, dh = q.shape
    qs = q * (1.0 / math.sqrt(dh))
    kc = _repeat_kv(k_cache, h)
    vc = _repeat_kv(v_cache, h)
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    if window:
        valid &= (pos[:, None] - kpos) < window
    mask = valid[:, None, None, :]                  # (b,1,1,S)
    return _attend(qs, kc, vc, mask, cap)


# --------------------------------------------------------------- dense MLP
def _silu(x):
    return x * torch.sigmoid(x)


def _gelu_tanh(x):
    # dtype-preserving tanh GELU, as in the reference
    return 0.5 * x * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * x * x * x)))


ACTS = {"silu": _silu, "gelu": _gelu_tanh, "relu": F.relu}


def mlp_template(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    t = {"wi": ParamSpec((d, f), ("embed", "mlp"), cfg.dtype),
         "wo": ParamSpec((f, d), ("mlp", "embed"), cfg.dtype)}
    if cfg.gated:
        t["wg"] = ParamSpec((d, f), ("embed", "mlp"), cfg.dtype)
    return t


def mlp(x, p, cfg: ModelConfig):
    act = ACTS[cfg.mlp_act]
    h = x @ p["wi"]
    h = act(h) * (x @ p["wg"]) if cfg.gated else act(h)
    return h @ p["wo"]
