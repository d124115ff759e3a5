"""Model layers: norms, RoPE, attention (plain path), MLP, MoE MLP.

Pure functions on tensors with parameters passed explicitly, as in the
reference.  ``blocked_attention`` and ``decode_attention`` here are the
plain PyTorch versions: the model takes them on the CPU and the CUDA
kernels in ``repro_torch.kernels`` on the card.  The MoE MLP runs the
same code on both: its expert products are batched matrix products over
the experts (the reference's are XLA einsums, outside any Pallas kernel),
and its routing uses no op that reads back to the host, so a decode step
through it can be captured as a CUDA graph.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

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


def mlp(x, p, cfg: ModelConfig, sh=None):
    act = ACTS[cfg.mlp_act]
    h = x @ p["wi"]
    h = act(h) * (x @ p["wg"]) if cfg.gated else act(h)
    if sh is not None:
        h = sh(h, "batch", "seq", "mlp")
    return h @ p["wo"]


# ----------------------------------------------------------------- MoE MLP
def moe_template(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    t = {"router": ParamSpec((d, e), ("embed", None), "float32",
                             "normal", 0.02),
         "w_in": ParamSpec((e, d, f), ("experts", "embed", "mlp"), cfg.dtype),
         "w_out": ParamSpec((e, f, d), ("experts", "mlp", "embed"), cfg.dtype)}
    if cfg.gated:
        t["w_gate"] = ParamSpec((e, d, f), ("experts", "embed", "mlp"),
                                cfg.dtype)
    return t


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _dispatch_one(eid, n_experts: int, capacity: int):
    """Sort-based dispatch, each row of ``eid`` one token group.

    eid: (..., S*k) expert id per (token, choice). Returns
    * ``gather_tok`` (..., E*C): which flat (token, choice) each expert slot
      reads (an empty slot reads 0)
    * ``inv``        (..., S*k): the slot each (token, choice) landed in
      (E*C = dropped: it points at a zero row)

    A stable sort keeps the (token, choice) order within an expert, so the
    first C of an expert's entries are kept, as in the reference.  The
    counts are a comparison summed over the tokens (``bincount`` on the
    card reads its maximum back to the host).  Dropped entries all write
    the sentinel slot E*C, which is sliced off: which of them wins there
    does not matter.
    """
    nk = eid.shape[-1]
    eid_s, order = torch.sort(eid, dim=-1, stable=True)
    experts = torch.arange(n_experts, device=eid.device)
    counts = (eid[..., None] == experts).sum(-2)                 # (..., E)
    starts = counts.cumsum(-1) - counts
    rank = torch.arange(nk, device=eid.device) - starts.gather(-1, eid_s)
    sentinel = n_experts * capacity
    slot = torch.where(rank < capacity, eid_s * capacity + rank, sentinel)
    gather_tok = eid.new_zeros(eid.shape[:-1] + (sentinel + 1,)) \
        .scatter_(-1, slot, order)
    inv = torch.full_like(eid, sentinel).scatter_(-1, order, slot)
    return gather_tok[..., :-1], inv


def capacity(cfg: ModelConfig, S: int) -> int:
    """Expert slots per group of S tokens: S*k/E*cf rounded up to a multiple
    of 8, at most S*k (the reference's expression, as written)."""
    E, k = cfg.n_experts, cfg.top_k
    C = _round_up(max(1, int(math.ceil(S * k / E * cfg.capacity_factor))), 8)
    return min(C, S * k)


def route(x, router, k: int):
    """The router: x (G, S, d) -> (logits (G,S,E) fp32, probs, top_w and
    top_e (G,S,k)).  The product runs in fp32 (the caller must leave TF32
    off: it would change which experts are chosen); the top k are taken by
    a stable descending sort, so ties go to the lower expert id and the
    choices come in descending order, as ``jax.lax.top_k`` gives them."""
    logits = x.to(f32) @ router.to(f32)
    probs = torch.softmax(logits, dim=-1)
    sorted_w, sorted_e = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    return logits, probs, sorted_w[..., :k], sorted_e[..., :k]


def moe_mlp(x, p, cfg: ModelConfig, sh=None):
    """Top-k token-choice MoE with sort-based dispatch (GShard-style
    capacity).

    x: (G, S, d): G groups (batch rows), each routed on its own.  Returns
    (y, aux_loss).
    """
    G, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    act = ACTS[cfg.mlp_act]

    logits, probs, top_w, top_e = route(x, p["router"], k)      # (G,S,k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # flat index n corresponds to (token n // k, choice n % k)
    gather_tok, inv = _dispatch_one(top_e.reshape(G, S * k), E, C)
    tok_of_slot = gather_tok // k                                # (G, E*C)

    # expert-major rows: (E, G*C, d), one bmm over E per product
    rows = tok_of_slot.view(G, E, C).transpose(0, 1) \
        + (torch.arange(G, device=x.device) * S)[None, :, None]
    xe = x.reshape(G * S, d)[rows.reshape(E, G * C)]
    if sh is not None:
        xe = sh(xe, "experts", None, None)
    h = torch.bmm(xe, p["w_in"])
    h = act(h) * torch.bmm(xe, p["w_gate"]) if cfg.gated else act(h)
    if sh is not None:
        h = sh(h, "experts", None, "mlp")
    out = torch.bmm(h, p["w_out"]).view(E, G, C, d).transpose(0, 1) \
        .reshape(G, E * C, d)
    # zero row for dropped tokens, then combine by gather
    out = torch.cat([out, out.new_zeros(G, 1, d)], dim=1)
    picked = out.gather(1, inv[..., None].expand(G, S * k, d))
    picked = picked.view(G, S, k, d)
    w = top_w.to(picked.dtype)
    if isinstance(picked, DTensor):
        # DTensor's einsum reshapes the sharded operands into a view their
        # placements cannot take (granite at prefill_32k); the product and
        # sum over k take the same values, summed in another order
        y = (picked * w[..., None]).sum(2)
    else:
        y = torch.einsum("gskd,gsk->gsd", picked, w)
    if sh is not None:
        y = sh(y, "batch", "seq", None)

    # load-balance + router-z auxiliary losses (Switch/GShard standard)
    me = probs.mean(dim=(0, 1))                                  # (E,)
    first = top_e[..., :1] == torch.arange(E, device=x.device)
    ce = first.to(f32).mean(dim=(0, 1))
    aux = E * (me * ce).sum()
    zloss = torch.logsumexp(logits, dim=-1).square().mean()
    return y, cfg.router_aux_weight * aux + 1e-4 * zloss
