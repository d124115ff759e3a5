"""Mamba-2 SSD (state-space duality) mixer of the port.

The chunked SSD algorithm of Dao & Gu (arXiv:2405.21060): the sequence is
cut into chunks of length Q; within a chunk the output is a small
quadratic attention-like contraction, across chunks a linear recurrence
over per-chunk states.

Dispatch: ``ssd_scan`` pads the sequence to a multiple of Q and then, on
the card, runs the chunk scan through the CUDA kernels
(``kernels.ssd.ops.ssd_chunk_scan``: for bf16 three launches per call,
chunk states, a pass over the chunks and the chunk scan, on the tensor
cores; for fp32 one CUDA-core kernel); on the CPU it runs the chunked plain
path (``_ssd_chunked``), a port of the reference's XLA path.  Both start
from ``ssm_state`` when one is given (the reference's ``ssd_forward``
does), else from zeros.  ``ssd_decode`` is plain PyTorch on both devices.

Two deliberate differences from the reference:
* The kernel returns y in x's dtype, so in a bf16 model the card rounds y
  to bf16 before the skip term is added; the reference adds it to the fp32
  y.  In fp32 the two paths agree.
* The reference's chunked path sums the chunk states over *all* groups
  (``einsum("bckgn,bckhp->bchnp")``), which is wrong when n_groups > 1;
  the port gives head h the B of its own group, as the sequential oracle
  and the Pallas kernel do (ROADMAP C-f).  No shipped config has
  n_groups > 1.

The CPU path keeps the reference's decay exp(cum_q - cum_k), a difference
of two prefix sums, which in fp32 loses precision of the exponent as the
chunk grows; the kernels build their exponents from sums of one sign (the
bf16 kernel, inside one 64-row tile, from a difference of two such sums)
and stay closer to the sequential recurrence (``kernels/ssd/csrc/ssd.cu``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd.ops import ssd_chunk_scan
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.models.layers import ACTS
from repro_torch.models.param import ParamSpec

f32 = torch.float32
_silu = ACTS["silu"]


def ssm_template(cfg: ModelConfig) -> dict:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    conv_ch = s.d_inner + 2 * s.n_groups * s.d_state
    return {
        "w_in": ParamSpec((d, 2 * s.d_inner), ("embed", "mlp"), cfg.dtype),
        "w_bc": ParamSpec((d, 2 * s.n_groups * s.d_state), ("embed", None),
                          cfg.dtype),
        "w_dt": ParamSpec((d, s.n_heads), ("embed", "heads"), cfg.dtype),
        "dt_bias": ParamSpec((s.n_heads,), ("heads",), "float32", "zeros"),
        "a_log": ParamSpec((s.n_heads,), ("heads",), "float32", "zeros"),
        "conv_w": ParamSpec((s.conv_width, conv_ch), (None, "mlp"),
                            cfg.dtype, "normal", 0.2),
        "skip_d": ParamSpec((s.n_heads,), ("heads",), "float32", "ones"),
        "w_out": ParamSpec((s.d_inner, d), ("mlp", "embed"), cfg.dtype),
    }


def ssm_cache_template(cfg: ModelConfig, batch: int) -> dict:
    s: SSMConfig = cfg.ssm
    conv_ch = s.d_inner + 2 * s.n_groups * s.d_state
    return {
        "conv": ParamSpec((batch, s.conv_width - 1, conv_ch),
                          ("batch", None, None), cfg.dtype, "zeros"),
        "state": ParamSpec((batch, s.n_heads, s.d_state, s.head_dim),
                           ("batch", "heads", None, None), "float32", "zeros"),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv via shifted adds. x: (b,s,c); w: (cw,c).

    state: (b, cw-1, c) trailing context (decode); returns (y, new_state)."""
    cw = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, cw):
        y = y + xp[:, i:i + s] * w[i]
    return y, xp[:, -(cw - 1):]


def _split_proj(x, p, s: SSMConfig):
    """Input projections -> (z, conv input [x_in | B | C])."""
    zi = x @ p["w_in"]
    z, xin = zi[..., :s.d_inner], zi[..., s.d_inner:]
    bc = x @ p["w_bc"]
    return z, torch.cat([xin, bc], dim=-1)


def _post_conv(conv_ed, s: SSMConfig):
    """SiLU, then split into xh (b,s,h,p), B and C (b,s,g,n): views of one
    tensor at channel offsets 0, d_inner and d_inner + g*n."""
    conv_ed = _silu(conv_ed)
    gn = s.n_groups * s.d_state
    b, sl = conv_ed.shape[:2]
    xh = conv_ed[..., :s.d_inner].view(b, sl, s.n_heads, s.head_dim)
    B = conv_ed[..., s.d_inner:s.d_inner + gn].view(b, sl, s.n_groups,
                                                     s.d_state)
    C = conv_ed[..., s.d_inner + gn:].view(b, sl, s.n_groups, s.d_state)
    return xh, B, C


def _ssd_chunked(xh, dt, A, B, C, Q: int, init=None):
    """Chunked SSD on the CPU (reference ``ssm.py:106-155``); the sequence
    is a multiple of Q.  Returns (y (b,L,h,p) fp32, final state fp32)."""
    b, L, h, p = xh.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    nc = L // Q

    def chunk(a):                       # (b, nc*Q, ...) -> (b, nc, Q, ...)
        return a.reshape(b, nc, Q, *a.shape[2:])

    xh_c, dt_c = chunk(xh.to(f32)), chunk(dt.to(f32))
    B_c, C_c = chunk(B.to(f32)), chunk(C.to(f32))               # (b,nc,Q,g,n)
    Bh = torch.repeat_interleave(B_c, hpg, dim=3)               # (b,nc,Q,h,n)
    Ch = torch.repeat_interleave(C_c, hpg, dim=3)
    cum = torch.cumsum(dt_c * A.to(f32), dim=2)                 # (b,nc,Q,h)
    total = cum[:, :, -1:, :]

    # intra-chunk: decay L[q,k] = exp(cum_q - cum_k) for k <= q, else 0
    cb = torch.einsum("bcqgn,bckgn->bcgqk", C_c, B_c)           # (b,nc,g,Q,Q)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (b,nc,Q,Q,h)
    ltri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    Lmat = torch.where(ltri[None, None, :, :, None], torch.exp(diff),
                       torch.zeros((), dtype=f32, device=xh.device))
    xdt = xh_c * dt_c[..., None]                                # (b,nc,Q,h,p)
    scores = torch.repeat_interleave(cb, hpg, dim=2)            # (b,nc,h,Q,Q)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp",
                           scores * Lmat.movedim(-1, 2), xdt)

    # inter-chunk: S_c = sum_k exp(total - cum_k) dt_k B_k (x) x_k, carried
    w_state = torch.exp(total - cum)                            # (b,nc,Q,h)
    BX = torch.einsum("bckhn,bckhp->bchnp", Bh, xdt * w_state[..., None])
    decay = torch.exp(total[:, :, 0, :])                        # (b,nc,h)
    state = init.to(f32) if init is not None else \
        torch.zeros((b, h, n, p), dtype=f32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(state)                                      # PREV state
        state = state * decay[:, c, :, None, None] + BX[:, c]
    prev_states = torch.stack(prev, 1)                          # (b,nc,h,n,p)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           Ch * torch.exp(cum)[..., None], prev_states)
    return (y_intra + y_inter).reshape(b, L, h, p), state


def ssd_scan(xh, dt, A, B, C, chunk: int, ssm_state=None):
    """Pad the sequence to a multiple of Q = min(chunk, s) and run the chunk
    scan from ``ssm_state`` (or zeros): the CUDA kernels on the card,
    ``_ssd_chunked`` on the CPU.

    Returns (y (b,s,h,p): xh's dtype on the card, fp32 on the CPU; final
    state (b,h,n,p) fp32).  Padded rows carry dt = 0, so they leave the
    state as it was."""
    seqlen = xh.shape[1]
    Q = min(chunk, seqlen)
    pad = (-seqlen) % Q
    if pad:
        xh, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xh, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    if xh.device.type == "cuda":
        init = None if ssm_state is None else ssm_state.float().contiguous()
        y, state = ssd_chunk_scan(xh, dt, A, B, C, chunk=Q, init=init)
    else:
        y, state = _ssd_chunked(xh, dt, A, B, C, Q, ssm_state)
    return y[:, :seqlen], state


def ssd_forward(x, p, cfg: ModelConfig, conv_state=None, ssm_state=None,
                return_state: bool = False):
    """Full-sequence SSD. x: (b, s, d_model) -> out, or
    (out, (conv_state, ssm_state)) with ``return_state``."""
    s: SSMConfig = cfg.ssm
    b, seqlen, _ = x.shape
    z, conv_in = _split_proj(x, p, s)
    conv_out, conv_state_new = _causal_conv(conv_in, p["conv_w"], conv_state)
    xh, B, C = _post_conv(conv_out, s)
    dt = F.softplus((x @ p["w_dt"]).to(f32) + p["dt_bias"].to(f32))  # (b,s,h)
    A = -torch.exp(p["a_log"].to(f32))                                 # (h,)

    y, final_state = ssd_scan(xh, dt, A, B, C, s.chunk, ssm_state)
    y = y.to(f32) + xh * p["skip_d"].to(f32)[None, None, :, None]
    y = y.reshape(b, seqlen, s.d_inner).to(x.dtype)
    y = y * _silu(z)
    out = y @ p["w_out"]
    if return_state:
        return out, (conv_state_new, final_state)
    return out


def ssd_decode(x, p, cfg: ModelConfig, conv_state, ssm_state):
    """Single-token SSD step. x: (b, 1, d_model) -> (y, (conv', ssm'))."""
    s: SSMConfig = cfg.ssm
    b = x.shape[0]
    z, conv_in = _split_proj(x, p, s)
    conv_out, conv_state_new = _causal_conv(conv_in, p["conv_w"], conv_state)
    xh, B, C = _post_conv(conv_out, s)
    xh, B, C = xh[:, 0], B[:, 0], C[:, 0]     # (b,h,p), (b,g,n), (b,g,n)

    dt = F.softplus((x[:, 0] @ p["w_dt"]).to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["a_log"].to(f32))
    dA = torch.exp(dt * A[None, :])                              # (b,h)

    hpg = s.n_heads // s.n_groups
    Bh = torch.repeat_interleave(B, hpg, dim=1).to(f32)          # (b,h,n)
    Ch = torch.repeat_interleave(C, hpg, dim=1).to(f32)

    # h' = h * exp(dt A) + dt * (B (x) x)
    upd = dt[..., None, None] * Bh[..., :, None] * xh[..., None, :].to(f32)
    new_state = ssm_state * dA[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    y = y + xh.to(f32) * p["skip_d"].to(f32)[None, :, None]
    y = y.reshape(b, 1, s.d_inner).to(x.dtype)
    y = y * _silu(z)
    out = y @ p["w_out"]
    return out, (conv_state_new, new_state)
