"""Plain PyTorch versions of the SSD (Mamba-2) chunk-scan kernels.

``ssd_ref``: the sequential recurrence, one position at a time, in fp32:
the ground truth that the CUDA kernel and the chunked plain path of
``models/ssm.py`` must both match.

``ssd_bwd_ref``: its gradient, written out over chunks of Q rows in the
four stages of the backward kernels (``csrc/ssd_bwd.cu``), each a function
of its own so that a stage of the kernel can be held against it:

1. ``bwd_chunk_states``: per chunk, the state it adds,
   Σ_k exp(sum of dt A after k) dt_k B_k ⊗ x_k, and the state gradient its
   outputs give, Σ_q exp(cum_q) C_q ⊗ dy_q (cum the prefix sum of dt A);
2. ``bwd_state_pass``: the states entering each chunk (from ``init``), and
   the gradient of the state leaving it, dS_{c-1} = exp(total_c) dS_c +
   (its share from 1), from ``dstate``; the one entering chunk 0 is
   ``dinit``; and each chunk's <S_out_c, dS_c>;
3. ``bwd_chunk_grads``: per chunk, dx, dB, dC from the intra, inter and
   state terms, x . dx / dt (the direct part of ddt) and each row's
   d cum_t share, C_t . dC_t - (dt x_t) . (dx_t / dt) per head;
4. ``bwd_decay``: d(dt A)_t = <S_out_c, dS_c> + Σ_{u >= t} d cum_u over the
   chunk, so ddt += A d(dt A) and dA = Σ dt d(dt A).

Heads read the B and C of their own group (h / g), and dB, dC sum over
the heads of a group.  Stage 4's suffix sums carry each row's fp32
rounding of C . dC - x' . dx' (two dot products of a few hundred at the
test shapes) to every earlier row of its chunk, and dA sums them again:
ddt and dA sit ~1e-5 of their largest entry from float64, some 10x
further than the sequential recurrence's reverse pass.  Decays are exponentials of sums of one sign, never
differences of prefix sums: deep in a 256-row chunk such a difference
carries an error of a few ulp of |cum|.  Nothing here keeps a state per
position: at b 4 x s 2048 that would be 2,048 states of 10.5 MB each.
"""

from __future__ import annotations

import torch

f32 = torch.float32


def ssd_ref(x, dt, A, B, C, init=None):
    """Sequential SSD recurrence.

    x: (b, s, h, p); dt: (b, s, h); A: (h,) (negative); B/C: (b, s, g, n);
    init: (b, h, n, p) or None (zeros).
    Returns y: (b, s, h, p) fp32 with y_t = C_t . S_t, and the final state
    S (b, h, n, p) fp32, where S_t = S_{t-1} * exp(dt_t A) + dt_t B_t (x) x_t
    and S_{-1} = init.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    Bh = torch.repeat_interleave(B.to(f32), hpg, dim=2)       # (b,s,h,n)
    Ch = torch.repeat_interleave(C.to(f32), hpg, dim=2)
    xf, dtf, Af = x.to(f32), dt.to(f32), A.to(f32)
    state = init.to(f32) if init is not None else \
        torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af[None, :])              # (b,h)
        upd = dtf[:, t, :, None, None] * Bh[:, t, :, :, None] * \
            xf[:, t, :, None, :]
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    return torch.stack(ys, 1), state


# ------------------------------------------------------------ the backward
def _chunks(t, Q: int):
    """(b, nc * Q, ...) -> (b, nc, Q, ...) in fp32."""
    return t.to(f32).reshape(t.shape[0], t.shape[1] // Q, Q, *t.shape[2:])


def _heads(t, h: int):
    """(..., g, n) -> (..., h, n): each head reads its own group's row."""
    return torch.repeat_interleave(t, h // t.shape[-2], dim=-2)


def decay_sums(dt, A, Q: int):
    """a = dt A over chunks of Q rows -> (cum, after, total): the sum of a
    over the chunk's rows up to t (inclusive) and after t, (b, nc, Q, h),
    and over the whole chunk, (b, nc, h); each a sum of one sign."""
    a = _chunks(dt, Q) * A.to(f32)
    cum = torch.cumsum(a, dim=2)
    after = torch.flip(torch.cumsum(torch.flip(a, (2,)), dim=2), (2,))
    after = torch.cat([after[:, :, 1:], torch.zeros_like(after[:, :, :1])],
                      dim=2)
    return cum, after, cum[:, :, -1]


def _decay_matrix(dt, A, Q: int):
    """L (b, nc, h, Q, Q): exp(sum of dt A over rows k+1 .. q) where k <= q,
    else 0; each exponent a running sum down a column (one sign)."""
    a = _chunks(dt, Q) * A.to(f32)                          # (b,nc,Q,h)
    a = a.permute(0, 1, 3, 2)[..., :, None].expand(*a.shape[:2], a.shape[3],
                                                   Q, Q)    # [u, k] = a_u
    below = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device),
                       diagonal=-1)                         # u > k
    seg = torch.cumsum(torch.where(below, a, 0.0), dim=-2)  # [q, k]
    keep = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(keep, torch.exp(seg), 0.0)


def bwd_chunk_states(x, dt, A, B, C, dy, Q: int):
    """Stage 1 -> (states, dstates, total): per chunk the state it adds,
    Σ_k exp(after_k) dt_k B_k ⊗ x_k, and the state gradient of its
    outputs, Σ_q exp(cum_q) C_q ⊗ dy_q, each (b, nc, h, n, p); and each
    chunk's sum of dt A, (b, nc, h)."""
    h = x.shape[2]
    cum, after, total = decay_sums(dt, A, Q)
    xs = _chunks(x, Q) * _chunks(dt, Q)[..., None]          # dt x
    Bh, Ch = _heads(_chunks(B, Q), h), _heads(_chunks(C, Q), h)
    states = torch.einsum("bckhn,bckhp->bchnp", Bh,
                          xs * torch.exp(after)[..., None])
    dstates = torch.einsum("bcqhn,bcqhp->bchnp", Ch,
                           _chunks(dy, Q) * torch.exp(cum)[..., None])
    return states, dstates, total


def bwd_state_pass(states, dstates, total, init=None, dstate=None):
    """Stage 2 -> (prev, grads, dinit, delta): the state entering each
    chunk, S_c = exp(total_c) S_{c-1} + states_c from ``init`` (or 0); the
    gradient of the state leaving each chunk, dS_{c-1} = exp(total_c) dS_c
    + dstates_c from ``dstate`` (or 0), both (b, nc, h, n, p); the gradient
    of the state entering chunk 0, ``dinit`` (b, h, n, p); and
    <S_out_c, dS_c> (b, nc, h), the gradient of total_c."""
    nc = states.shape[1]
    decay = torch.exp(total)[..., None, None]
    s = torch.zeros_like(states[:, 0]) if init is None else init.to(f32)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * decay[:, c] + states[:, c]
    outs = prev[1:] + [s]
    g = torch.zeros_like(s) if dstate is None else dstate.to(f32)
    grads, delta = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        grads[c] = g
        delta[c] = (outs[c] * g).sum((-2, -1))
        g = g * decay[:, c] + dstates[:, c]
    return (torch.stack(prev, 1), torch.stack(grads, 1), g,
            torch.stack(delta, 1))


def bwd_chunk_grads(x, dt, A, B, C, dy, Q: int, prev, grads):
    """Stage 3 -> (dx, dB, dC, ddt_direct, dcum): the gradients of x
    (b, s, h, p), B and C (b, s, g, n, summed over each group's heads),
    x . dx / dt (b, s, h) and each row's d cum share C . dC - (dt x) .
    (dx / dt) (b, s, h), from the states entering (``prev``) and the
    gradients leaving (``grads``) each chunk."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    cum, after, _ = decay_sums(dt, A, Q)
    dtc = _chunks(dt, Q)
    xs = _chunks(x, Q) * dtc[..., None]
    Bc, Cc, dyc = _chunks(B, Q), _chunks(C, Q), _chunks(dy, Q)
    Bh, Ch = _heads(Bc, h), _heads(Cc, h)
    L = _decay_matrix(dt, A, Q)                             # (b,nc,h,q,k)
    cb = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)
    m1 = torch.repeat_interleave(cb, h // g, dim=2) * L     # (C_q . B_k) L
    m2 = torch.einsum("bcqhp,bckhp->bchqk", dyc, xs) * L    # (dy_q . x'_k) L
    w_after = torch.exp(after)[..., None]
    dxs = torch.einsum("bchqk,bcqhp->bckhp", m1, dyc) + w_after * \
        torch.einsum("bckhn,bchnp->bckhp", Bh, grads)
    dBh = torch.einsum("bchqk,bcqhn->bckhn", m2, Ch) + w_after * \
        torch.einsum("bchnp,bckhp->bckhn", grads, xs)
    dCh = torch.einsum("bchqk,bckhn->bcqhn", m2, Bh) + \
        torch.exp(cum)[..., None] * \
        torch.einsum("bchnp,bcqhp->bcqhn", prev, dyc)
    dcum = (Ch * dCh).sum(-1) - (xs * dxs).sum(-1)
    ddt_direct = (_chunks(x, Q) * dxs).sum(-1)

    def group_sum(t):
        return t.reshape(b, s, g, h // g, n).sum(3)

    return (dxs.reshape(b, s, h, p) * dt.to(f32)[..., None],
            group_sum(dBh), group_sum(dCh), ddt_direct.reshape(b, s, h),
            dcum.reshape(b, s, h))


def bwd_decay(dt, A, dcum, delta, ddt_direct, Q: int):
    """Stage 4 -> (ddt (b, s, h), dA (h,)): d(dt A)_t = <S_out_c, dS_c> +
    Σ_{u >= t in its chunk} dcum_u; ddt = ddt_direct + A d(dt A), dA =
    Σ_{b, t} dt d(dt A)."""
    b, s, h = dt.shape
    rows = _chunks(dcum, Q)
    da = torch.flip(torch.cumsum(torch.flip(rows, (2,)), dim=2), (2,)) \
        + delta[:, :, None, :]
    da = da.reshape(b, s, h)
    return ddt_direct.to(f32) + A.to(f32) * da, (dt.to(f32) * da).sum((0, 1))


def ssd_bwd_ref(x, dt, A, B, C, init, dy, dstate, *, chunk: int = 256):
    """Gradient of ``ssd_ref`` -> (dx, ddt, dA, dB, dC, dinit), all fp32:
    dy (b, s, h, p) is the gradient of y, ``dstate`` (b, h, n, p) or None
    (zeros) that of the final state; ``init`` is the initial state or None
    (zeros).  Over chunks of Q = min(chunk, s) rows (s a multiple of Q), in
    the kernels' four stages (module docstring)."""
    Q = min(chunk, x.shape[1])
    if x.shape[1] % Q:
        raise ValueError(f"sequence {x.shape[1]} is not a multiple of the "
                         f"chunk {Q}")
    states, dstates, total = bwd_chunk_states(x, dt, A, B, C, dy, Q)
    prev, grads, dinit, delta = bwd_state_pass(states, dstates, total, init,
                                               dstate)
    del states, dstates
    dx, dB, dC, ddt_direct, dcum = bwd_chunk_grads(x, dt, A, B, C, dy, Q,
                                                   prev, grads)
    ddt, dA = bwd_decay(dt, A, dcum, delta, ddt_direct, Q)
    return dx, ddt, dA, dB, dC, dinit
