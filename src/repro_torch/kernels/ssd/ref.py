"""Plain PyTorch version of the SSD (Mamba-2) chunk-scan kernel.

The sequential recurrence, one position at a time, in fp32: the ground
truth that the CUDA kernel and the chunked plain path of ``models/ssm.py``
must both match.
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
