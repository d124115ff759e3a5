"""The bf16 flash-attention backward kernel's roundings, emulated on the CPU.

The kernel (``csrc/flash_attention_bwd.cu``) feeds its tensor-core products
bf16 operands: the inputs as given, and P = exp(logit - lse) and
dS = P (dP - D) (softcap and 1/sqrt(dh) folded in) each rounded to bf16
once from fp32, before dV += P^T dO, dK += dS^T Q and dQ += dS K, which
accumulate in fp32.  ``emulated_bwd`` does that arithmetic in plain fp32
PyTorch; held against ``attention_bwd_ref`` (autograd of the plain
forward) at the card's bf16 tolerance, it shows that those roundings fit
the tolerance the card test uses.  Without the roundings it matches the
plain version to fp32 precision, which checks the emulation itself.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

BF16_TOL = 2e-2          # the card test's bf16 tolerance (abs and rel)
EXACT_TOL = 1e-4         # fp32 emulation without the roundings

# (b, sq, sk, h, kv, dh, causal, window, softcap), from the card test's
# BWD_SHAPES: g 16 at dh 64 and at dh 128 (ragged, b 2), window + softcap,
# and a ragged MQA shape
SHAPES = [
    (1, 200, 200, 16, 1, 64, True, 0, 0.0),
    (2, 130, 130, 32, 2, 128, True, 0, 0.0),
    (1, 256, 256, 8, 8, 64, True, 64, 30.0),
    (1, 300, 300, 4, 1, 128, True, 0, 0.0),
]


def _inputs(dtype, b, sq, sk, h, kv, dh, seed=21):
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh),
              (b, sq, h, dh))
    return [torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
            for s in shapes]


def emulated_bwd(q, k, v, dout, *, causal, window, softcap,
                 round_operands=True):
    """(dq, dk, dv) by the kernel's arithmetic in fp32: O and lse as the
    forward writes them, D = rowsum(dO o O), P and dS rounded to bf16 (if
    ``round_operands``) before the products that take them; each gradient
    rounded once to the inputs' dtype."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(dh)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = attention_ref(q, k, v, **kw)
    lse = attention_lse_ref(q, k, **kw)
    qf, kf, vf, of, df = (t.float() for t in (q, k, v, out, dout))
    kh, vh = kf.repeat_interleave(g, dim=2), vf.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kh) * scale
    dcap = scale
    if softcap:
        th = torch.tanh(s / softcap)
        s, dcap = softcap * th, (1 - th * th) * scale
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
        if window:
            mask &= (qpos - kpos) < window
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", df, vh)
    delta = (df * of).sum(-1).permute(0, 2, 1)
    ds = p * (dp - delta[..., None]) * dcap
    if round_operands:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, df).reshape(b, sk, kv, g, dh)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(b, sk, kv, g, dh)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    return tuple(t.to(q.dtype) for t in (dq, dk.sum(3), dv.sum(3)))


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,softcap", SHAPES)
def test_bf16_operand_roundings_fit_the_bf16_tolerance(b, sq, sk, h, kv, dh,
                                                       causal, window,
                                                       softcap):
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v, do = _inputs(torch.bfloat16, b, sq, sk, h, kv, dh)
    want = attention_bwd_ref(q, k, v, do, **kw)
    for got, ref in zip(emulated_bwd(q, k, v, do, **kw), want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), atol=BF16_TOL,
                                   rtol=BF16_TOL)
    # the emulation itself, without the roundings and in fp32 throughout
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    exact = emulated_bwd(qf, kf, vf, dof, round_operands=False, **kw)
    for got, ref in zip(exact, attention_bwd_ref(qf, kf, vf, dof, **kw)):
        torch.testing.assert_close(got, ref, atol=EXACT_TOL, rtol=EXACT_TOL)
