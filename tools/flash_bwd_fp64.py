"""Hold the fp32 flash-attention backward, kernel and plain version, against
float64 at the training shape of chip_smoke phase 7 (b 4, s 2048, h 32 /
kv 4, dh 128, causal).

Run from the root of a tree, on a machine with a CUDA card:

    python3 tools/flash_bwd_fp64.py [--seeds 1 2 3]

For each seed (inputs from a CUDA generator, as chip_smoke draws them)
prints one JSON line: per gradient, the largest |error| of the kernel
against the plain version (``attention_bwd_ref``, fp32), of the kernel
against float64 and of the plain version against float64, each also as a
share of chip_smoke's fp32 criterion |a - b| <= 3e-5 (1 + |b|) (a share
above 1 fails it).  The float64 gradients are autograd of the plain
attention, one query head at a time.
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402

TOL = smoke.TOL[torch.float32]


def fp64_grads(q, k, v, dout):
    """(dq, dk, dv) of causal attention in float64, by autograd per head."""
    sq, h, dh = q.shape[1:]
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    grads = [torch.zeros(t.shape, dtype=torch.float64, device=t.device)
             for t in (q, k, v)]
    for hh in range(h):
        kh = hh // g
        leaves = [t.detach().double().requires_grad_(True)
                  for t in (q[:, :, hh], k[:, :, kh], v[:, :, kh])]
        with torch.enable_grad():
            s = torch.einsum("bqd,bkd->bqk", *leaves[:2]) / math.sqrt(dh)
            s = s.masked_fill(kpos > qpos, float("-inf"))
            o = torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), leaves[2])
            gq, gk, gv = torch.autograd.grad(o, leaves, dout[:, :, hh].double())
        grads[0][:, :, hh] += gq
        grads[1][:, :, kh] += gk
        grads[2][:, :, kh] += gv
    return grads


def errors(a, b) -> dict:
    a, b = a.double(), b.double()
    err = (a - b).abs()
    return {"max_abs": float(err.max()),
            "share": float((err / (TOL + TOL * b.abs())).max())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    args = ap.parse_args()
    card = smoke.phase_device()
    smoke.phase_build()
    shape = smoke.FLASH_MAIN
    b, sq, _, h, _, dh = shape[:6]
    for seed in args.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = smoke._flash_inputs(gen, shape, torch.float32)
        dout = torch.randn((b, sq, h, dh), generator=gen, device="cuda")
        out, lse = smoke.flash_ops.flash_attention_with_lse(q, k, v)
        kern = smoke.flash_ops.flash_attention_bwd(q, k, v, out, dout, lse)
        plain = smoke.attention_bwd_ref(q, k, v, dout)
        exact = fp64_grads(q, k, v, dout)
        rec = {"card": card, "seed": seed, "shape": shape}
        for name, a, p, e in zip(("dq", "dk", "dv"), kern, plain, exact):
            rec[name] = {"kernel_vs_plain": errors(a, p),
                         "kernel_vs_fp64": errors(a, e),
                         "plain_vs_fp64": errors(p, e),
                         "largest_fp64": float(e.abs().max())}
        print(json.dumps(rec), flush=True)
        del q, k, v, dout, out, lse, kern, plain, exact
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
