"""How far an arch's fp32 logits on the CPU lie from float64, on the weights
and inputs of chip_smoke phase 4 (full width, 2 layers; an encoder config
also 2 encoder layers and seeded frames).  This is the conditioning that
bounds phase 4's card-vs-CPU check at 2e-3 (ROADMAP C-k).

Run from the root of a tree (CPU only, a few seconds for whisper-small):

    python3 tools/logits_fp64.py whisper-small [--fan-in-std] [--seed 0]

Prints one JSON line: the largest |fp32 - float64| of the prefill's
last-position logits, their std, and the std and largest magnitude of the
first attention layer's scores before qk-norm and RoPE (the encoder's
for an encoder config).
``--fan-in-std`` draws the block weights as chip_smoke's
``well_conditioned`` does.
"""

import argparse
import json
import os
import sys
from dataclasses import replace

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import DTYPES  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import init_params, tree_map  # noqa: E402

# the model casts to its config's dtype by name: float64 for this tool only
DTYPES.setdefault("float64", torch.float64)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--fan-in-std", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    cfg = replace(get_config(args.arch), n_layers=2, dtype="float32")
    if cfg.encoder:
        cfg = replace(cfg, encoder=replace(cfg.encoder, n_layers=2))
    m32 = Model(cfg, device="cpu")
    tpl = m32.param_template()
    p32 = init_params(smoke.well_conditioned(tpl) if args.fan_in_std else tpl,
                      torch.Generator().manual_seed(args.seed), device="cpu")
    b, s = 2, args.prompt
    # phase 4's draw: the prompt and its 2 decode tokens
    toks = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (b, s + 2)))[:, :s]
    enc = smoke._frames(cfg, b, args.seed + 1)
    kw32 = {} if enc is None else {"enc_embeds": enc}
    kw64 = {} if enc is None else {"enc_embeds": enc.double()}
    l32, _ = m32.prefill(p32, toks, **kw32)
    p64 = tree_map(lambda t: t.double() if t.is_floating_point() else t, p32)
    l64, _ = Model(replace(cfg, dtype="float64"), device="cpu").prefill(
        p64, toks, **kw64)

    first = p32["encoder" if cfg.encoder else "blocks"]
    blocks = first["blocks"] if cfg.encoder else first
    att = tree_map(lambda t: t[0], blocks["s0"]["attn"])
    x = enc if cfg.encoder else m32._embed(p32, toks)
    h = L.apply_norm(x, att["ln"], cfg)
    q = torch.einsum("bsd,dhk->bshk", h, att["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, att["wk"])
    g = cfg.n_heads // cfg.n_kv_heads
    scores = torch.einsum("bqhd,bkhd->bhqk", q,
                          torch.repeat_interleave(k, g, dim=2)) \
        / cfg.head_dim ** 0.5
    print(json.dumps(dict(
        arch=args.arch, fan_in_std=args.fan_in_std,
        fp32_vs_fp64_max_abs=float((l32.double() - l64).abs().max()),
        logits_std=float(l64.std()),
        first_layer_score_std=float(scores.std()),
        first_layer_score_max_abs=float(scores.abs().max()))))


if __name__ == "__main__":
    main()
