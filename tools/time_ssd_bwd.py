"""Check and time the SSD chunk-scan backward on the card: chip_smoke's
phase 3 backward (``phase_ssd_bwd``: both entries against ``ssd_bwd_ref``
at ``SSD_BWD_SHAPES``, two calls bit-equal at mamba2-2.7b's train shape
in both dtypes, the bf16 op's time there in a CUDA graph and each of its
kernels alone), then two more timings of the whole bf16 op at that shape.

Run from the root of a tree (the kernels are built from that tree's
sources into its ``build/``), on a machine with a CUDA card:

    python3 tools/time_ssd_bwd.py

Prints the compiler's register and spill lines, phase 3's lines, and one
JSON line: the tree, the card, the shape and three timings of the whole op
in ms (phase 3's first).
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def main() -> None:
    card = smoke.phase_device()
    smoke.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = smoke.phase_ssd_bwd(gen)
    shape = smoke.SSD_BWD_SHAPES[0][0]
    q = min(shape[6], shape[1])
    x, dt, A, B, C, _, dy, _ = smoke._ssd_bwd_inputs(gen, shape,
                                                     torch.bfloat16, False)
    ms = [rec["ms"]] + [smoke.time_ms(
        lambda *a: smoke.ssd_ops.ssd_chunk_scan_bwd(*a, chunk=q),
        [(x, dt, A, B, C, dy)], 3) for _ in range(2)]
    print(json.dumps({"tree": os.getcwd(), "card": card, "shape": shape,
                      "ms": ms}))


if __name__ == "__main__":
    main()
