"""Time the flash-attention backward kernel at the training shape of
chip_smoke phase 7 (b 4, s 2048, h 32 / kv 4, dh 128, causal, bf16),
with chip_smoke's own correctness check and CUDA-graph timer.

Run from the root of a tree (the kernels are built from that tree's
sources into its ``build/``), on a machine with a CUDA card:

    python3 tools/time_flash_bwd.py

To compare two trees, run it from each root in one session, in the order
parent, change, change, parent.  Prints one JSON line: the tree, the
shape, the max error against the plain version, three timings in ms and,
where the tree's ``chip_smoke.py`` has ``flash_bwd_kernel_times``, each
kernel's time alone.
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def main() -> None:
    smoke.phase_device()
    smoke.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    s = max(smoke.SERVE_PROMPTS)
    shape = (smoke.SERVE_B, s, s, 32, 4, 128, True, 0, 0.0)
    args, err = smoke._flash_bwd_check(gen, shape, torch.bfloat16,
                                       " (training shape)")
    kw = dict(causal=True, window=0, softcap=0.0)
    ms = [smoke.time_ms(
        lambda *a: smoke.flash_ops.flash_attention_bwd(*a, **kw), [args], 5)
        for _ in range(3)]
    # each kernel alone, where the tree's chip_smoke has the timer
    kernels = getattr(smoke, "flash_bwd_kernel_times", None)
    print(json.dumps({"tree": os.getcwd(), "shape": shape,
                      "max_abs_err": err, "ms": ms,
                      "kernels_ms": kernels(args, kw) if kernels else None}))


if __name__ == "__main__":
    main()
