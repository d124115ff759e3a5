"""Time variant builds of a kernel against each other on one card.

    python3 tools/kernel_variants.py tools/ssd_variants.json [--rounds 2]
    python3 tools/kernel_variants.py tools/flash_bwd_variants.json \
        --kernel flash_attention_bwd
    python3 tools/kernel_variants.py tools/ssd_bwd_variants.json \
        --kernel ssd_bwd

The JSON file maps a name to a list of text patches ``[file, old, new]``
(``file`` relative to the repo root, ``old`` found exactly once; ``[]`` is
the tree as it is); ``tools/ssd_variants.json`` and
``tools/flash_bwd_variants.json`` hold the design steps and ablations that
PERF.md reports.  Each variant is a copy of ``src/repro_torch`` and
``chip_smoke.py`` in ``build/variants/<name>/`` with its patches applied;
every copy builds the kernel's source at once, in parallel, and prints its
ptxas lines (registers, spills).  Then, round by round, each copy runs in a
process of its own and prints one JSON line: for ``ssd`` the largest error
of its bf16 op against ``ssd_ref`` at mamba2-2.7b's serving shape (reported,
not checked: a variant may leave a part out) and
``chip_smoke.ssd_kernel_times``; for ``flash_attention_bwd`` its bf16
gradients checked against ``attention_bwd_ref`` over chip_smoke's sweep and
at the training shape (a variant that fails prints why and is dropped) and
``chip_smoke.flash_bwd_kernel_times``; for ``ssd_bwd`` the largest errors
of its bf16 backward against ``ssd_bwd_ref`` at mamba2-2.7b's train shape
(reported, not checked) and ``chip_smoke.ssd_bwd_kernel_times``.  Needs one
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"
BUILD = ("import sys, chip_smoke as cs; n = sys.argv[1]; "
         "print('\\n'.join(cs.kernel_resources(n, cs._build.build_all((n,))[n])))")
TIME = {"ssd": """
import json, sys, torch
import chip_smoke as cs
shape = cs.ssd_serving_shape()
args = cs._ssd_inputs(torch.Generator(device="cuda").manual_seed(0), shape,
                      torch.bfloat16)
y, state = cs.ssd_ops.ssd_chunk_scan(*args, chunk=shape[6])
yr, sr = cs.ssd_ref(*args)
print(json.dumps({"variant": sys.argv[1], "round": int(sys.argv[2]),
                  "max_abs_err": max(cs.max_err(y, yr), cs.max_err(state, sr)),
                  **cs.ssd_kernel_times(args, min(shape[6], shape[1]))}))
""", "flash_attention_bwd": """
import json, sys, torch
import chip_smoke as cs
gen = torch.Generator(device="cuda").manual_seed(0)
if sys.argv[2] == "0":
    for shape in cs.FLASH_SWEEP + [cs.FLASH_RAGGED]:
        cs._flash_bwd_check(gen, shape, torch.bfloat16)
shape = cs.FLASH_MAIN
args, err = cs._flash_bwd_check(gen, shape, torch.bfloat16)
kw = dict(causal=shape[6], window=shape[7], softcap=shape[8])
print(json.dumps({"variant": sys.argv[1], "round": int(sys.argv[2]),
                  "max_abs_err": err, **cs.flash_bwd_kernel_times(args, kw)}))
""", "ssd_bwd": """
import json, sys, torch
import chip_smoke as cs
shape, _ = cs.SSD_BWD_SHAPES[0]
q = min(shape[6], shape[1])
args = cs._ssd_bwd_inputs(torch.Generator(device="cuda").manual_seed(0),
                          shape, torch.bfloat16, False)
x, dt, A, B, C, init, dy, dstate = args
got = cs.ssd_ops.ssd_chunk_scan_bwd(x, dt, A, B, C, dy, chunk=q)
want = cs.ssd_bwd_ref(x, dt, A, B, C, None, dy, None, chunk=q)
errs = {n: cs.max_err(g, w) for n, g, w in zip(cs.SSD_BWD_NAMES, got, want)}
del got, want
torch.cuda.empty_cache()
print(json.dumps({"variant": sys.argv[1], "round": int(sys.argv[2]),
                  "max_abs_err": errs, **cs.ssd_bwd_kernel_times(args, q)}))
"""}


def make_copy(name: str, patches: list) -> Path:
    """build/variants/<name>: the port and chip_smoke.py, patched."""
    copy = OUT / name
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", copy / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", copy / "chip_smoke.py")
    for rel, old, new in patches:
        path = copy / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise ValueError(f"{name}: patch of {rel} does not match once: "
                             f"{old!r}")
        path.write_text(text.replace(old, new))
    return copy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", type=Path)
    ap.add_argument("--kernel", choices=sorted(TIME), default="ssd")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    variants = json.loads(args.variants.read_text())
    copies = {name: make_copy(name, patches)
              for name, patches in variants.items()}
    builds = {name: subprocess.Popen([sys.executable, "-c", BUILD,
                                      args.kernel], cwd=copy,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
              for name, copy in copies.items()}
    for name, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"build of {name} failed:\n{log}")
        print(json.dumps({"variant": name, "ptxas": log.splitlines()}),
              flush=True)
    failed = set()
    for rnd in range(args.rounds):
        for name, copy in copies.items():
            if name in failed:
                continue
            out = subprocess.run([sys.executable, "-c", TIME[args.kernel],
                                  name, str(rnd)],
                                 cwd=copy, capture_output=True, text=True)
            if out.returncode:
                failed.add(name)
                print(json.dumps({"variant": name, "round": rnd,
                                  "failed": out.stderr[-3000:]}), flush=True)
                continue
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
