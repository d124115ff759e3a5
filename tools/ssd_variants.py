"""Time variant builds of the SSD kernels against each other on one card.

    python3 tools/ssd_variants.py tools/ssd_variants.json [--rounds 2]

The JSON file maps a name to a list of text patches ``[file, old, new]``
(``file`` relative to the repo root, ``old`` found exactly once; ``[]`` is
the tree as it is); ``tools/ssd_variants.json`` holds the design steps and
ablations that PERF.md reports.  Each variant is a copy of ``src/repro_torch`` and
``chip_smoke.py`` in ``build/variants/<name>/`` with its patches applied;
every copy builds its SSD source at once, in parallel.  Then, round by
round, each copy runs in a process of its own and prints one JSON line:
the largest error of its bf16 op against ``ssd_ref`` at mamba2-2.7b's
serving shape (reported, not checked: a variant may leave a part out) and
``chip_smoke.ssd_kernel_times``, its kernels alone and all three.  Needs
one CUDA device and nvcc.
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
BUILD = ("import chip_smoke as cs; "
         "print('\\n'.join(cs.kernel_resources("
         "'ssd', cs._build.build_all(('ssd',))['ssd'])))")
TIME = """
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
"""


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
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    variants = json.loads(args.variants.read_text())
    copies = {name: make_copy(name, patches)
              for name, patches in variants.items()}
    builds = {name: subprocess.Popen([sys.executable, "-c", BUILD], cwd=copy,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
              for name, copy in copies.items()}
    for name, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"build of {name} failed:\n{log}")
        print(json.dumps({"variant": name, "ptxas": log.splitlines()}),
              flush=True)
    for rnd in range(args.rounds):
        for name, copy in copies.items():
            out = subprocess.run([sys.executable, "-c", TIME, name, str(rnd)],
                                 cwd=copy, capture_output=True, text=True)
            if out.returncode:
                raise RuntimeError(f"{name} failed:\n{out.stderr[-3000:]}")
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
