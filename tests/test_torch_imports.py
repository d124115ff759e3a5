"""The port imports without JAX, msgpack or ml_dtypes (none of them is on
the card's machine) and pulls in nothing of the reference."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    # any `import jax` / `import msgpack` / `import ml_dtypes` now raises
    for blocked in ("jax", "msgpack", "ml_dtypes"):
        sys.modules[blocked] = None
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    bad = sorted(n for n in sys.modules
                 if sys.modules[n] is not None
                 and (n.startswith(("jax", "msgpack", "ml_dtypes"))
                      or n == "repro" or n.startswith("repro.")))
    print(len(names), bad)
    assert not bad, bad
    for want in ("repro_torch.data.pipeline", "repro_torch.data.synth",
                 "repro_torch.optim.adamw", "repro_torch.optim.schedule",
                 "repro_torch.train.loop", "repro_torch.train.trainer",
                 "repro_torch.configs.gemma2_27b",
                 "repro_torch.configs.starcoder2_15b",
                 "repro_torch.configs.chameleon_34b",
                 "repro_torch.configs.whisper_small",
                 "repro_torch.core.health", "repro_torch.core.checkpoint",
                 "repro_torch.core.fleet", "repro_torch.core.daemon"):
        assert want in names, want
    from repro_torch.core import (CheckpointStore, CommitRateEstimator,
                                  DaemonCycleReport, HealthTracker,
                                  LagAwareScheduler, ManualClock, SyncDaemon,
                                  SyncFleet, SystemClock, run_daemon)
    from repro_torch.configs import get_config
    for arch in ("gemma2-27b", "starcoder2-15b", "chameleon-34b",
                 "whisper-small"):
        assert get_config(arch).name == arch
""")


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    r = subprocess.run([sys.executable, "-c", PROBE], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 73, r.stdout


def test_chip_smoke_imports_neither_jax_nor_reference():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)
