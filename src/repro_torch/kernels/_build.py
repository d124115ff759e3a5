"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every kernel lives in ``kernels/<name>/csrc/<name>.cu`` with a plain C
interface.  A source is compiled at first use into
``<repo>/build/repro_torch/<name>-<hash>.so`` (the directory is
git-ignored); the hash covers the source and the flags, so an edited
source is rebuilt.  ``build_all`` starts one ``nvcc`` per source, all at
once.  No PyTorch headers are included, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("flash_attention", "decode_attention", "ssd")


def source_path(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return str(path)


def _target(name: str) -> Path:
    h = hashlib.sha256(source_path(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        log = _target(name).with_suffix(".log")
        return log.read_text() if log.exists() else ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return log


def build_all(names=SOURCES) -> dict:
    """Compile every source that is not built yet, in parallel.
    Returns each source's compiler log (ptxas register/spill report)."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, s) for n, s in started.items()}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    _finish(name, _start(name))
    return ctypes.CDLL(str(_target(name)))


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
