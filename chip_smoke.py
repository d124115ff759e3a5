"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases (each raises on failure, so any failed check exits non-zero):
  1. device   - the card's name and power limit (nvidia-smi)
  2. build    - compile every CUDA source of the port (one nvcc each, in
                parallel)
  3. kernels  - each kernel (flash attention, decode attention, SSD chunk
                scan) against its plain PyTorch version on the card, at the
                Pallas sweep shapes and at the serving shape; times of the
                kernel, the plain version and, where one exists, one PyTorch
                library call (a yardstick the port never calls), beside the
                bound; decode also at batches 1 and 2 of its serving caches;
                the bf16 SSD op (three kernels) as a whole and each of its
                kernels alone; then flash and decode at granite's and
                jamba's served shapes beside SDPA, and the SSD op at jamba's
                widths (8192 heads of head_dim 1), its fp32 entry and each
                bf16 kernel alone
  4. model    - yi-9b, mamba2-2.7b, gemma2-27b (one local / global
                cycle), starcoder2-15b, chameleon-34b and whisper-small (2
                encoder layers, seeded frames) at full width, 2 layers,
                fp32: prefill + 2 decode steps through the kernels, against
                the plain CPU path on the same weights; and gemma2-27b on
                the card alone: a 4,200-token prompt (the window bites, the
                ring wraps) and 2 decode steps against teacher forcing; the
                MoE archs granite-moe-3b-a800m, dbrx-132b and jamba-v0.1-52b
                (its blocks 3 and 4: SSM with MoE, attention) likewise, with
                the router's chosen experts on the card against the CPU's
  5. serve    - yi-9b, then mamba2-2.7b, at full width and depth (bf16,
                random weights from a seeded generator on the card): the
                median of three prefills and each kernel's share of it, 4
                requests through ServeEngine, counting the kernel launches
                of prefill, of the whole generate run and of a teacher-forced
                forward pass; for mamba2-2.7b one prefill and one decode
                step under torch.profiler (the ten device ops that take the
                most time)
  6. lake     - the yi-9b of phase 5 saved as a Hudi checkpoint table
                (LocalFS, in a temporary directory), synced to Iceberg and
                Delta by the port's XTable core, restored through the
                Iceberg view by path, through a read plane and by catalog
                name, and once through the Delta view; every restored
                tensor equal to the saved one, and phase 5's 4 requests
                served from each restored engine with the same tokens and
                kernel launches as from the original weights
  7. train    - yi-9b at full width, 4 layers, bf16 with the fp32 master:
                a lake corpus (Delta) read by LakeDataLoader, trainer A runs
                4 steps (b 4 x s 2048; attention forward and backward in the
                CUDA kernels, 8 forward and 4 backward launches a step),
                commits the train state as a Hudi checkpoint; the port's
                SyncDaemon (checkpoint and catalog blocks on) translates
                that commit to Iceberg and Delta in one run_cycle() and
                group-publishes it to the catalog (its cycle time and the
                staleness, commit to Iceberg head, printed); a second
                daemon warm-restarts from the durable checkpoint, its first
                cycle idle and writing nothing, its next idle cycle one
                request a table; trainer B resumes through the Iceberg view
                at the path the catalog resolves, with every tensor and the
                loader row equal, and its step 4 loss equals A's; A's step
                4 runs under torch.profiler (device time by class of
                kernel, the optimizer's span)
  8. gemma2   - gemma2-27b at full width and depth (46 layers, bf16): the
                kernels at its shapes (flash for a local and a global
                layer, decode for both caches; softcap 50) beside their
                bounds and flex_attention, then 4 requests of 5120 / 4096 /
                3072 / 2048 tokens (cache 6144) served as in phase 5, with
                46 flash launches a prefill and 46 decode a step
  9. whisper  - whisper-small at full width and depth (12 + 12 layers, 1500
                frames, bf16): prefill, greedy decode and teacher forcing
                with seeded frames, one ServeEngine.generate with zero
                frames, 36 flash launches a prefill and 24 decode a step,
                the fp32 decode against teacher forcing (at the init's std:
                agreement held; on block weights at std 1/sqrt(fan-in):
                logits within 2e-3), and the kernels at its shapes
 10. granite  - granite-moe-3b-a800m at full width and depth (32 layers,
                40 experts top 8, bf16) served as in phase 5 at the shipped
                capacity factor (prefill drops tokens): 32 flash launches a
                prefill, 32 decode a step, the decode step as a CUDA graph,
                one prefill and one step profiled, and the fp32 decode
                against teacher forcing at capacity factor 8.0 (on block
                weights at std 1/sqrt(fan-in): agreement and logits within
                2e-3 held)
 11. jamba    - jamba-v0.1-52b at full width, 16 of its 32 layers (bf16,
                ~53 GB) served as in phase 5: 2 flash and 14 SSD launches
                a prefill, 2 decode a step
 12. mesh     - the Sharder on an NCCL group of this one card
                (make_host_mesh: data 1): phase 7's 4-layer yi-9b with its
                params and AdamW state as DTensors; the step-0 gradients
                and 3 train steps against the unsharded model's (2e-3,
                equal flash forward and backward launches, both step times
                printed), phase 5's prefill against the unsharded one
                (2e-2); then the cost model (launch/cost.py, counted on
                meta) for phase 5's yi-9b and mamba2 prefills and phase 7's
                step beside their measured times: model FLOPs, roofline
                time, MFU, and the step's estimated peak memory
Phase 3 also holds the flash-attention backward kernel against its plain
version (autograd through the forward's) and times it at the training
shape, whole and each of its three kernels alone; phase 4 also holds every
gradient of a 2-layer fp32 train step on the card against the CPU's at
2e-3.
The last two lines are the kernels JSON line and the result line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.checkpoint import LSTCheckpointManager, leaf_paths  # noqa: E402
from repro_torch.checkpoint.manager import MAX_CHUNK_BYTES  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (MetadataCache, SyncConfig,  # noqa: E402
                              SyncDaemon, make_target)
from repro_torch.data import LakeDataLoader, write_synth_corpus  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_lse_ref, attention_ref)
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_ref  # noqa: E402
from repro_torch.launch import cost, roofline  # noqa: E402
from repro_torch.lst import FORMATS, LocalFS, chunkfile  # noqa: E402
from repro_torch.lst.catalog import Catalog, TablePointer, ViewRef  # noqa: E402
from repro_torch.lst.storage import layer_fs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import (count_params, init_params,  # noqa: E402
                                      tree_leaves, tree_map)
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serve import Request, ServeEngine, SnapshotServer  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig, make_loss_fn  # noqa: E402
from repro_torch.launch.cells import build_step  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.config import ShapeCell  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.parallel import Sharder  # noqa: E402
from repro_torch.train.loop import make_train_step, train_state_template  # noqa: E402

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM
PEAK_FLOPS = {torch.bfloat16: roofline.PEAK_FLOPS,
              torch.float32: roofline.PEAK_FLOPS_FP32}
PEAK_BYTES = roofline.HBM_BW
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
# fp32 decode against teacher forcing on well-conditioned weights: phase
# 4's logits tolerance
FP32_DECODE_TOL = 2e-3
# (b, sq, sk, h, kv, dh, causal, window, softcap)
FLASH_SWEEP = [
    (2, 256, 256, 4, 2, 64, True, 0, 0.0),
    (1, 256, 256, 4, 4, 128, True, 128, 50.0),
    (2, 128, 384, 8, 2, 64, False, 0, 0.0),
    (1, 384, 384, 2, 1, 128, True, 0, 0.0),
    # the bf16 kernel's edges: sq = sk = 1; causal with sq < sk and ragged
    # tiles over batches; a window and softcap at dh 64 across tile edges
    (1, 1, 1, 2, 1, 64, True, 0, 0.0),
    (2, 100, 300, 8, 2, 128, True, 0, 0.0),
    (3, 131, 131, 4, 4, 128, True, 0, 0.0),
    (1, 300, 300, 4, 2, 64, True, 150, 30.0),
    # the bf16 backward's tiles (dK/dV: 128 keys a block, q tiles of 64;
    # dQ: 128 q rows a block, key tiles of 64): sk one key block - 1 and sq
    # one q block + 1; causal sq < sk with sk one block + 1; a window that
    # crosses q-tile edges; g 8 at dh 128 with b > 1
    (2, 129, 127, 8, 2, 128, False, 0, 0.0),
    (1, 65, 129, 4, 1, 64, True, 0, 0.0),
    (1, 200, 200, 4, 2, 128, True, 70, 0.0),
    (2, 192, 192, 16, 2, 128, True, 0, 0.0),
    # gemma2's window and softcap where the window bites at its length;
    # whisper's encoder rows (1500: no multiple of any tile), non-causal
    (1, 5120, 5120, 4, 2, 128, True, 4096, 50.0),
    (1, 1500, 1500, 4, 4, 64, False, 0, 0.0),
    # granite's heads (24 q / 8 kv: g 3, dh 64) and dbrx's (48 / 8: g 6,
    # dh 128), causal with ragged tails and sq < sk
    (2, 300, 300, 24, 8, 64, True, 0, 0.0),
    (1, 100, 229, 24, 8, 64, True, 0, 0.0),
    (2, 200, 200, 48, 8, 128, True, 0, 0.0),
    (1, 131, 259, 48, 8, 128, True, 0, 0.0),
]
FLASH_RAGGED = (1, 300, 300, 4, 1, 128, True, 0, 0.0)
# (b, S, h, kv, dh, window, softcap)
DECODE_SWEEP = [
    (2, 512, 4, 2, 64, 0, 0.0),
    (2, 512, 4, 4, 128, 128, 0.0),
    (1, 300, 8, 2, 64, 0, 0.0),
    (3, 256, 16, 2, 128, 64, 0.0),
    (2, 300, 32, 2, 128, 0, 0.0),      # 16 query heads per kv head
    (2, 4100, 32, 4, 128, 0, 0.0),     # S not a multiple of the tile
    # softcaps (gemma2: 50) at dh 128 with a window and at dh 64 without
    (2, 512, 4, 4, 128, 128, 50.0),
    (1, 300, 8, 2, 64, 0, 30.0),
    # granite's heads (g 3, dh 64) and dbrx's (g 6, dh 128), ragged caches
    (3, 777, 24, 8, 64, 0, 0.0),
    (2, 1029, 48, 8, 128, 0, 0.0),
]
# (b, s, h, p, g, n, chunk): the Pallas sweep of tests/test_kernels.py
SSD_SWEEP = [
    (2, 128, 4, 16, 1, 32, 32),
    (1, 256, 8, 32, 2, 16, 64),
    (1, 128, 4, 1, 1, 16, 16),
    (2, 192, 6, 8, 3, 8, 64),
    # the bf16 kernels' edges: a chunk that is not a multiple of their
    # 64-row tile; two groups of 20 heads (head tiles of 16 and of 4)
    (1, 300, 4, 64, 1, 128, 100),
    (1, 256, 40, 32, 2, 64, 128),
    # heads' states packed in the bf16 scratch: 24-float states; jamba's
    # head_dim, d_state and chunk over 40 heads
    (1, 128, 5, 3, 1, 8, 32),
    (2, 256, 40, 1, 1, 16, 16),
]
SSD_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}
# the serving shape of phase 5
SERVE_B, SERVE_PROMPTS, SERVE_NEW, SERVE_CACHE = 4, (2048, 1536, 1024, 512), 32, 4096
# flash attention at the serving shape of phase 5 (yi-9b's heads), which is
# also the training shape of phase 7
FLASH_MAIN = (SERVE_B, max(SERVE_PROMPTS), max(SERVE_PROMPTS), 32, 4, 128,
              True, 0, 0.0)
# the training shape of phase 7: yi-9b at full width, cut to 4 layers
TRAIN_LAYERS, TRAIN_B, TRAIN_S = 4, 4, 2048
# phase 8's traffic: gemma2-27b's local layers' window bites in prefill and
# their 4096-slot ring wraps in decode
GEMMA_PROMPTS, GEMMA_NEW, GEMMA_CACHE = (5120, 4096, 3072, 2048), 32, 6144
# phase 9's traffic: whisper-small over 1500 frames
WHISPER_PROMPTS, WHISPER_NEW, WHISPER_CACHE = (32, 24, 16, 8), 64, 128
# phase 11: jamba-v0.1-52b at full width, 16 of its 32 layers (two periods
# of its 8-layer cycle: ~53 GB of bf16 weights; 32 layers would need ~105)
JAMBA_LAYERS = 16
# phase 4's cut of jamba's cycle: its blocks 3 (SSM, MoE) and 4 (attention,
# dense MLP)
JAMBA_BLOCKS = slice(3, 5)
# chosen experts on the card and the CPU may differ only at a near-tie: a
# gap below this between adjacent router probabilities of the first k + 1
ROUTE_TIE = 1e-5
# the counted wrappers, by kernel name
KERNELS = {"flash_attention": flash_ops.flash_attention,
           "decode_attention": decode_ops.decode_attention,
           "ssd_chunk_scan": ssd_ops.ssd_chunk_scan,
           "flash_attention_bwd": flash_ops.flash_attention_bwd}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, args_list, iters: int) -> float:
    """Device time of one ``fn(*args)``: ``iters`` calls, cycling through
    ``args_list`` (distinct buffers keep the L2 cache cold), captured in a
    CUDA graph and timed by CUDA events around one replay, so the host's
    launch overhead does not count."""
    for args in args_list:                  # warm-up outside the capture
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_eager_ms(fn, iters: int) -> float:
    """Device time of one ``fn()`` run eagerly (for work that a CUDA graph
    cannot capture, such as autograd): CUDA events around ``iters`` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def within(out, ref, tol: float) -> bool:
    """|out - ref| <= tol + tol * |ref| everywhere, the criterion of the
    reference's kernel tests (assert_allclose with atol = rtol = tol)."""
    out, ref = out.float(), ref.float()
    return bool(((out - ref).abs() <= tol + tol * ref.abs()).all())


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def zero_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


# ------------------------------------------------------------------ phases
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def kernel_resources(name: str, text: str) -> list:
    """One line per kernel of source ``name``'s ptxas log: its (mangled)
    name, registers, barriers, stack and spills; and any warning that its
    wgmma products are serialised."""
    out, kernel, spills = [], "?", ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif "serialized" in line:
            out.append(f"[{name}] {kernel}: {line.strip()}")
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line:
            out.append(f"[{name}] {kernel}: "
                       f"{line.split(':', 1)[-1].strip()}; {spills}")
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        for line in kernel_resources(name, text):
            log("  " + line)
    log(f"build: {len(logs)} sources in {secs:.1f} s")


def _flash_inputs(gen, shape, dtype):
    b, sq, sk, h, kv, dh = shape[:6]
    dev = torch.device("cuda")
    q = torch.randn((b, sq, h, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, kv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, kv, dh), generator=gen, device=dev).to(dtype)
    return q, k, v


def phase_flash(gen, main_shape) -> dict:
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLASH_SWEEP + [FLASH_RAGGED]:
            q, k, v = _flash_inputs(gen, shape, dtype)
            kw = dict(causal=shape[6], window=shape[7], softcap=shape[8])
            out = flash_ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, **kw)
            err = max_err(out, ref)
            log(f"  flash {shape} {str(dtype)[6:]}: max_abs_err {err:.3g}")
            if not within(out, ref, TOL[dtype]):
                raise AssertionError(f"flash_attention {shape} {dtype}: "
                                     f"err {err} > {TOL[dtype]}")
    dtype = torch.bfloat16
    b, sq, sk, h, kv, dh, causal, window, softcap = main_shape
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = _flash_inputs(gen, main_shape, dtype)
    out = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, **kw)
    err = max_err(out, ref)
    log(f"  flash {main_shape} bfloat16 (serving shape): max_abs_err {err:.3g}")
    if not within(out, ref, TOL[dtype]):
        raise AssertionError(f"flash_attention serving shape: err {err}")

    ms = time_ms(lambda *a: flash_ops.flash_attention(*a, **kw), [(q, k, v)], 20)
    plain_ms = time_ms(lambda *a: attention_ref(*a, **kw), [(q, k, v)], 5)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = time_ms(lambda *a: F.scaled_dot_product_attention(
        *a, is_causal=causal, enable_gqa=True), [(qt, kt, vt)], 10)
    flops, nbytes = cost.flash_work(b, sq, sk, h, kv, dh, causal, window,
                                    q.element_size())
    bms, by = bound_ms(flops, nbytes, dtype)
    rec = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention/kernel.py:81",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=lib_ms)
    log(json.dumps({"kernel_check": rec["name"], "shape": list(main_shape),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_us": bms * 1e3,
                    "flops": flops, "bytes": nbytes,
                    "achieved_tflops": flops / ms / 1e9,
                    "library_tflops": flops / lib_ms / 1e9,
                    "check_launches": flash_ops.flash_attention.launches}))
    return rec


def _flash_bwd_check(gen, shape, dtype, label="") -> tuple:
    """One forward (with the LSE) and one backward launch against the plain
    versions on the same inputs: the LSE against ``attention_lse_ref`` and
    dq, dk, dv against ``attention_bwd_ref`` (autograd through
    ``attention_ref``), each within TOL (abs + rel).  Returns the inputs,
    the forward's outputs and the largest gradient error."""
    b, sq, sk, h, kv, dh, causal, window, softcap = shape
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = _flash_inputs(gen, shape, dtype)
    dout = torch.randn((b, sq, h, dh), generator=gen, device="cuda").to(dtype)
    out, lse = flash_ops.flash_attention_with_lse(q, k, v, **kw)
    grads = flash_ops.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    lse_ref = attention_lse_ref(q, k, **kw)
    if not within(lse, lse_ref, TOL[dtype]):
        raise AssertionError(f"flash lse {shape} {dtype}: err "
                             f"{max_err(lse, lse_ref)}")
    refs = attention_bwd_ref(q, k, v, dout, **kw)
    errs = [max_err(g, r) for g, r in zip(grads, refs)]
    log(f"  flash bwd {shape} {str(dtype)[6:]}{label}: max_abs_err dq "
        f"{errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g}; lse "
        f"{max_err(lse, lse_ref):.3g}")
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        if not (torch.isfinite(g.float()).all() and
                within(g, r, TOL[dtype])):
            raise AssertionError(f"flash_attention_bwd {shape} {dtype} "
                                 f"{name}: err {max_err(g, r)} > {TOL[dtype]}")
    del refs, lse_ref
    return (q, k, v, out, dout, lse), max(errs)


def flash_bwd_kernel_times(args, kw: dict) -> dict:
    """Device ms of each of the bf16 backward's kernels alone, and of all
    three, on one set of buffers (the op allocates its own in every call);
    ``delta`` runs first, so the others read a D it wrote."""
    buffers = flash_ops.bwd_buffers(args[0], args[1])
    stages = {**flash_ops.BWD_STAGES, "all": flash_ops.BWD_ALL_STAGES}
    return {name: time_ms(lambda *a, bit=bit: flash_ops.launch_bwd_bf16(
                *a, buffers, stages=bit, **kw), [args], 5)
            for name, bit in stages.items()}


def phase_flash_bwd(gen, main_shape) -> dict:
    """The backward kernel against its plain version over the sweep and at
    the training shape (both dtypes), then its time at the training shape
    in a CUDA graph, each of its kernels alone, the plain version's time,
    and SDPA's backward (a yardstick the port never calls)."""
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FLASH_SWEEP + [FLASH_RAGGED]:
            _flash_bwd_check(gen, shape, dtype)
    _flash_bwd_check(gen, main_shape, torch.float32, " (training shape)")
    torch.cuda.empty_cache()
    dtype = torch.bfloat16
    args, err = _flash_bwd_check(gen, main_shape, dtype, " (training shape)")
    b, sq, sk, h, kv, dh, causal, window, softcap = main_shape
    kw = dict(causal=causal, window=window, softcap=softcap)
    ms = time_ms(lambda *a: flash_ops.flash_attention_bwd(*a, **kw), [args],
                 5)
    kernels_ms = flash_bwd_kernel_times(args, kw)
    log("  flash bwd bf16 training shape, each kernel alone and all three on "
        "one set of buffers (ms): " + json.dumps(kernels_ms))
    q, k, v, out, dout, lse = args
    plain_ms = time_eager_ms(lambda: attention_bwd_ref(q, k, v, dout, **kw), 2)
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    with torch.enable_grad():
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                            enable_gqa=True)
    dot = dout.transpose(1, 2).contiguous()
    lib_ms = time_eager_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), 10)
    del ot, qt, kt, vt, dot
    # least work: the five products of the backward over the visible pairs,
    # 2.5 x the forward's; bytes: q, k, v, out, dout, lse read, dq, dk, dv
    # written, each once
    flops, nbytes = cost.flash_bwd_work(b, sq, sk, h, kv, dh, causal, window,
                                        q.element_size())
    bms, by = bound_ms(flops, nbytes, dtype)
    rec = dict(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_bwd.cu",
               replaces="src/repro/models/layers.py:101",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=lib_ms)
    log(json.dumps({"kernel_check": rec["name"], "shape": list(main_shape),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_us": bms * 1e3,
                    "flops": flops, "bytes": nbytes,
                    "achieved_tflops": flops / ms / 1e9,
                    "library_tflops": flops / lib_ms / 1e9,
                    "kernels_ms": kernels_ms,
                    "check_launches":
                        flash_ops.flash_attention_bwd.launches}))
    return rec


def _decode_inputs(gen, shape, dtype, lengths):
    b, S, h, kv, dh = shape[:5]
    dev = torch.device("cuda")
    q = torch.randn((b, h, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, S, kv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, S, kv, dh), generator=gen, device=dev).to(dtype)
    return q, k, v, torch.as_tensor(lengths, dtype=torch.int32, device=dev)


def phase_decode(gen, rng, main_shape, main_lengths) -> dict:
    for dtype in (torch.float32, torch.bfloat16):
        for shape in DECODE_SWEEP:
            b, S, _, _, _, window, softcap = shape
            lengths = rng.integers(max(window, 8), S, b)
            if dtype == torch.float32:
                lengths[0] = 0              # an empty sequence gets 0
            q, k, v, lens = _decode_inputs(gen, shape, dtype, lengths)
            kw = dict(window=window, softcap=softcap)
            out = decode_ops.decode_attention(q, k, v, lens, **kw)
            torch.cuda.synchronize()
            ref = decode_attention_ref(q, k, v, lens, **kw)
            err = max_err(out, ref)
            log(f"  decode {shape} {str(dtype)[6:]} lengths "
                f"{lengths.tolist()}: max_abs_err {err:.3g}")
            if not within(out, ref, TOL[dtype]):
                raise AssertionError(f"decode_attention {shape} {dtype}: "
                                     f"err {err} > {TOL[dtype]}")
    dtype = torch.bfloat16
    b, S, h, kv, dh, window, softcap = main_shape
    # distinct caches, > 50 MB together: each launch finds its cache cold in
    # L2, as each layer's cache is on the serving path
    sets = [_decode_inputs(gen, main_shape, dtype, main_lengths)
            for _ in range(4)]
    q, k, v, lens = sets[0]
    out = decode_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q, k, v, lens)
    err = max_err(out, ref)
    log(f"  decode {main_shape} bfloat16 (serving shape) lengths "
        f"{main_lengths.tolist()}: max_abs_err {err:.3g}")
    if not within(out, ref, TOL[dtype]):
        raise AssertionError(f"decode_attention serving shape: err {err}")

    ms = time_ms(decode_ops.decode_attention, sets, 96)
    plain_ms = time_ms(decode_attention_ref, sets, 24)
    pos = torch.arange(S, device="cuda")
    lib_sets = [(q.unsqueeze(2), k.transpose(1, 2).contiguous(),
                 v.transpose(1, 2).contiguous(),
                 (pos[None, :] < ln[:, None])[:, None, None, :])
                for q, k, v, ln in sets]
    sdpa = lambda q, k, v, m: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=m, enable_gqa=True)
    lib_ms = time_ms(sdpa, lib_sets, 96)

    def work(nb):
        """(FLOPs, bytes) of the first ``nb`` sequences."""
        return cost.decode_work(int(np.sum(main_lengths[:nb])), nb, h, kv,
                                dh)

    # the first one and two sequences of the same caches: smaller batches
    # take more, shorter splits (ops.split_plan)
    batches = {}
    for nb in (1, 2):
        sub = [tuple(t[:nb] for t in args) for args in sets]
        out = decode_ops.decode_attention(*sub[0])
        torch.cuda.synchronize()
        ref = decode_attention_ref(*sub[0])
        if not within(out, ref, TOL[dtype]):
            raise AssertionError(f"decode_attention batch {nb}: err "
                                 f"{max_err(out, ref)}")
        nb_flops, nb_bytes = work(nb)
        nb_ms = time_ms(decode_ops.decode_attention, sub, 96)
        nb_lib = time_ms(sdpa, [tuple(t[:nb] for t in args)
                                for args in lib_sets], 96)
        batches[nb] = dict(ms=nb_ms, library_ms=nb_lib,
                           bound_us=bound_ms(nb_flops, nb_bytes, dtype)[0]
                           * 1e3, achieved_GBps=nb_bytes / nb_ms / 1e6,
                           library_GBps=nb_bytes / nb_lib / 1e6)
    flops, nbytes = work(b)
    bms, by = bound_ms(flops, nbytes, dtype)
    rec = dict(name="decode_attention", route="cuda",
               source="src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
               replaces="src/repro/kernels/decode_attention/kernel.py:76",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=lib_ms)
    log(json.dumps({"kernel_check": rec["name"], "shape": list(main_shape),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_us": bms * 1e3,
                    "flops": flops, "bytes": nbytes,
                    "achieved_GBps": nbytes / ms / 1e6,
                    "library_GBps": nbytes / lib_ms / 1e6,
                    "smaller_batches": batches,
                    "check_launches": decode_ops.decode_attention.launches}))
    return rec


def _ssd_inputs(gen, shape, dtype):
    b, s, h, p, g, n = shape[:6]
    dev = torch.device("cuda")
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=dev))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=dev))
    B = torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)
    C = torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)
    return x, dt, A, B, C


def _ssd_check(gen, shape, dtype, label="") -> float:
    """One kernel launch against ssd_ref on the same inputs, y and state
    within SSD_TOL (abs + rel); returns the larger max error."""
    args = _ssd_inputs(gen, shape, dtype)
    y, state = ssd_ops.ssd_chunk_scan(*args, chunk=shape[6])
    torch.cuda.synchronize()
    yr, sr = ssd_ref(*args)
    err = max(max_err(y, yr), max_err(state, sr))
    log(f"  ssd {shape} x/B/C {str(dtype)[6:]}{label}: max_abs_err y "
        f"{max_err(y, yr):.3g} state {max_err(state, sr):.3g}")
    tol = SSD_TOL[dtype]
    if not (within(y, yr, tol) and within(state, sr, tol)):
        raise AssertionError(f"ssd_chunk_scan {shape} {dtype}: err {err} > "
                             f"{tol}")
    return err


def ssd_serving_shape() -> tuple:
    """(b, s, h, p, g, n, chunk) of mamba2-2.7b's prefill in phase 5."""
    c = get_config("mamba2-2.7b").ssm
    return (SERVE_B, max(SERVE_PROMPTS), c.n_heads, c.head_dim, c.n_groups,
            c.d_state, c.chunk)


def ssd_kernel_times(args, q: int) -> dict:
    """Device ms of each of the bf16 SSD op's kernels alone, and of all
    three, on one set of buffers (the op allocates its own in every call)."""
    buffers = ssd_ops.bf16_buffers(args[0], args[3], q)
    stages = {**ssd_ops.STAGES, "all": ssd_ops.ALL_STAGES}
    return {name: time_ms(lambda *a, bit=bit: ssd_ops.launch_bf16(
                *a, q, None, buffers, bit), [args], 10)
            for name, bit in stages.items()}


def phase_ssd(gen, main_shape) -> dict:
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SSD_SWEEP:
            _ssd_check(gen, shape, dtype)
    dtype = torch.bfloat16
    b, s, h, p, g, n, chunk = main_shape
    _ssd_check(gen, main_shape, torch.float32, " (serving shape)")
    err = _ssd_check(gen, main_shape, dtype, " (serving shape)")
    args = _ssd_inputs(gen, main_shape, dtype)       # 100 MB: L2-cold
    # the whole op, all its launches, in one CUDA graph
    ms = time_ms(lambda *a: ssd_ops.ssd_chunk_scan(*a, chunk=chunk), [args],
                 10)
    plain_ms = time_ms(ssd_ref, [args], 1)
    q = min(chunk, s)
    stages_ms = ssd_kernel_times(args, q)
    plan = ssd_ops.bf16_plan(b, s, h, p, g, n, q)
    layout = dict(grids=plan.grids, smem=plan.smem,
                  scratch_bytes=plan.scratch_bytes)
    log(f"  ssd bf16 serving shape, each kernel alone and all three on one "
        f"set of buffers (ms): " + json.dumps(stages_ms))
    flops, nbytes = cost.ssd_work(*main_shape, args[0].element_size())
    bms, by = bound_ms(flops, nbytes, dtype)
    rec = dict(name="ssd_chunk_scan", route="cuda",
               source="src/repro_torch/kernels/ssd/csrc/ssd.cu",
               replaces="src/repro/kernels/ssd/kernel.py:72",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=None)
    log(json.dumps({"kernel_check": rec["name"], "shape": list(main_shape),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, "bound_us": bms * 1e3,
                    "flops": flops, "bytes": nbytes,
                    "achieved_tflops": flops / ms / 1e9,
                    "achieved_GBps": nbytes / ms / 1e6,
                    "kernels_ms": stages_ms, **layout,
                    "check_launches": ssd_ops.ssd_chunk_scan.launches}))
    return rec


def ssd_at(gen, shape) -> dict:
    """The SSD op at one served shape (jamba's: 8192 heads of head_dim 1):
    the bf16 op (three kernels) and the fp32 entry (one kernel) each
    against the plain version, timed in a CUDA graph beside the plain
    version, each bf16 kernel alone, and the bound (bytes: x and y in
    bf16, dt in fp32, B, C and the final state, each once)."""
    b, s, h, p, g, n, chunk = shape
    _ssd_check(gen, shape, torch.float32, " (jamba's served shape)")
    err = _ssd_check(gen, shape, torch.bfloat16, " (jamba's served shape)")
    args = _ssd_inputs(gen, shape, torch.bfloat16)
    args32 = tuple(t.float() for t in args)
    ms = time_ms(lambda *a: ssd_ops.ssd_chunk_scan(*a, chunk=chunk), [args],
                 10)
    f32_ms = time_ms(lambda *a: ssd_ops.ssd_chunk_scan(*a, chunk=chunk),
                     [args32], 5)
    del args32
    plain_ms = time_eager_ms(lambda: ssd_ref(*args), 1)
    q = min(chunk, s)
    stages_ms = ssd_kernel_times(args, q)
    plan = ssd_ops.bf16_plan(b, s, h, p, g, n, q)
    flops, nbytes = cost.ssd_work(*shape, args[0].element_size())
    bms, by = bound_ms(flops, nbytes, torch.bfloat16)
    rec = dict(kernel="ssd_chunk_scan", shape=list(shape), max_abs_err=err,
               ms=ms, f32_entry_ms=f32_ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, flops=flops, bytes=nbytes,
               achieved_GBps=nbytes / ms / 1e6, kernels_ms=stages_ms,
               grids=plan.grids, smem=plan.smem,
               scratch_bytes=plan.scratch_bytes, library_ms=None)
    log("  " + json.dumps(rec))
    return rec


def _layer_kinds(cfg) -> tuple:
    """(flash launches of a prefill or forward pass, decode launches of a
    decode step, SSM layers) of ``cfg``: one flash launch per self-attention
    layer, cross-attention layer and encoder layer; one decode launch per
    self- and cross-attention layer."""
    specs = cfg.layer_specs()
    n_self = sum(spec.kind == "attn" for spec in specs)
    n_cross = sum(spec.cross_attn for spec in specs)
    n_enc = cfg.encoder.n_layers if cfg.encoder else 0
    return n_self + n_cross + n_enc, n_self + n_cross, cfg.n_layers - n_self


def _frames(cfg, b: int, seed: int):
    """Seeded random frame embeddings (b, frames, d_model) fp32 on the host
    for an encoder config (whisper), else None."""
    if not cfg.encoder:
        return None
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32))


def _enc_kw(enc, device, dtype=torch.float32) -> dict:
    return {} if enc is None else {"enc_embeds": enc.to(device, dtype)}


@contextlib.contextmanager
def routing_log():
    """Every router call of the MoE layers (``layers.route``) while the
    block runs, by device: {"cpu": [...], "cuda": [...]}, each call's
    probabilities and chosen experts on the host, in call order."""
    calls = {"cpu": [], "cuda": []}
    route = L.route

    def logged(x, router, k):
        out = route(x, router, k)
        calls[x.device.type].append((out[1].cpu(), out[3].cpu()))
        return out

    L.route = logged
    try:
        yield calls
    finally:
        L.route = route


def compare_routing(calls, k: int) -> tuple:
    """The chosen experts (in order) of each (token, router call) on the
    card against the CPU's -> (pairs compared, pairs that differ, batch
    rows holding such a pair).  Raises unless each pair that differs sits
    at a near-tie: a gap below ROUTE_TIE between two adjacent CPU
    probabilities among the first k + 1."""
    cpu, card = calls["cpu"], calls["cuda"]
    if len(cpu) != len(card) or not cpu:
        raise AssertionError(f"router calls: {len(cpu)} on the CPU, "
                             f"{len(card)} on the card")
    pairs, differ, rows = 0, 0, set()
    for (probs, e_cpu), (_, e_card) in zip(cpu, card):
        diff = (e_cpu != e_card).any(-1)                          # (G, S)
        pairs += diff.numel()
        if not diff.any():
            continue
        top = probs.sort(-1, descending=True).values[..., :k + 1]
        gap = (top[..., :-1] - top[..., 1:]).min(-1).values
        if not bool((gap[diff] < ROUTE_TIE).all()):
            raise AssertionError(f"the card chose other experts than the CPU "
                                 f"away from a near-tie (gaps "
                                 f"{gap[diff].tolist()})")
        differ += int(diff.sum())
        rows.update(diff.any(-1).nonzero().flatten().tolist())
    return pairs, differ, rows


def phase_model(arch: str, seed: int, s: int, fan_in_std: bool = False,
                blocks: slice | None = None) -> None:
    """Full width, 2 layers, fp32: kernels on the card vs the plain CPU path.
    An encoder config (whisper) takes 2 encoder layers and seeded random
    frame embeddings.  ``fan_in_std`` draws the block weights at std
    1/sqrt(fan-in) (``well_conditioned``): at whisper-small's 2 layers the
    init's std 1/sqrt(2) gives encoder attention scores of std ~380, where
    fp32 on the CPU is itself 5.1e-3 from float64 (ROADMAP C-k,
    ``tools/logits_fp64.py``).  ``blocks`` cuts a longer cycle (jamba's 8)
    to two of its blocks.

    Tolerance 2e-3 on the logits, the reference's own tolerance between two
    attention paths (tests/test_models.py): both sides are fp32 (TF32 off),
    and only the order of the sums differs (cuBLAS and the kernels' tiling
    against the CPU's BLAS and plain attention / chunked SSD).  An MoE
    config runs at its shipped capacity factor (prefill drops tokens), and
    its chosen experts are compared call by call (``compare_routing``): a
    batch row where a near-tie chose other experts is left out of the
    logits comparison, and counted."""
    cfg = get_config(arch)
    if blocks is not None:
        cfg = replace(cfg, cycle=cfg.cycle[blocks])
    cfg = replace(cfg, n_layers=2, dtype="float32")
    if cfg.encoder:
        cfg = replace(cfg, encoder=replace(cfg.encoder, n_layers=2))
    tol = 2e-3
    cpu = Model(cfg, device="cpu")
    card = Model(cfg)
    tpl = cpu.param_template()
    p_cpu = init_params(well_conditioned(tpl) if fan_in_std else tpl,
                        torch.Generator().manual_seed(seed), device="cpu")
    p_card = _to(p_cpu, card.device)
    rng = np.random.default_rng(seed)
    b = 2
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 2)))
    enc = _frames(cfg, b, seed + 1)
    zero_counts()
    logits = []
    with routing_log() as calls:
        l_cpu, c_cpu = cpu.prefill(p_cpu, toks[:, :s], cache_len=s + 8,
                                   **_enc_kw(enc, "cpu"))
        l_card, c_card = card.prefill(p_card, toks[:, :s].cuda(),
                                      cache_len=s + 8, **_enc_kw(enc, "cuda"))
        logits.append((l_card.cpu(), l_cpu))
        for t in range(s, s + 2):
            pos = torch.full((b,), t)
            l_cpu, c_cpu = cpu.decode_step(p_cpu, c_cpu, toks[:, t], pos)
            l_card, c_card = card.decode_step(p_card, c_card,
                                              toks[:, t].cuda(), pos.cuda())
            logits.append((l_card.cpu(), l_cpu))
    torch.cuda.synchronize()
    launches = counts()
    routing = ""
    keep = list(range(b))
    if cfg.n_experts:
        pairs, differ, rows = compare_routing(calls, cfg.top_k)
        keep = [i for i in keep if i not in rows]
        routing = (f"; routing: {differ} of {pairs} (token, router call) "
                   f"pairs chose other experts on the card (near-ties), rows "
                   f"left out {sorted(rows)}")
        if not keep:
            raise AssertionError(f"{arch}: every row holds a near-tie")
    errs = [max_err(lc[keep], lp[keep]) for lc, lp in logits]
    n_flash, n_decode, n_ssm = _layer_kinds(cfg)
    want = {"flash_attention": n_flash, "decode_attention": 2 * n_decode,
            "ssd_chunk_scan": n_ssm, "flash_attention_bwd": 0}
    log(f"  model {arch} width {cfg.d_model}, 2 layers, fp32, b={b}, "
        f"prompt {s}: logits max_abs_err prefill {errs[0]:.3g}, decode "
        f"{errs[1]:.3g} {errs[2]:.3g} (tol {tol}); launches {launches}"
        f"{routing}")
    if not max(errs) <= tol:
        raise AssertionError(f"{arch} model logits differ: {errs} > {tol}")
    if launches != want:
        raise AssertionError(f"{arch} model launches {launches}, want {want}")


def _loss_and_grads(model, params, batch) -> tuple:
    """The train loss of ``model`` at ``params`` (moved to its device) on
    ``batch`` and every parameter's gradient, on the host."""
    live = tree_map(lambda t: t.to(model.device).requires_grad_(True),
                    params)
    loss, _ = make_loss_fn(model, ce_chunk=128)(
        live, {k: t.to(model.device) for k, t in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return float(loss.detach()), [g.cpu() for g in grads]


def well_conditioned(tpl):
    """``tpl`` with every stacked block weight drawn at std 1/sqrt(fan-in)
    (the contracted dims: ``embed`` in, or all but ``embed`` out; an
    expert weight's ``experts`` axis is not one of them), where the init's
    own std 1/sqrt(layers) saturates attention (ROADMAP C-k).  A leaf with
    a scale of its own (the router's 0.02) keeps it."""
    def fix(spec):
        if spec.axes[:1] != ("layers",) or spec.init != "normal" \
                or spec.scale is not None:
            return spec
        dims = [n for n, a in zip(spec.shape, spec.axes)
                if a not in ("layers", "experts")]
        fan_in = (int(np.prod(dims[:-1])) if spec.axes[-1] == "embed"
                  else dims[0])
        return replace(spec, scale=fan_in ** -0.5)
    return tree_map(fix, tpl)


def phase_model_grads(seed: int, s: int = 128) -> None:
    """Full width, 2 layers, fp32: the loss and every parameter's gradient
    of the train loss on the card (flash forward and backward kernels,
    per-cycle remat) against the plain CPU path on the same weights and
    batch (b 1), block weights at std 1/sqrt(fan-in) (``well_conditioned``).

    Tolerance 2e-3, phase 4's on the logits: the loss within 2e-3, and each
    gradient within 2e-3 and within 2e-3 of its largest entry:
    max |g_card - g_cpu| <= 2e-3 min(1, max |g_cpu|)."""
    cfg = replace(get_config("yi-9b"), n_layers=2, dtype="float32")
    tol = 2e-3
    p_cpu = init_params(well_conditioned(Model(cfg, device="cpu")
                                         .param_template()),
                        torch.Generator().manual_seed(seed), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, s + 1)))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    zero_counts()
    card = _loss_and_grads(Model(cfg), p_cpu, batch)
    torch.cuda.synchronize()
    launches = counts()
    cpu = _loss_and_grads(Model(cfg, device="cpu"), p_cpu, batch)
    names = [n for n, _ in leaf_paths(p_cpu)]
    rows = {n: dict(err=max_err(gc, gp), max=float(gp.abs().max()))
            for n, gc, gp in zip(names, card[1], cpu[1])}
    loss_err = abs(card[0] - cpu[0])
    want = {"flash_attention": 2 * cfg.n_layers, "decode_attention": 0,
            "ssd_chunk_scan": 0, "flash_attention_bwd": cfg.n_layers}
    log(f"  train step yi-9b width {cfg.d_model}, 2 layers, fp32, b 1, s {s}: "
        f"loss card {card[0]:.6f} cpu {cpu[0]:.6f} (|card - cpu| "
        f"{loss_err:.3g}, tol {tol}); launches {launches}")
    log("  train step gradients, max |g_card - g_cpu| and max |g_cpu| by "
        "leaf: " + json.dumps(rows))
    if not loss_err <= tol:
        raise AssertionError(f"train loss differs: {loss_err} > {tol}")
    for n, r in rows.items():
        if not r["err"] <= tol * min(1.0, r["max"]):
            raise AssertionError(f"gradient {n} on the card misses the CPU's "
                                 f"by {r['err']} (max |g| {r['max']})")
    if launches != want:
        raise AssertionError(f"train step launches {launches}, want {want}")


def phase_window_fp32(seed: int, s: int = 4200, steps: int = 2) -> None:
    """gemma2-27b at full width, 2 layers (one local / global cycle), fp32,
    on the card alone (the CPU would take minutes): prefill of a
    ``s``-token prompt, whose local layer's window bites in the flash kernel
    and whose 4096-slot ring wraps, then ``steps`` decode steps, against the
    teacher-forced forward pass over the same tokens, at 2e-3."""
    cfg = replace(get_config("gemma2-27b"), n_layers=2, dtype="float32")
    tol = 2e-3
    model = Model(cfg)
    params = init_params(model.param_template(),
                         torch.Generator(device="cuda").manual_seed(seed))
    b = 2
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + steps))).cuda()
    zero_counts()
    logits, cache = model.prefill(params, toks[:, :s], cache_len=s + steps)
    dec = [logits]
    for t in range(s, s + steps):
        logits, cache = model.decode_step(params, cache, toks[:, t],
                                          torch.full((b,), t, device="cuda"))
        dec.append(logits)
    full, _ = model.forward(params, toks)
    torch.cuda.synchronize()
    launches = counts()
    errs = [max_err(d, full[:, s - 1 + i]) for i, d in enumerate(dec)]
    want = {"flash_attention": 2 * cfg.n_layers,
            "decode_attention": steps * cfg.n_layers, "ssd_chunk_scan": 0,
            "flash_attention_bwd": 0}
    log(f"  window check gemma2-27b width {cfg.d_model}, 2 layers, fp32, "
        f"b={b}, prompt {s} (window {cfg.cycle[0].window}, ring "
        f"{cache['s0']['k'].shape[2]} slots): prefill and decode vs teacher "
        f"forcing max_abs_err {[f'{e:.3g}' for e in errs]} (tol {tol}, "
        f"logits std {float(full[:, s - 1:].std()):.4g}); launches {launches}")
    if not max(errs) <= tol:
        raise AssertionError(f"gemma2 window check: {errs} > {tol}")
    if launches != want:
        raise AssertionError(f"gemma2 window check launches {launches}, "
                             f"want {want}")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def decode_vs_forward_fp32(cfg, params, toks, steps: int = 8,
                           enc=None, min_agreement=0.5, max_diff=None,
                           prefix: str = "fp32_") -> dict:
    """Greedy decode from the prefill cache against the teacher-forced
    forward pass over the same tokens, at full depth in fp32 (``params``
    widened: the served bf16 weights; ``enc``: an encoder config's frame
    embeddings).  In bf16 the two paths round at different places (the SSD
    kernel returns y in bf16 before the skip term is added, the decode step
    adds it in fp32), and many layers of random weights amplify that; in
    fp32 only the order of the sums differs.  The agreement of the greedy
    tokens must reach ``min_agreement`` (None: reported only), and the
    logits' max |diff| must stay within ``max_diff`` (None: reported only;
    ``FP32_DECODE_TOL`` on well-conditioned weights).  An MoE
    config runs at capacity factor 8.0, where no token drops
    (``tests/test_models.py``'s setting): a prefill, a decode step and a
    teacher-forced pass of other lengths would otherwise drop other tokens;
    the (decode token, MoE layer) pairs whose chosen experts differ from
    the teacher-forced pass's are counted."""
    model = Model(replace(cfg, dtype="float32", capacity_factor=8.0))
    p32 = tree_map(lambda t: t.float(), params)
    b, s = toks.shape
    kw = _enc_kw(enc, "cuda")
    zero_counts()
    with routing_log() as calls:
        logits, cache = model.prefill(p32, toks, cache_len=s + steps, **kw)
        dec = [logits]
        for i in range(steps - 1):
            tok = torch.argmax(dec[-1], -1)
            logits, cache = model.decode_step(
                p32, cache, tok, torch.full((b,), s + i, device="cuda"))
            dec.append(logits)
        dec = torch.stack(dec, 1)                             # (b, steps, V)
        gen = torch.argmax(dec[:, :-1], -1)
        full, _ = model.forward(p32, torch.cat([toks, gen], 1), **kw)
    ref = full[:, s - 1:]
    torch.cuda.synchronize()
    out = {f"{prefix}decode_vs_forward_max_abs_diff": max_err(dec, ref),
           f"{prefix}logits_std": float(ref.std()),
           f"{prefix}teacher_forcing_agreement": float(
               (torch.argmax(ref, -1) == torch.argmax(dec, -1))
               .float().mean()),
           f"{prefix}launches": counts()}
    n_moe = sum(spec.moe for spec in cfg.layer_specs())
    if n_moe:
        routes = [e for _, e in calls["cuda"]]
        fwd = routes[-n_moe:]
        differ = sum(int((routes[n_moe * (i + 1) + m][:, 0]
                          != fwd[m][:, s + i]).any(-1).sum())
                     for i in range(steps - 1) for m in range(n_moe))
        out[f"{prefix}decode_routing_differs"] = [differ,
                                                  b * (steps - 1) * n_moe]
    log(f"  serve: fp32, {cfg.n_layers} layers: " + json.dumps(out))
    agree = out[f"{prefix}teacher_forcing_agreement"]
    if min_agreement is not None and not agree >= min_agreement:
        raise AssertionError(f"fp32 decode disagrees with teacher forcing: "
                             f"{out}")
    diff = out[f"{prefix}decode_vs_forward_max_abs_diff"]
    if max_diff is not None and not diff <= max_diff:
        raise AssertionError(f"fp32 decode logits differ from teacher "
                             f"forcing by {diff} > {max_diff}: {out}")
    return out


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", None) \
        or getattr(e, "self_cuda_time_total", 0.0)


def device_profile(fn) -> tuple:
    """``fn()`` once under ``torch.profiler`` -> (its result, the device ops
    (kernels and copies) with device time, the wall ms).  Raises if the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda and _device_us(e) > 0]
    if not events:
        raise AssertionError("torch.profiler recorded no device time")
    return out, events, wall_ms


def _profile_summary(events, wall_ms: float) -> dict:
    """Device busy time against the wall time, and the ten device ops that
    take the most of it."""
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    top = sorted(events, key=_device_us, reverse=True)[:10]
    return dict(profile_wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                top10=[dict(name=e.key[:100], calls=e.count,
                            ms=_device_us(e) / 1e3,
                            share=_device_us(e) / 1e3 / busy_ms)
                       for e in top])


def profile_prefill(model, params, toks, cache_len: int) -> dict:
    """One prefill under ``torch.profiler``: the device's busy time against
    the wall time, and the ten device ops (kernels and copies) that take the
    most of it.  Raises if the profiler records no device time."""
    _, events, wall_ms = device_profile(
        lambda: model.prefill(params, toks, cache_len=cache_len))
    out = _profile_summary(events, wall_ms)
    log("  profile of one prefill: " + json.dumps(out))
    return out


# device kernels of a train step by class, from their names: cuBLAS and
# CUTLASS products, the port's flash kernels, and the rest (elementwise,
# reductions, copies: the optimizer, norms, RoPE, casts, the CE's softmax)
STEP_CLASSES = (("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
                ("flash_forward", ("flash_fwd",)),
                ("flash_backward", ("bwd_dkdv", "bwd_dq", "bwd_delta")))


def profile_train_step(step_fn, params, opt_state, batch) -> tuple:
    """One train step under ``torch.profiler`` -> (the step's result, its
    split): device busy time against the wall time, device ms by
    ``STEP_CLASSES``, the optimizer's device span (CUDA events around
    ``adamw_update``, which the step calls last) and the ten costliest
    device ops.  Raises if the profiler records no device time."""
    import repro_torch.train.loop as train_loop

    update, spans = train_loop.adamw_update, []

    def timed_update(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        out = update(*args, **kw)
        end.record()
        spans.append((start, end))
        return out

    train_loop.adamw_update = timed_update
    try:
        out, events, wall_ms = device_profile(
            lambda: step_fn(params, opt_state, batch))
    finally:
        train_loop.adamw_update = update
    split = _profile_summary(events, wall_ms)
    by_class = {name: 0.0 for name, _ in STEP_CLASSES}
    by_class["other"] = 0.0
    for e in events:
        key = e.key.lower()
        name = next((n for n, marks in STEP_CLASSES
                     if any(m in key for m in marks)), "other")
        by_class[name] += _device_us(e) / 1e3
    split["device_ms_by_class"] = by_class
    split["optimizer_device_span_ms"] = \
        sum(s.elapsed_time(e) for s, e in spans)
    return out, split


def phase_serve(arch: str, seed: int, kernel_ms: dict, *,
                prompts=SERVE_PROMPTS, new: int = SERVE_NEW,
                cache_len: int = SERVE_CACHE, min_agreement=0.5, fp32_check: bool = False,
                profile: bool = False, keep: dict | None = None,
                layers: int | None = None) -> dict:
    """Serve one request per prompt length in ``prompts``, ``new`` tokens
    each, at full width and depth (``layers``: cut to that depth) in bf16.
    The decode step is replayed as a CUDA graph.  Greedy decode must agree with
    teacher forcing on ``min_agreement`` of the tokens (None: reported
    only); the teacher-forced forward runs as many requests at a time as
    keep its fp32 logits within 8 GB (gemma2: one).  ``fp32_check`` adds
    ``decode_vs_forward_fp32``.  ``kernel_ms`` (kernel times by name) gives
    each kernel's share of prefill: launches x time / prefill seconds.
    ``profile`` adds one prefill (``profile_prefill``) and one decode step
    under ``torch.profiler``, after the timed runs.  ``keep`` receives the
    model, its weights, the requests and the served tokens, for phase 6."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = replace(cfg, n_layers=layers)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = init_params(model.param_template(),
                         torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    log(f"  serve: {arch} {count_params(model.param_template()):,} params "
        f"bf16, {cfg.n_layers} layers, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size - 1, n).tolist()
               for n in prompts]
    reqs = [Request(p, new) for p in prompts]
    engine = ServeEngine(model, params, cache_len=cache_len)
    n_flash, n_decode, n_ssm = _layer_kinds(cfg)
    decode_steps = new - 1
    b, s = len(prompts), max(len(p) for p in prompts)

    # prefills of the same batch: the median time of three, the launches of
    # one and the greedy token
    toks = np.full((b, s), cfg.vocab_size - 1, np.int64)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p
    toks = torch.from_numpy(toks).cuda()
    times = []
    for _ in range(3):
        first_logits = None
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first_logits, _ = model.prefill(params, toks, cache_len=cache_len)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        prefill_launches = counts()
    prefill_s = float(np.median(times))
    first = torch.argmax(first_logits, -1).tolist()

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(reqs)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = counts()

    decode_s = total_s - prefill_s
    shares = {name: prefill_launches[name] * kernel_ms[name] / 1e3 / prefill_s
              for name in kernel_ms if prefill_launches.get(name)}
    stats = dict(prompts=[len(p) for p in prompts], new_tokens=new,
                 cache_len=cache_len, prefill_s=prefill_s,
                 prefill_runs_s=times, generate_s=total_s,
                 decode_tok_per_s=b * decode_steps / decode_s,
                 decode_step_ms=decode_s / decode_steps * 1e3,
                 prefill_tok_per_s=b * s / prefill_s,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 prefill_launches=prefill_launches,
                 prefill_kernel_share=shares, launches=launches)
    log(f"  serve {arch}: " + json.dumps(stats))

    if [len(o) for o in outs] != [new] * b:
        raise AssertionError(f"serve: token counts {[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("serve: token id out of range")
    if [o[0] for o in outs] != first:
        raise AssertionError(f"serve: first tokens {[o[0] for o in outs]} "
                             f"!= greedy prefill tokens {first}")
    want_prefill = {"flash_attention": n_flash, "decode_attention": 0,
                    "ssd_chunk_scan": n_ssm, "flash_attention_bwd": 0}
    want = dict(want_prefill, decode_attention=n_decode * decode_steps)
    if prefill_launches != want_prefill:
        raise AssertionError(f"serve: prefill launches {prefill_launches}, "
                             f"want {want_prefill}")
    if launches != want:
        raise AssertionError(f"serve: launches {launches}, want {want}")

    # teacher forcing over prompt + generated tokens: greedy decode should
    # pick the argmax of the full forward pass at each position
    gen = torch.tensor([o[:-1] for o in outs], device="cuda")
    seq = torch.cat([toks, gen], 1)
    rows = max(1, min(b, int(8e9 // (seq.shape[1] * cfg.vocab_size * 4))))
    zero_counts()
    tf = []
    for i in range(0, b, rows):
        full, _ = model.forward(params, seq[i:i + rows])
        tf.append(full[:, s - 1:].clone())
        del full
    tf = torch.cat(tf)                                   # (b, new, V)
    torch.cuda.synchronize()
    tf_launches = counts()
    want_tf = {k: v * (-(-b // rows)) for k, v in want_prefill.items()}
    if tf_launches != want_tf:
        raise AssertionError(f"serve: teacher-forced forward launches "
                             f"{tf_launches}, want {want_tf}")
    agree = float((torch.argmax(tf, -1).cpu() == torch.tensor(outs))
                  .float().mean())
    log(f"  serve: teacher-forced forward over {seq.shape[1]} tokens, "
        f"{rows} rows a pass, launches {tf_launches}; decode vs "
        f"teacher-forcing greedy agreement {agree:.4f}")
    if min_agreement is not None and not agree >= min_agreement:
        raise AssertionError(f"serve: decode disagrees with teacher forcing "
                             f"({agree})")
    stats["teacher_forcing_agreement"] = agree

    # one decode step from a fresh prefill's cache, eager (as served)
    # against the same step replayed from a CUDA graph (device time alone):
    # their gap is host overhead
    _, warm_cache = model.prefill(params, toks, cache_len=cache_len)
    tok = torch.tensor(first, device="cuda")
    pos = torch.full((b,), s, device="cuda")
    step = lambda: model.decode_step(params, warm_cache, tok, pos)  # noqa: E731
    step_logits, _ = step()
    gap = float((step_logits - tf[:, 1]).abs().max())
    log(f"  serve: bf16 logits, decode step vs teacher forcing at position "
        f"{s}: max_abs_diff {gap:.4g} (logits std {float(tf[:, 1].std()):.4g})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / 5 * 1e3
    graph_ms = time_ms(step, [()], 5)
    stats.update(decode_step_eager_ms=eager_ms, decode_step_device_ms=graph_ms,
                 decode_step_idle_share=1.0 - graph_ms / eager_ms)
    log(f"  serve: decode step eager {eager_ms:.2f} ms, device (CUDA graph) "
        f"{graph_ms:.2f} ms, idle share {1.0 - graph_ms / eager_ms:.3f}")
    if profile:                       # after every timed run: the profiler
        stats["prefill_profile"] = profile_prefill(model, params, toks,
                                                   cache_len)
        stats["decode_profile"] = _profile_summary(*device_profile(step)[1:])
        log("  profile of one decode step: "
            + json.dumps(stats["decode_profile"]))
    if fp32_check:
        del tf, warm_cache, step_logits
        torch.cuda.empty_cache()
        if cfg.n_experts:
            # at the init's std (ROADMAP C-k) attention saturates, and a
            # decode step's rounding moves a token's router across a
            # near-tie; the changed expert changes the token, and the rows
            # attending to it: reported.  Held: block weights at std
            # 1/sqrt(fan-in), as phase 4's
            stats.update(decode_vs_forward_fp32(cfg, params, toks,
                                                min_agreement=None,
                                                prefix="fp32_init_std_"))
            torch.cuda.empty_cache()
            tpl = well_conditioned(Model(replace(cfg, dtype="float32"))
                                   .param_template())
            held = init_params(tpl, torch.Generator(device="cuda")
                               .manual_seed(seed))
            stats.update(decode_vs_forward_fp32(cfg, held, toks,
                                                max_diff=FP32_DECODE_TOL))
        else:
            held = params
            stats.update(decode_vs_forward_fp32(cfg, held, toks))
        del held
    if keep is not None:
        keep.update(model=model, params=params, reqs=reqs, outs=outs)
    return stats


def _register_iceberg_head(fs, path: str, root: Path):
    """A catalog (under ``root``) whose pointer ``ckpt`` pins the current
    Iceberg head of ``path``, and a read plane on the same metadata cache:
    what a sync daemon's catalog publish leaves for a serving fleet."""
    cache = MetadataCache(fs)
    idx = cache.index("iceberg", path)
    token = idx.probe()
    idx.refresh_to(token)
    head, _ = idx.pinned_state()
    idx.end_cycle()
    catalog = Catalog(fs, str(root / "catalog"))
    catalog.register_table(
        TablePointer(name="ckpt", base_path=path, source_format="iceberg",
                     views={"iceberg": ViewRef(token, head)}),
        group="serving")
    return catalog, SnapshotServer(fs, cache=cache)


def lake_breakdown(name: str, leaf: torch.Tensor, root: Path) -> dict:
    """Seconds of each stage the checkpoint manager runs to save and
    restore one bf16 leaf, each stage timed alone: the copy to the host,
    serializing its chunks (stats, copies), writing them (LocalFS, with
    fsync), reading them back, decoding them into one buffer, and the copy
    to the card.  The bytes are checked to come back equal."""
    fs, out = LocalFS(), {"leaf": name, "bytes": leaf.numel() * 2}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = leaf.cpu()
    out["d2h_s"] = time.perf_counter() - t0
    flat = host.view(torch.int16).numpy().view(np.uint16).reshape(-1)
    n = max(1, -(-flat.nbytes // MAX_CHUNK_BYTES))
    per = -(-flat.size // n)
    t0 = time.perf_counter()
    payloads = [chunkfile.serialize_chunk({"tensor": flat[i * per:
                                                         (i + 1) * per]})[0]
                for i in range(n)]
    out["serialize_s"] = time.perf_counter() - t0
    paths = [str(root / "breakdown" / f"{i:03d}.chunk") for i in range(n)]
    t0 = time.perf_counter()
    for path, payload in zip(paths, payloads):
        fs.write_bytes(path, payload)
    out["write_s"] = time.perf_counter() - t0
    del payloads
    t0 = time.perf_counter()
    blobs = [fs.read_bytes(path) for path in paths]
    out["read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, pos = np.empty(flat.size, np.uint16), 0
    for blob in blobs:
        part = chunkfile._parse_full(blob)[0]["tensor"]
        back[pos:pos + part.size] = part
        pos += part.size
    out["decode_s"] = time.perf_counter() - t0
    del blobs
    t0 = time.perf_counter()
    card = torch.from_numpy(back.view(np.int16)).view(torch.bfloat16) \
        .reshape(leaf.shape).to(leaf.device)
    torch.cuda.synchronize()
    out["h2d_s"] = time.perf_counter() - t0
    if not torch.equal(card, leaf):
        raise AssertionError(f"lake breakdown: {name} came back different")
    out["chunks"] = n
    return out


def phase_lake(kept: dict, card: str, want_launches: dict) -> dict:
    """Save phase 5's yi-9b (its bf16 weights on the card) as a Hudi
    checkpoint, sync it to Iceberg and Delta, and restore it through
    ``ServeEngine.from_lake`` by path, read plane and catalog name (Iceberg)
    and by path (Delta).  Every restored tensor must equal the saved one on
    the card; each restored engine serves phase 5's requests, whose tokens
    and kernel launches (``want_launches``) must equal phase 5's.  Then the
    largest leaf's stages alone (``lake_breakdown``).  The checkpoint lives
    in a temporary directory, removed at the end."""
    model, params = kept["model"], kept["params"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_lake_"))
    try:
        fs = LocalFS()
        path = str(root / "ckpt")
        mgr = LSTCheckpointManager(fs, path, fmt="hudi",
                                   sync_targets=("iceberg", "delta"),
                                   async_sync=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(0, {"params": params})
        save_s = time.perf_counter() - t0
        mgr.wait_for_sync()
        sync_s = time.perf_counter() - t0 - save_s
        files = mgr.handle.snapshot().files
        nbytes = sum(f.size_bytes for f in files.values())
        for fmt in ("iceberg", "delta"):
            view = FORMATS[fmt].open(fs, path).snapshot().files
            if sorted(view) != sorted(files):
                raise AssertionError(f"lake: the {fmt} view lists other "
                                     f"files than the Hudi table")
        stats = dict(depth=model.cfg.n_layers, checkpoint_bytes=nbytes,
                     chunks=len(files), save_s=save_s,
                     save_GBps=nbytes / save_s / 1e9, sync_s=sync_s)
        log(f"  lake: {model.cfg.name} {model.cfg.n_layers} layers "
            f"{model.cfg.dtype}, checkpoint "
            f"{nbytes:,} bytes in {len(files)} chunks; save {save_s:.2f} s "
            f"({nbytes / save_s / 1e9:.3f} GB/s), sync to iceberg + delta "
            f"{sync_s:.3f} s; card {card}")

        catalog, catalog_plane = _register_iceberg_head(fs, path, root)
        routes = {
            "iceberg_path": dict(ckpt_path=path, fmt="iceberg"),
            "iceberg_read_plane": dict(ckpt_path=path, fmt="iceberg",
                                       read_plane=SnapshotServer(fs)),
            "iceberg_catalog": dict(fmt="iceberg", read_plane=catalog_plane,
                                    catalog=catalog, table="ckpt"),
            "delta_path": dict(ckpt_path=path, fmt="delta"),
        }
        saved = leaf_paths(params)
        for route, kw in routes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine = ServeEngine.from_lake(model, fs, cache_len=SERVE_CACHE,
                                           **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = leaf_paths(engine.params)
            if [n for n, _ in got] != [n for n, _ in saved]:
                raise AssertionError(f"lake {route}: leaf names differ")
            for (name, a), (_, b) in zip(saved, got):
                if b.device != a.device or not torch.equal(a, b):
                    raise AssertionError(f"lake {route}: {name} differs")
            zero_counts()
            outs = engine.generate(kept["reqs"])
            torch.cuda.synchronize()
            launches = counts()
            stats[f"restore_{route}_s"] = secs
            stats[f"restore_{route}_GBps"] = nbytes / secs / 1e9
            log(f"  lake: restore {route} {secs:.2f} s "
                f"({nbytes / secs / 1e9:.3f} GB/s), {len(saved)} tensors "
                f"equal; served launches {launches}; card {card}")
            if outs != kept["outs"]:
                raise AssertionError(f"lake {route}: served tokens differ "
                                     f"from the original weights'")
            if launches != want_launches:
                raise AssertionError(f"lake {route}: launches {launches}, "
                                     f"want {want_launches}")
            del engine, got
            torch.cuda.empty_cache()
        name, leaf = max(saved, key=lambda kv: kv[1].numel())
        stats["breakdown"] = lake_breakdown(name, leaf, root)
        log("  lake: one leaf's stages alone: " +
            json.dumps(stats["breakdown"]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the host's high-water mark over the whole run so far (Linux: KiB)
    stats["host_peak_rss_gib"] = \
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log("  lake: " + json.dumps(stats))
    return stats


def _equal_states(a, b) -> int:
    """Raise unless every tensor of trainer b's state equals trainer a's
    (same names, device and values); returns the tensor count."""
    want = leaf_paths({"params": a.params, "opt": a.opt_state})
    got = leaf_paths({"params": b.params, "opt": b.opt_state})
    if [n for n, _ in got] != [n for n, _ in want]:
        raise AssertionError("train: restored leaf names differ")
    for (name, x), (_, y) in zip(want, got):
        if y.device != x.device or y.dtype != x.dtype or \
                not torch.equal(x, y):
            raise AssertionError(f"train: restored {name} differs")
    return len(want)


def daemon_translate(base: str, commit: str, t_commit: float) -> tuple:
    """The port's ``SyncDaemon`` as the trainer's companion process: one
    ``run_cycle()`` translates the Hudi checkpoint table at ``base`` (head
    ``commit``, committed at ``time.perf_counter()`` ``t_commit``) to
    Iceberg and Delta, saves a durable daemon checkpoint and group-publishes
    the table to the catalog.  A second daemon on the same checkpoint then
    warm-restarts: its first cycle is idle, writes nothing and converges
    on the published pointer without a new generation, and its next idle
    cycle costs one storage request (the head probe).  Returns (stats, the
    catalog's pointer of the table)."""
    cfg = SyncConfig.from_dict({
        "sourceFormat": "HUDI", "targetFormats": ["ICEBERG", "DELTA"],
        "datasets": [{"tableBasePath": base}],
        "checkpoint": {"enabled": True},
        "catalog": {"enabled": True, "group": "train"}})
    name = cfg.datasets[0].name
    d = SyncDaemon(cfg, layer_fs(LocalFS()))
    try:
        t = time.perf_counter()
        rep = d.run_cycle()
        cycle_s = time.perf_counter() - t
        head = make_target("iceberg", LocalFS(), base).get_sync_token()
        staleness_s = time.perf_counter() - t_commit
        cat_path = d.catalog.store.base_path
    finally:
        d.close()
    stats = dict(daemon_cycle_s=cycle_s, staleness_s=staleness_s,
                 daemon_units=rep.units_drained, daemon_lag=rep.total_lag,
                 daemon_requests=rep.storage_ops["requests"],
                 daemon_checkpoint_gen=rep.checkpoint_gen,
                 catalog_generation=rep.catalog_generation)
    if rep.units_drained != 2 or rep.total_lag or rep.failures or \
            head != commit:
        raise AssertionError(f"train: the daemon's cycle did not translate "
                             f"commit {commit} (iceberg at {head}): "
                             f"{rep.summary()} {rep.failures}")
    if rep.checkpoint_gen is None or rep.catalog_generation is None:
        raise AssertionError(f"train: no daemon checkpoint or catalog "
                             f"publish: {stats}")

    fs2 = layer_fs(LocalFS())
    d2 = SyncDaemon(cfg, fs2)
    try:
        first, idle = d2.run_cycle(), d2.run_cycle()
    finally:
        d2.close()
    stats.update(restored_from_checkpoint=d2.restored_from_checkpoint,
                 restart_first_cycle_requests=first.storage_ops["requests"],
                 restart_first_cycle_puts=first.storage_ops["put"],
                 restart_idle_cycle_requests=idle.storage_ops["requests"])
    if not (d2.restored_from_checkpoint and first.idle and idle.idle):
        raise AssertionError(f"train: the restarted daemon did not resume "
                             f"idle: {first.summary()}; {idle.summary()}")
    if first.storage_ops["put"] or \
            first.catalog_generation != rep.catalog_generation:
        raise AssertionError(f"train: the restarted daemon wrote: "
                             f"{first.storage_ops}, catalog generation "
                             f"{first.catalog_generation}")
    if idle.storage_ops["requests"] != len(cfg.datasets):
        raise AssertionError(f"train: an idle cycle cost "
                             f"{idle.storage_ops}, want 1 request a table")
    ptr = Catalog(LocalFS(), cat_path).resolve(name)
    if ptr.base_path != base or "iceberg" not in ptr.formats:
        raise AssertionError(f"train: catalog pointer {ptr}")
    return stats, ptr


def phase_train(card: str, seed: int) -> dict:
    """Train yi-9b (full width, TRAIN_LAYERS layers, bf16, fp32 master)
    from a lake corpus: trainer A runs 4 steps and commits its state as a
    Hudi checkpoint; the port's ``SyncDaemon`` translates the commit to
    Iceberg and Delta, warm-restarts and publishes the table to the
    catalog (``daemon_translate``); trainer B resumes through the Iceberg
    view at the path the catalog resolves.  Each of A's steps must launch
    flash attention 2 x layers times (remat) and its backward once a
    layer, and the loss must fall; B's restored state and loader row must
    equal A's, and B's step-4 loss A's within 1e-3 relative.  The corpus
    and checkpoint live in a temporary directory, removed at the end."""
    cfg = replace(get_config("yi-9b"), n_layers=TRAIN_LAYERS)
    model = Model(cfg)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        fs = LocalFS()
        corpus = str(root / "corpus")
        t0 = time.perf_counter()
        write_synth_corpus(fs, corpus, fmt="delta", n_docs=32,
                           pack_len=TRAIN_S + 1, vocab=cfg.vocab_size,
                           seed=seed)
        stats = dict(layers=cfg.n_layers, batch=TRAIN_B, seq=TRAIN_S,
                     params=count_params(model.param_template()),
                     corpus_s=time.perf_counter() - t0,
                     disk_free_gb=shutil.disk_usage(root).free / 1e9)

        def loader():
            return LakeDataLoader(fs, corpus, "delta", batch_size=TRAIN_B,
                                  seq_len=TRAIN_S)

        tcfg = TrainerConfig(steps=4, save_every=0, log_every=1,
                             ckpt_format="hudi", sync_targets=(),
                             ce_chunk=128,
                             opt=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                             total_steps=10))
        a = Trainer(model, loader(), fs, str(root / "ckpt"), tcfg)
        t0 = time.perf_counter()
        a.init_or_restore(seed=seed)
        torch.cuda.synchronize()
        stats["init_s"] = time.perf_counter() - t0

        # timing hooks around A's step function and save
        step_fn, step_s, step_launches = a.step_fn, [], []

        def timed_step(*args):
            zero_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step_fn(*args)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            step_launches.append(counts())
            return out

        save_fn, save_s, saved_at = a.save, [], []

        def timed_save(step):
            t = time.perf_counter()
            save_fn(step)
            saved_at.append(time.perf_counter())
            save_s.append(saved_at[-1] - t)

        a.step_fn, a.save = timed_step, timed_save
        torch.cuda.reset_peak_memory_stats()
        hist = a.run()
        peak = torch.cuda.max_memory_allocated()
        commit = a.ckpt.handle.current_version()
        daemon_stats, ptr = daemon_translate(str(root / "ckpt"), commit,
                                             saved_at[0])
        run_launches = {name: sum(c[name] for c in step_launches)
                        for name in KERNELS}
        st = a.ckpt.handle.snapshot()
        nbytes = sum(f.size_bytes for f in st.files.values()
                     if f.partition_values["step"] == "3")
        write_s = save_s[0]
        losses = [loss for _, loss in hist]
        stats.update(
            losses=losses, step_s=step_s,
            step_s_median_1_3=float(np.median(step_s[1:])),
            tokens_per_s=TRAIN_B * TRAIN_S / float(np.median(step_s[1:])),
            peak_mem_gib=peak / 2**30, step_launches=step_launches,
            checkpoint_bytes=nbytes, save_s=write_s,
            save_GBps=nbytes / write_s / 1e9, **daemon_stats)
        log(f"  train: {cfg.name} {cfg.n_layers} layers {cfg.dtype}, "
            f"{stats['params']:,} params, b {TRAIN_B} x s {TRAIN_S}; losses "
            f"{[round(x, 4) for x in losses]}; step s {step_s} (median of "
            f"1-3 {stats['step_s_median_1_3']:.3f}); peak memory "
            f"{peak / 2**30:.2f} GiB; launches per step {step_launches}")
        log(f"  train: save {write_s:.2f} s ({nbytes:,} bytes, "
            f"{nbytes / write_s / 1e9:.3f} GB/s); the daemon's translate "
            f"cycle to iceberg + delta {stats['daemon_cycle_s']:.3f} s, "
            f"staleness {stats['staleness_s']:.3f} s (commit to iceberg "
            f"head), catalog generation {stats['catalog_generation']}; "
            f"restarted daemon: first cycle "
            f"{stats['restart_first_cycle_requests']} requests "
            f"({stats['restart_first_cycle_puts']} puts), idle cycle "
            f"{stats['restart_idle_cycle_requests']} request(s) a table; "
            f"card {card}")
        want = {"flash_attention": 2 * cfg.n_layers, "decode_attention": 0,
                "ssd_chunk_scan": 0, "flash_attention_bwd": cfg.n_layers}
        for i, c in enumerate(step_launches):
            if c != want:
                raise AssertionError(f"train step {i}: launches {c}, want "
                                     f"{want}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"train: the loss did not fall: {losses}")

        # B resumes through the Iceberg view at the catalog's path
        b = Trainer(model, loader(), fs, ptr.base_path,
                    replace(tcfg, steps=5, restore_format="iceberg"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = b.init_or_restore()
        torch.cuda.synchronize()
        stats["restore_s"] = time.perf_counter() - t0
        stats["restore_GBps"] = nbytes / stats["restore_s"] / 1e9
        if start != 4:
            raise AssertionError(f"train: B resumed at {start}, want 4")
        n_equal = _equal_states(a, b)
        if b.loader.row != a.loader.row:
            raise AssertionError(f"train: loader row {b.loader.row} != "
                                 f"{a.loader.row}")
        # A takes its step 4 (no save) under torch.profiler; B runs its
        # step 4 and saves
        a.step_fn = step_fn
        (_, _, met), split = profile_train_step(step_fn, a.params,
                                                a.opt_state, a.next_batch())
        log(f"  train: profile of A's step 4, {card}: " + json.dumps(split))
        stats["step_profile"] = split
        loss_a = float(met["loss"])
        t0 = time.perf_counter()
        hist_b = b.run()
        stats["b_run_s"] = time.perf_counter() - t0
        loss_b = hist_b[-1][1]
        stats.update(resumed_at=start, tensors_equal=n_equal,
                     loader_row=b.loader.row, step4_loss_a=loss_a,
                     step4_loss_b=loss_b,
                     step4_rel_diff=abs(loss_b - loss_a) / abs(loss_a))
        log(f"  train: B restored through iceberg in "
            f"{stats['restore_s']:.2f} s ({stats['restore_GBps']:.3f} GB/s), "
            f"resumed at step {start}, {n_equal} tensors equal, loader row "
            f"{b.loader.row}; step 4 loss A {loss_a:.6f} B {loss_b:.6f}; "
            f"card {card}")
        if not stats["step4_rel_diff"] <= 1e-3:
            raise AssertionError(f"train: step 4 losses differ: {loss_a} "
                                 f"{loss_b}")
        stats["launches"] = run_launches
        del a, b
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("  train: " + json.dumps(stats))
    return stats


def flex_library(q, k, v, out, *, causal: bool = True, window: int = 0,
                 softcap: float = 0.0, lengths=None) -> dict:
    """Torch's ``flex_attention``, compiled, on the kernel's inputs (q (b,
    sq, h, dh), k/v (b, sk, kv, dh)): a tanh ``score_mod`` for the softcap
    and a block mask, causal with the sliding window, or (``lengths``, a
    decode step) each sequence's valid prefix within the window.  SDPA has
    no softcap, so this is the one PyTorch call that computes the function:
    a yardstick the port never calls.  Returns its device time, its largest
    difference from the kernel's ``out`` and its compile seconds, or why it
    did not build or run."""
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        b, sq = q.shape[:2]
        sk = k.shape[1]

        def score_mod(score, bi, hi, qi, ki):
            return torch.tanh(score / softcap) * softcap

        def mask_mod(bi, hi, qi, ki):
            if lengths is not None:
                end = lengths[bi]
                seen = ki < end
                return seen & (ki >= end - window) if window else seen
            seen = ki <= qi if causal else ki >= 0
            return seen & (qi - ki < window) if causal and window else seen

        mask = create_block_mask(mask_mod, b if lengths is not None else None,
                                 None, sq, sk, device="cuda")
        fn = torch.compile(flex_attention)
        args = [tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))]

        def call(*a):
            return fn(*a, score_mod=score_mod if softcap else None,
                      block_mask=mask, enable_gqa=True)

        t0 = time.perf_counter()
        res = call(*args[0])
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        err = max_err(res.transpose(1, 2), out)
        return dict(library="flex_attention", library_ms=time_ms(call, args, 5),
                    library_max_abs_diff=err, library_compile_s=compile_s)
    except Exception as e:                  # reported, never a failure
        return dict(library="flex_attention", library_ms=None,
                    library_error=f"{type(e).__name__}: {e}"[:400])


def flash_at(gen, shape, library: str) -> dict:
    """The bf16 flash kernel at one shape of a served model's prefill:
    checked against the plain version a sequence at a time (at full batch
    its fp32 scores take tens of GB at gemma2's shapes), timed in a CUDA
    graph beside the plain version (eager: two calls) and ``library``
    ("sdpa", for no softcap; or "flex", ``flex_library``), with the bound
    from the visible pairs."""
    b, sq, sk, h, kv, dh, causal, window, softcap = shape
    dtype = torch.bfloat16
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = _flash_inputs(gen, shape, dtype)
    out = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for i in range(b):
        one = slice(i, i + 1)
        ref = attention_ref(q[one], k[one], v[one], **kw)
        err = max(err, max_err(out[one], ref))
        if not within(out[one], ref, TOL[dtype]):
            raise AssertionError(f"flash_attention {shape}: err {err}")
        del ref
    ms = time_ms(lambda *a: flash_ops.flash_attention(*a, **kw), [(q, k, v)],
                 10)
    plain_ms = time_eager_ms(lambda: attention_ref(q, k, v, **kw), 1)
    torch.cuda.empty_cache()
    if library == "sdpa":
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = dict(library="sdpa", library_ms=time_ms(
            lambda *a: F.scaled_dot_product_attention(
                *a, is_causal=causal, enable_gqa=True), [(qt, kt, vt)], 10))
    else:
        lib = flex_library(q, k, v, out, **kw)
    flops, nbytes = cost.flash_work(b, sq, sk, h, kv, dh, causal, window,
                                    q.element_size())
    bms, by = bound_ms(flops, nbytes, dtype)
    rec = dict(kernel="flash_attention", shape=list(shape), max_abs_err=err,
               ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               flops=flops, bytes=nbytes, achieved_tflops=flops / ms / 1e9,
               **lib)
    log("  " + json.dumps(rec))
    return rec


def decode_at(gen, shape, lengths, library: str) -> dict:
    """The bf16 decode kernel at one shape of a served model's decode step,
    ``lengths`` as in that step, on distinct caches (>= 100 MB together, so
    each launch finds its cache cold in L2, as each layer's is when
    served): checked against the plain version, timed in a CUDA graph
    beside the plain version and ``library`` ("sdpa" with a prefix mask,
    for no softcap; or "flex"), with the bound from the rows each sequence
    sees."""
    b, S, h, kv, dh, window, softcap = shape
    dtype = torch.bfloat16
    kw = dict(window=window, softcap=softcap)
    n_sets = max(2, min(8, -(-100_000_000 // (4 * b * S * kv * dh))))
    sets = [_decode_inputs(gen, shape, dtype, lengths) for _ in range(n_sets)]
    q, k, v, lens = sets[0]
    out = decode_ops.decode_attention(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q, k, v, lens, **kw)
    err = max_err(out, ref)
    if not within(out, ref, TOL[dtype]):
        raise AssertionError(f"decode_attention {shape}: err {err}")
    ms = time_ms(lambda *a: decode_ops.decode_attention(*a, **kw), sets, 96)
    plain_ms = time_ms(lambda *a: decode_attention_ref(*a, **kw), sets, 24)
    if library == "sdpa":
        pos = torch.arange(S, device="cuda")
        lib_sets = [(q.unsqueeze(2), k.transpose(1, 2).contiguous(),
                     v.transpose(1, 2).contiguous(),
                     (pos[None, :] < ln[:, None])[:, None, None, :])
                    for q, k, v, ln in sets]
        lib = dict(library="sdpa", library_ms=time_ms(
            lambda q, k, v, m: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True), lib_sets, 96))
    else:
        lib = flex_library(q[:, None], k, v, out[:, None], lengths=lens, **kw)
    rows = sum(min(int(n), window) if window else int(n) for n in lengths)
    flops, nbytes = cost.decode_work(rows, b, h, kv, dh)
    bms, by = bound_ms(flops, nbytes, dtype)
    rec = dict(kernel="decode_attention", shape=list(shape),
               lengths=[int(n) for n in lengths], max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by, flops=flops,
               bytes=nbytes, achieved_GBps=nbytes / ms / 1e6, **lib)
    log("  " + json.dumps(rec))
    return rec


def served_kernels(gen) -> dict:
    """The kernels at the served shapes of phases 10 and 11, before any
    weights take the card's memory: flash (prefill, b 4 x 2048, causal) and
    decode (the first decode step's caches, 2049 rows of 4096) at granite's
    heads (24 q / 8 kv, dh 64) and jamba's (32 / 8, dh 128) beside SDPA,
    and the SSD op at jamba's widths (``ssd_at``)."""
    b, s = SERVE_B, max(SERVE_PROMPTS)
    out = {}
    for name in ("granite-moe-3b-a800m", "jamba-v0.1-52b"):
        cfg = get_config(name)
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        key = name.split("-")[0]
        out[f"{key}_flash"] = flash_at(gen, (b, s, s, *heads, True, 0, 0.0),
                                       "sdpa")
        out[f"{key}_decode"] = decode_at(
            gen, (b, SERVE_CACHE, *heads, 0, 0.0), [s + 1] * b, "sdpa")
        torch.cuda.empty_cache()
    c = get_config("jamba-v0.1-52b").ssm
    out["jamba_ssd"] = ssd_at(gen, (b, s, c.n_heads, c.head_dim, c.n_groups,
                                    c.d_state, c.chunk))
    return out


def phase_gemma2(seed: int) -> dict:
    """gemma2-27b at full width and depth in bf16.  First its kernels at
    the shapes of this traffic, before the weights take the card's memory:
    flash for a local (window 4096) and a global layer of the prefill,
    decode for a local (its ring full) and a global cache at the first
    decode step, all softcapped; then ``phase_serve`` with the GEMMA_*
    traffic, with one prefill and one decode step under torch.profiler.
    The fp32 check of the window and the ring is ``phase_window_fp32``."""
    cfg = get_config("gemma2-27b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, s = len(GEMMA_PROMPTS), max(GEMMA_PROMPTS)
    h, kv, dh, cap = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.attn_softcap
    local = cfg.cycle[0].window
    kernels = {
        "flash_local": flash_at(gen, (b, s, s, h, kv, dh, True, local, cap),
                                "flex"),
        "flash_global": flash_at(gen, (b, s, s, h, kv, dh, True, 0, cap),
                                 "flex"),
        "decode_local": decode_at(gen, (b, local, h, kv, dh, local, cap),
                                  [local] * b, "flex"),
        "decode_global": decode_at(gen, (b, GEMMA_CACHE, h, kv, dh, 0, cap),
                                   [s + 1] * b, "flex")}
    torch.cuda.empty_cache()
    # half the layers are local, half global
    flash_ms = (kernels["flash_local"]["ms"] + kernels["flash_global"]["ms"]) / 2
    stats = phase_serve("gemma2-27b", seed, {"flash_attention": flash_ms},
                        prompts=GEMMA_PROMPTS, new=GEMMA_NEW,
                        cache_len=GEMMA_CACHE, profile=True)
    stats["kernels"] = kernels
    return stats


def phase_whisper(seed: int) -> dict:
    """whisper-small at full width and depth (12 encoder and 12 decoder
    layers, 1500 frames) in bf16: the median of three prefills with seeded
    random frame embeddings, greedy decode through ``Model.decode_step``
    against the teacher-forced forward (bf16 agreement reported), one
    decode step eager and as a CUDA graph, one ``ServeEngine.generate``
    with the reference engine's zero frames, the launches of each (flash:
    12 encoder, 12 self, 12 cross a prefill; decode: 12 self and 12 cross a
    step), the fp32 decode against teacher forcing at full depth, and the
    kernels at whisper's shapes."""
    cfg = get_config("whisper-small")
    model = Model(cfg)
    params = init_params(model.param_template(),
                         torch.Generator(device="cuda").manual_seed(seed))
    b, s, new = len(WHISPER_PROMPTS), max(WHISPER_PROMPTS), WHISPER_NEW
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size - 1, n).tolist()
               for n in WHISPER_PROMPTS]
    toks = np.full((b, s), cfg.vocab_size - 1, np.int64)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p
    toks = torch.from_numpy(toks).cuda()
    enc = _frames(cfg, b, seed).cuda()
    kw = {"enc_embeds": enc.to(torch.bfloat16)}
    n_flash, n_decode, _ = _layer_kinds(cfg)
    want_prefill = {"flash_attention": n_flash, "decode_attention": 0,
                    "ssd_chunk_scan": 0, "flash_attention_bwd": 0}
    want_decode = dict(want_prefill, flash_attention=0,
                       decode_attention=n_decode * (new - 1))

    times = []
    for _ in range(3):
        logits = cache = None
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, toks, cache_len=WHISPER_CACHE,
                                      **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        prefill_launches = counts()
    prefill_s = float(np.median(times))
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [torch.argmax(logits, -1)]
    for i in range(new - 1):
        logits, cache = model.decode_step(params, cache, out[-1],
                                          torch.full((b,), s + i,
                                                     device="cuda"))
        out.append(torch.argmax(logits, -1))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = counts()
    gen_toks = torch.stack(out, 1)                        # (b, new)

    zero_counts()
    full, _ = model.forward(params, torch.cat([toks, gen_toks[:, :-1]], 1),
                            **kw)
    torch.cuda.synchronize()
    tf_launches = counts()
    agree = float((torch.argmax(full[:, s - 1:], -1) == gen_toks)
                  .float().mean())

    tok, pos = gen_toks[:, -1], torch.full((b,), s + new - 1, device="cuda")
    step = lambda: model.decode_step(params, cache, tok, pos)  # noqa: E731
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / 5 * 1e3
    graph_ms = time_ms(step, [()], 5)

    engine = ServeEngine(model, params, cache_len=WHISPER_CACHE)
    zero_counts()
    outs = engine.generate([Request(p, new) for p in prompts])
    torch.cuda.synchronize()
    engine_launches = counts()
    stats = dict(encoder_layers=cfg.encoder.n_layers, layers=cfg.n_layers,
                 frames=cfg.encoder.n_frames, prompts=list(WHISPER_PROMPTS),
                 new_tokens=new, cache_len=WHISPER_CACHE,
                 params=count_params(model.param_template()),
                 prefill_s=prefill_s, prefill_runs_s=times,
                 prefill_tok_per_s=b * s / prefill_s,
                 decode_s=decode_s, decode_step_ms=decode_s / (new - 1) * 1e3,
                 decode_tok_per_s=b * (new - 1) / decode_s,
                 decode_step_eager_ms=eager_ms,
                 decode_step_device_ms=graph_ms,
                 decode_step_idle_share=1.0 - graph_ms / eager_ms,
                 teacher_forcing_agreement_bf16=agree,
                 prefill_launches=prefill_launches,
                 decode_launches=decode_launches, tf_launches=tf_launches,
                 engine_launches=engine_launches, launches=engine_launches)
    log("  serve whisper-small: " + json.dumps(stats))
    for name, got, want in (("prefill", prefill_launches, want_prefill),
                            ("decode", decode_launches, want_decode),
                            ("teacher-forced forward", tf_launches,
                             want_prefill),
                            ("engine", engine_launches,
                             dict(want_decode, flash_attention=n_flash))):
        if got != want:
            raise AssertionError(f"whisper {name} launches {got}, want "
                                 f"{want}")
    if [len(o) for o in outs] != [new] * b or not all(
            0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError(f"whisper engine tokens: {outs}")
    del full, cache
    torch.cuda.empty_cache()
    # at the init's std the fp32 paths drift apart (ROADMAP C-k): reported
    # with the agreement held; on block weights at std 1/sqrt(fan-in) the
    # logits are held to FP32_DECODE_TOL
    stats.update(decode_vs_forward_fp32(cfg, params, toks, enc=enc))
    torch.cuda.empty_cache()
    held = init_params(well_conditioned(Model(replace(cfg, dtype="float32"))
                                        .param_template()),
                       torch.Generator(device="cuda").manual_seed(seed))
    stats.update(decode_vs_forward_fp32(cfg, held, toks, enc=enc,
                                        max_diff=FP32_DECODE_TOL,
                                        prefix="fp32_well_conditioned_"))
    del held
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frames, heads = cfg.encoder.n_frames, (cfg.n_heads, cfg.n_kv_heads,
                                            cfg.head_dim)
    stats["kernels"] = {
        "flash_encoder": flash_at(gen, (b, frames, frames, *heads, False, 0,
                                        0.0), "sdpa"),
        "flash_cross": flash_at(gen, (b, s, frames, *heads, False, 0, 0.0),
                                "sdpa"),
        "decode_self": decode_at(gen, (b, WHISPER_CACHE, *heads, 0, 0.0),
                                 [s + 1] * b, "sdpa"),
        "decode_cross": decode_at(gen, (b, frames, *heads, 0, 0.0),
                                  [frames] * b, "sdpa")}
    return stats


def _sharded_grads(model, params, batch) -> tuple:
    """The train loss (ce_chunk 128, as phase 7's) of ``model`` at
    ``params`` (DTensors or tensors on the card) on ``batch`` and every
    parameter's gradient as a plain tensor, in ``leaf_paths`` order."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with model.sh.region():
        loss, _ = make_loss_fn(model, ce_chunk=128)(live, batch)
        leaves = [t for _, t in leaf_paths(live)]
        grads = torch.autograd.grad(loss, leaves)
    full = [g.full_tensor() if isinstance(g, DTensor) else g for g in grads]
    loss = loss.full_tensor() if isinstance(loss, DTensor) else loss
    return float(loss.detach()), full


def _steps(model, params, state, batch, n: int) -> tuple:
    """``n`` train steps (phase 7's optimizer and loss chunk) on one batch
    -> (losses, step seconds, launches of each step)."""
    step = make_train_step(model, AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                              total_steps=10),
                           ce_chunk=128)
    losses, secs, launches = [], [], []
    for _ in range(n):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        loss = met["loss"]
        loss = float(loss.full_tensor() if isinstance(loss, DTensor)
                     else loss)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches.append(counts())
        losses.append(loss)
    return losses, secs, launches


def _cost_vs_card(name: str, cfg, cell, measured_s: float) -> dict:
    """Phase 12(c): one step counted on ``meta`` (one device: the host
    mesh's), its roofline on the H100's constants, beside the card's
    measured seconds."""
    cb = build_step(cfg, cell, Sharder.null())
    _, c = cost.analyze(cb.fn, *cb.args)
    tokens = cell.global_batch * cell.seq_len
    mflops = roofline.model_flops(cb.step_name, cb.n_active_params, tokens)
    roof = max(c["flops"] / roofline.PEAK_FLOPS,
               c["hbm_bytes"] / roofline.HBM_BW)
    rec = dict(cell=name, counted_flops=c["flops"],
               counted_dot_flops=c["dot_flops"], counted_hbm_bytes=c["hbm_bytes"],
               model_flops=mflops, roofline_s=roof,
               bound_by="operations" if c["flops"] / roofline.PEAK_FLOPS
               > c["hbm_bytes"] / roofline.HBM_BW else "bytes",
               measured_s=measured_s,
               mfu=mflops / (measured_s * roofline.PEAK_FLOPS),
               roofline_share=roof / measured_s,
               kernels=c["kernels"],
               est_peak_gib=(cb.argument_bytes + c["temp_peak_bytes"]) / 2**30)
    log("  cost model: " + json.dumps(rec))
    return rec


def phase_mesh(card: str, seed: int, stats: dict) -> dict:
    """The Sharder on the card: an NCCL group of this one GPU over a
    FileStore in a temporary directory, ``make_host_mesh()`` (data 1), and
    phase 7's full-width 4-layer yi-9b (block weights ``well_conditioned``,
    as phase 4's) with params and state placed as DTensors.
    (a) The train step: every gradient of step 0 within phase 4's 2e-3 of
    the unsharded model's on the same weights and batch, then 3 steps of
    each, each step's loss within 2e-3 relative and the same flash forward
    and backward launches; both step times are printed (the DTensor host
    cost).  (b) The prefill of phase 5's 4 requests: last-position logits
    within 2e-2 (bf16) of the unsharded prefill, with equal launches.
    (c) The cost model: phase 5's yi-9b and mamba2 prefills and phase 7's
    train step counted on ``meta``, with their model FLOPs, roofline time
    and MFU at the measured medians of phases 5 and 7, and the step's
    estimated peak memory beside phase 7's measured one (not gated)."""
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(root / "store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        sh = Sharder.for_mesh(make_host_mesh())
        cfg = replace(get_config("yi-9b"), n_layers=TRAIN_LAYERS)
        plain, sharded = Model(cfg), Model(cfg, sh)
        ptpl, otpl = train_state_template(plain)
        tpl = well_conditioned(ptpl)

        def fresh():
            return init_params(tpl, torch.Generator(device="cuda")
                               .manual_seed(seed))

        out = dict(mesh=dict(zip(sh.mesh_axes, sh.mesh_axes.values())),
                   layers=cfg.n_layers, card=card)
        # (b) prefill, phase 5's requests
        rng = np.random.default_rng(seed)
        toks = np.full((SERVE_B, max(SERVE_PROMPTS)), cfg.vocab_size - 1,
                       np.int64)
        for i, n in enumerate(SERVE_PROMPTS):
            toks[i, -n:] = rng.integers(0, cfg.vocab_size - 1, n)
        toks = torch.from_numpy(toks).cuda()
        params = fresh()
        runs = {}
        for name, model, p in (("plain", plain, params),
                               ("sharded", sharded,
                                sh.distribute(params, ptpl))):
            for _ in range(2):                # the second run is timed
                zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = model.prefill(p, toks, cache_len=SERVE_CACHE)
                torch.cuda.synchronize()
            runs[name] = (time.perf_counter() - t0, counts(),
                          logits.full_tensor() if isinstance(logits, DTensor)
                          else logits)
        err = max_err(runs["sharded"][2], runs["plain"][2])
        out["prefill"] = dict(
            plain_s=runs["plain"][0], sharded_s=runs["sharded"][0],
            launches=runs["sharded"][1], max_abs_err=err)
        log("  mesh prefill: " + json.dumps(out["prefill"]))
        if not within(runs["sharded"][2], runs["plain"][2], 2e-2):
            raise AssertionError(f"mesh: sharded prefill logits differ "
                                 f"({err})")
        if runs["sharded"][1] != runs["plain"][1] or \
                runs["sharded"][1]["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"mesh: prefill launches {runs}")
        del params, runs, logits

        # (a) train: step-0 gradients, then 3 steps of each
        data = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
        data = torch.from_numpy(data).cuda()
        batch = {"inputs": data[:, :-1], "targets": data[:, 1:]}
        params = fresh()
        loss_p, grads_p = _sharded_grads(plain, params, batch)
        res_p = _steps(plain, params, adamw_init(params), batch, 3)
        del params
        torch.cuda.empty_cache()
        state = sh.distribute(adamw_init(fresh()), otpl)
        params = sh.distribute(fresh(), ptpl)
        loss_s, grads_s = _sharded_grads(sharded, params, batch)
        names = [n for n, _ in leaf_paths(ptpl)]
        rows = {n: dict(err=max_err(a, b), max=float(b.abs().max()))
                for n, a, b in zip(names, grads_s, grads_p)}
        del grads_s, grads_p
        torch.cuda.empty_cache()
        res_s = _steps(sharded, params, state, batch, 3)
        del params, state
        torch.cuda.empty_cache()
        out["train"] = dict(
            step0_loss_plain=loss_p, step0_loss_sharded=loss_s,
            losses_plain=res_p[0], losses_sharded=res_s[0],
            step_s_plain=res_p[1], step_s_sharded=res_s[1],
            launches_plain=res_p[2], launches_sharded=res_s[2],
            grad_max_err=max(r["err"] for r in rows.values()))
        log(f"  mesh train, {card}: " + json.dumps(out["train"]))
        for n, r in rows.items():
            if not r["err"] <= 2e-3 * min(1.0, r["max"]):
                raise AssertionError(f"mesh: sharded gradient {n} misses "
                                     f"the unsharded by {r['err']} (max "
                                     f"|g| {r['max']})")
        for a, b in zip(res_s[0], res_p[0]):
            if not abs(a - b) <= 2e-3 * abs(b):
                raise AssertionError(f"mesh: step losses {res_s[0]} vs "
                                     f"{res_p[0]}")
        want = {"flash_attention": 2 * cfg.n_layers, "decode_attention": 0,
                "ssd_chunk_scan": 0, "flash_attention_bwd": cfg.n_layers}
        if res_s[2] != [want] * 3 or res_p[2] != [want] * 3:
            raise AssertionError(f"mesh: step launches {res_s[2]}, "
                                 f"{res_p[2]}, want {want} each")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)

    # (c) the cost model against the card (counted on meta: no launch)
    serve = ShapeCell("serve", "prefill", max(SERVE_PROMPTS), SERVE_B)
    out["cost"] = [
        _cost_vs_card("yi-9b prefill", get_config("yi-9b"), serve,
                      stats["yi-9b"]["prefill_s"]),
        _cost_vs_card("mamba2-2.7b prefill", get_config("mamba2-2.7b"),
                      serve, stats["mamba2-2.7b"]["prefill_s"]),
        _cost_vs_card("yi-9b train step", cfg,
                      ShapeCell("train", "train", TRAIN_S, TRAIN_B),
                      stats["train"]["step_s_median_1_3"])]
    log(f"  mesh: phase 7's step peak memory estimated "
        f"{out['cost'][-1]['est_peak_gib']:.2f} GiB, measured "
        f"{stats['train']['peak_mem_gib']:.2f} GiB (not gated)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    def head(title: str) -> None:
        log(f"== {title} (at {time.perf_counter() - t_start:.1f} s)")

    head("phase 1: device")
    card = phase_device()
    head("phase 2: build")
    phase_build()

    head("phase 3: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    decode_main = (SERVE_B, SERVE_CACHE, 32, 4, 128, 0, 0.0)
    main_lengths = rng.integers(max(SERVE_PROMPTS) + 1,
                                max(SERVE_PROMPTS) + SERVE_NEW, SERVE_B)
    kernels = [phase_flash(gen, FLASH_MAIN),
               phase_decode(gen, rng, decode_main, main_lengths),
               phase_ssd(gen, ssd_serving_shape())]
    torch.cuda.empty_cache()
    kernels.append(phase_flash_bwd(gen, FLASH_MAIN))
    torch.cuda.empty_cache()
    moe_kernels = served_kernels(gen)
    torch.cuda.empty_cache()

    head("phase 4: model, full width, 2 layers, fp32, card vs CPU")
    phase_model("yi-9b", args.seed, 128)
    # 300 is not a multiple of the 256-row chunk: the model's pad path
    phase_model("mamba2-2.7b", args.seed, 300)
    phase_model_grads(args.seed)
    torch.cuda.empty_cache()
    for arch in ("gemma2-27b", "starcoder2-15b", "chameleon-34b"):
        phase_model(arch, args.seed, 128)
        torch.cuda.empty_cache()
    phase_model("whisper-small", args.seed, 128, fan_in_std=True)
    phase_window_fp32(args.seed)
    torch.cuda.empty_cache()
    # the MoE archs, block weights at std 1/sqrt(fan-in) as whisper's;
    # jamba cut to one SSM block with MoE and its attention block, at a
    # prompt of 300 (not a multiple of its 16-row chunk: the pad path)
    for arch, s in (("granite-moe-3b-a800m", 128), ("dbrx-132b", 128)):
        phase_model(arch, args.seed, s, fan_in_std=True)
        torch.cuda.empty_cache()
    phase_model("jamba-v0.1-52b", args.seed, 300, fan_in_std=True,
                blocks=JAMBA_BLOCKS)
    torch.cuda.empty_cache()

    # each model's path is read on its own: its serve phase sets the
    # counts to 0 before it runs and reads them after
    head("phase 5: serve, yi-9b full width and depth, bf16")
    kernel_ms = {rec["name"]: rec["ms"] for rec in kernels}
    yi = {}
    stats = {"yi-9b": phase_serve("yi-9b", args.seed, kernel_ms, keep=yi)}
    torch.cuda.empty_cache()
    head("phase 5: serve, mamba2-2.7b full width and depth, bf16")
    # bf16 decode vs teacher forcing is reported; the paths are held to
    # each other in fp32 (decode_vs_forward_fp32)
    stats["mamba2-2.7b"] = phase_serve("mamba2-2.7b", args.seed, kernel_ms,
                                       min_agreement=None, fp32_check=True,
                                       profile=True)
    torch.cuda.empty_cache()

    head("phase 6: lake, yi-9b full width and depth saved as Hudi, "
         "restored through Iceberg and Delta")
    phase_lake(yi, card, stats["yi-9b"]["launches"])
    del yi
    torch.cuda.empty_cache()

    head(f"phase 7: train, yi-9b full width, {TRAIN_LAYERS} layers, bf16, "
         f"from the lake; the Hudi checkpoint translated by the port's "
         f"SyncDaemon, resumed through Iceberg")
    stats["train"] = phase_train(card, args.seed)
    torch.cuda.empty_cache()

    head("phase 8: serve, gemma2-27b full width and depth, bf16")
    stats["gemma2-27b"] = phase_gemma2(args.seed)
    torch.cuda.empty_cache()
    head("phase 9: serve, whisper-small full width and depth, bf16")
    stats["whisper-small"] = phase_whisper(args.seed)
    torch.cuda.empty_cache()

    # the MoE MLP: capacity drops are real at the shipped factor 1.25, so
    # bf16 greedy agreement with teacher forcing is reported, not held
    head("phase 10: serve, granite-moe-3b-a800m full width and depth, bf16")
    stats["granite-moe-3b-a800m"] = phase_serve(
        "granite-moe-3b-a800m", args.seed,
        {"flash_attention": moe_kernels["granite_flash"]["ms"]},
        min_agreement=None, fp32_check=True, profile=True)
    torch.cuda.empty_cache()
    head(f"phase 11: serve, jamba-v0.1-52b full width, {JAMBA_LAYERS} "
         f"layers, bf16")
    stats["jamba-v0.1-52b"] = phase_serve(
        "jamba-v0.1-52b", args.seed,
        {"flash_attention": moe_kernels["jamba_flash"]["ms"],
         "ssd_chunk_scan": moe_kernels["jamba_ssd"]["ms"]},
        min_agreement=None, layers=JAMBA_LAYERS)
    torch.cuda.empty_cache()

    # each path is read on its own: phase 12 sets the counts to 0 before
    # each of its runs and compares the sharded run's with the unsharded's
    head("phase 12: mesh, yi-9b full width, 4 layers, sharded by the "
         "Sharder on an NCCL group of this card; the cost model")
    stats["mesh"] = phase_mesh(card, args.seed, stats)
    torch.cuda.empty_cache()

    # each kernel's launches on its main path: serving (phase 5) for the
    # forward kernels, trainer A's run (phase 7) for the backward
    path_of = {"flash_attention": "yi-9b", "decode_attention": "yi-9b",
               "ssd_chunk_scan": "mamba2-2.7b",
               "flash_attention_bwd": "train"}
    for rec in kernels:
        rec["launches"] = stats[path_of[rec["name"]]]["launches"][rec["name"]]

    log(f"total {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({
        "kernels": [{k: rec[k] for k in keys} for rec in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
