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
                kernels alone
  4. model    - yi-9b and mamba2-2.7b at full width, 2 layers, fp32:
                prefill + 2 decode steps through the kernels, against the
                plain CPU path on the same weights
  5. serve    - yi-9b, then mamba2-2.7b, at full width and depth (bf16,
                random weights from a seeded generator on the card): the
                median of three prefills and each kernel's share of it, 4
                requests through ServeEngine, counting the kernel launches
                of prefill, of the whole generate run and of a teacher-forced
                forward pass; for mamba2-2.7b one prefill under
                torch.profiler (the ten device ops that take the most time)
The last two lines are the kernels JSON line and the result line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_ref  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import count_params, init_params, tree_map  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
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
]
FLASH_RAGGED = (1, 300, 300, 4, 1, 128, True, 0, 0.0)
# (b, S, h, kv, dh, window)
DECODE_SWEEP = [
    (2, 512, 4, 2, 64, 0),
    (2, 512, 4, 4, 128, 128),
    (1, 300, 8, 2, 64, 0),
    (3, 256, 16, 2, 128, 64),
    (2, 300, 32, 2, 128, 0),      # 16 query heads per kv head
    (2, 4100, 32, 4, 128, 0),     # S not a multiple of the tile
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
# the counted wrappers, by kernel name
KERNELS = {"flash_attention": flash_ops.flash_attention,
           "decode_attention": decode_ops.decode_attention,
           "ssd_chunk_scan": ssd_ops.ssd_chunk_scan}


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
def phase_device() -> None:
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


def kernel_resources(name: str, text: str) -> list:
    """One line per kernel of source ``name``'s ptxas log: its (mangled)
    name, registers, barriers, stack and spills."""
    out, kernel, spills = [], "?", ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
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


def _flash_visible_pairs(sq, sk, causal, window) -> int:
    qpos = np.arange(sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, qpos - window + 1) if (causal and window) \
        else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


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
    flops = 4.0 * b * h * dh * _flash_visible_pairs(sq, sk, causal, window)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out))
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


def _decode_inputs(gen, shape, dtype, lengths):
    b, S, h, kv, dh, _ = shape
    dev = torch.device("cuda")
    q = torch.randn((b, h, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, S, kv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, S, kv, dh), generator=gen, device=dev).to(dtype)
    return q, k, v, torch.as_tensor(lengths, dtype=torch.int32, device=dev)


def phase_decode(gen, rng, main_shape, main_lengths) -> dict:
    for dtype in (torch.float32, torch.bfloat16):
        for shape in DECODE_SWEEP:
            b, S, _, _, _, window = shape
            lengths = rng.integers(max(window, 8), S, b)
            if dtype == torch.float32:
                lengths[0] = 0              # an empty sequence gets 0
            q, k, v, lens = _decode_inputs(gen, shape, dtype, lengths)
            out = decode_ops.decode_attention(q, k, v, lens, window=window)
            torch.cuda.synchronize()
            ref = decode_attention_ref(q, k, v, lens, window=window)
            err = max_err(out, ref)
            log(f"  decode {shape} {str(dtype)[6:]} lengths "
                f"{lengths.tolist()}: max_abs_err {err:.3g}")
            if not within(out, ref, TOL[dtype]):
                raise AssertionError(f"decode_attention {shape} {dtype}: "
                                     f"err {err} > {TOL[dtype]}")
    dtype = torch.bfloat16
    b, S, h, kv, dh, window = main_shape
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
        rows = int(np.sum(main_lengths[:nb]))
        return 4.0 * h * dh * rows, \
            2 * rows * kv * dh * 2 + 2 * nb * h * dh * 2 + 4 * nb

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
    nc = s // q
    stages_ms = ssd_kernel_times(args, q)
    plan = ssd_ops.bf16_plan(b, s, h, p, g, n, q)
    layout = dict(grids=plan.grids, smem=plan.smem,
                  scratch_bytes=plan.scratch_bytes)
    log(f"  ssd bf16 serving shape, each kernel alone and all three on one "
        f"set of buffers (ms): " + json.dumps(stages_ms))
    flops = 2.0 * q * p * (q + 2 * n) * b * h * nc + 2.0 * q * q * n * b * g * nc
    x, dt, A, B, C = args
    nbytes = 2 * x.numel() * x.element_size() + sum(
        t.numel() * t.element_size() for t in (dt, A, B, C)) + b * h * n * p * 4
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


def _layer_kinds(cfg) -> tuple:
    """(attention layers, SSM layers) of ``cfg``."""
    n_attn = sum(spec.kind == "attn" for spec in cfg.layer_specs())
    return n_attn, cfg.n_layers - n_attn


def phase_model(arch: str, seed: int, s: int) -> None:
    """Full width, 2 layers, fp32: kernels on the card vs the plain CPU path.

    Tolerance 2e-3 on the logits, the reference's own tolerance between two
    attention paths (tests/test_models.py): both sides are fp32 (TF32 off),
    and only the order of the sums differs (cuBLAS and the kernels' tiling
    against the CPU's BLAS and plain attention / chunked SSD)."""
    cfg = replace(get_config(arch), n_layers=2, dtype="float32")
    tol = 2e-3
    cpu = Model(cfg, device="cpu")
    card = Model(cfg)
    p_cpu = init_params(cpu.param_template(),
                        torch.Generator().manual_seed(seed), device="cpu")
    p_card = _to(p_cpu, card.device)
    rng = np.random.default_rng(seed)
    b = 2
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 2)))
    zero_counts()
    errs = []
    l_cpu, c_cpu = cpu.prefill(p_cpu, toks[:, :s], cache_len=s + 8)
    l_card, c_card = card.prefill(p_card, toks[:, :s].cuda(), cache_len=s + 8)
    errs.append(max_err(l_card.cpu(), l_cpu))
    for t in range(s, s + 2):
        pos = torch.full((b,), t)
        l_cpu, c_cpu = cpu.decode_step(p_cpu, c_cpu, toks[:, t], pos)
        l_card, c_card = card.decode_step(p_card, c_card, toks[:, t].cuda(),
                                          pos.cuda())
        errs.append(max_err(l_card.cpu(), l_cpu))
    torch.cuda.synchronize()
    launches = counts()
    n_attn, n_ssm = _layer_kinds(cfg)
    want = {"flash_attention": n_attn, "decode_attention": 2 * n_attn,
            "ssd_chunk_scan": n_ssm}
    log(f"  model {arch} width {cfg.d_model}, 2 layers, fp32, b={b}, "
        f"prompt {s}: logits max_abs_err prefill {errs[0]:.3g}, decode "
        f"{errs[1]:.3g} {errs[2]:.3g} (tol {tol}); launches {launches}")
    if not max(errs) <= tol:
        raise AssertionError(f"{arch} model logits differ: {errs} > {tol}")
    if launches != want:
        raise AssertionError(f"{arch} model launches {launches}, want {want}")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def decode_vs_forward_fp32(cfg, params, toks, steps: int = 8) -> dict:
    """Greedy decode from the prefill cache against the teacher-forced
    forward pass over the same tokens, at full depth in fp32 (the served
    bf16 weights, widened).  In bf16 the two paths round at different places
    (the SSD kernel returns y in bf16 before the skip term is added, the
    decode step adds it in fp32), and many layers of random weights amplify
    that; in fp32 only the order of the sums differs."""
    model = Model(replace(cfg, dtype="float32"))
    p32 = tree_map(lambda t: t.float(), params)
    b, s = toks.shape
    zero_counts()
    logits, cache = model.prefill(p32, toks)
    dec = [logits]
    for i in range(steps - 1):
        tok = torch.argmax(dec[-1], -1)
        logits, cache = model.decode_step(
            p32, cache, tok, torch.full((b,), s + i, device="cuda"))
        dec.append(logits)
    dec = torch.stack(dec, 1)                                 # (b, steps, V)
    gen = torch.argmax(dec[:, :-1], -1)
    full, _ = model.forward(p32, torch.cat([toks, gen], 1))
    ref = full[:, s - 1:]
    torch.cuda.synchronize()
    out = dict(fp32_decode_vs_forward_max_abs_diff=max_err(dec, ref),
               fp32_logits_std=float(ref.std()),
               fp32_teacher_forcing_agreement=float(
                   (torch.argmax(ref, -1) == torch.argmax(dec, -1))
                   .float().mean()),
               fp32_launches=counts())
    log(f"  serve: fp32, {cfg.n_layers} layers: " + json.dumps(out))
    if not out["fp32_teacher_forcing_agreement"] >= 0.5:
        raise AssertionError(f"fp32 decode disagrees with teacher forcing: "
                             f"{out}")
    return out


def profile_prefill(model, params, toks) -> dict:
    """One prefill under ``torch.profiler``: the device's busy time against
    the wall time, and the ten device ops (kernels and copies) that take the
    most of it.  Raises if the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(params, toks, cache_len=SERVE_CACHE)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)

    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    if busy_ms == 0:
        raise AssertionError("torch.profiler recorded no device time")
    top = sorted(events, key=device_us, reverse=True)[:10]
    out = dict(profile_wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=1.0 - busy_ms / wall_ms,
               top10=[dict(name=e.key[:100], calls=e.count,
                           ms=device_us(e) / 1e3,
                           share=device_us(e) / 1e3 / busy_ms)
                      for e in top])
    log("  profile of one prefill: " + json.dumps(out))
    return out


def phase_serve(arch: str, seed: int, kernel_ms: dict, *, min_agreement=0.5,
                fp32_check: bool = False, profile: bool = False) -> dict:
    """Serve 4 requests at full width and depth in bf16.  Greedy decode must
    agree with teacher forcing on ``min_agreement`` of the tokens (None:
    reported only); ``fp32_check`` adds ``decode_vs_forward_fp32``.
    ``kernel_ms`` (phase 3's times by kernel) gives each kernel's share of
    prefill: launches x time / prefill seconds.  ``profile`` adds one
    prefill under ``torch.profiler`` (``profile_prefill``), after the timed
    runs."""
    cfg = get_config(arch)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = init_params(model.param_template(),
                         torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    log(f"  serve: {arch} {count_params(model.param_template()):,} params "
        f"bf16, {cfg.n_layers} layers, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size - 1, n).tolist()
               for n in SERVE_PROMPTS]
    reqs = [Request(p, SERVE_NEW) for p in prompts]
    engine = ServeEngine(model, params, cache_len=SERVE_CACHE)
    n_attn, n_ssm = _layer_kinds(cfg)
    decode_steps = SERVE_NEW - 1

    # prefills of the same batch: the median time of three, the launches of
    # one and the greedy token
    toks = np.full((SERVE_B, max(SERVE_PROMPTS)), cfg.vocab_size - 1, np.int64)
    for i, p in enumerate(prompts):
        toks[i, -len(p):] = p
    toks = torch.from_numpy(toks).cuda()
    times = []
    for _ in range(3):
        first_logits = warm_cache = None
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first_logits, warm_cache = model.prefill(params, toks,
                                                 cache_len=SERVE_CACHE)
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
    stats = dict(prefill_s=prefill_s, prefill_runs_s=times,
                 generate_s=total_s,
                 decode_tok_per_s=SERVE_B * decode_steps / decode_s,
                 decode_step_ms=decode_s / decode_steps * 1e3,
                 prefill_tok_per_s=SERVE_B * max(SERVE_PROMPTS) / prefill_s,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 prefill_launches=prefill_launches,
                 prefill_kernel_share=shares, launches=launches)
    log(f"  serve {arch}: " + json.dumps(stats))

    if [len(o) for o in outs] != [SERVE_NEW] * SERVE_B:
        raise AssertionError(f"serve: token counts {[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("serve: token id out of range")
    if [o[0] for o in outs] != first:
        raise AssertionError(f"serve: first tokens {[o[0] for o in outs]} "
                             f"!= greedy prefill tokens {first}")
    want_prefill = {"flash_attention": n_attn, "decode_attention": 0,
                    "ssd_chunk_scan": n_ssm}
    want = dict(want_prefill, decode_attention=n_attn * decode_steps)
    if prefill_launches != want_prefill:
        raise AssertionError(f"serve: prefill launches {prefill_launches}, "
                             f"want {want_prefill}")
    if launches != want:
        raise AssertionError(f"serve: launches {launches}, want {want}")

    # teacher forcing over prompt + generated tokens: greedy decode should
    # pick the argmax of the full forward pass at each position
    gen = torch.tensor([o[:-1] for o in outs], device="cuda")
    zero_counts()
    full, _ = model.forward(params, torch.cat([toks, gen], 1))
    torch.cuda.synchronize()
    tf_launches = counts()
    if tf_launches != want_prefill:
        raise AssertionError(f"serve: teacher-forced forward launches "
                             f"{tf_launches}, want {want_prefill}")
    s = toks.shape[1]
    tf = torch.argmax(full[:, s - 1:], -1).cpu()
    agree = float((tf == torch.tensor(outs)).float().mean())
    log(f"  serve: teacher-forced forward over {full.shape[1]} tokens, "
        f"launches {tf_launches}; decode vs teacher-forcing greedy agreement "
        f"{agree:.4f}")
    if min_agreement is not None and not agree >= min_agreement:
        raise AssertionError(f"serve: decode disagrees with teacher forcing "
                             f"({agree})")
    stats["teacher_forcing_agreement"] = agree

    # one decode step, eager (as served) against the same step replayed
    # from a CUDA graph (device time alone): their gap is host overhead
    tok = torch.tensor(first, device="cuda")
    pos = torch.full((SERVE_B,), s, device="cuda")
    step = lambda: model.decode_step(params, warm_cache, tok, pos)  # noqa: E731
    step_logits, _ = step()
    gap = float((step_logits - full[:, s]).abs().max())
    log(f"  serve: bf16 logits, decode step vs teacher forcing at position "
        f"{s}: max_abs_diff {gap:.4g} (logits std {float(full[:, s].std()):.4g})")
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
        stats["prefill_profile"] = profile_prefill(model, params, toks)
    if fp32_check:
        del full, warm_cache, step_logits
        torch.cuda.empty_cache()
        stats.update(decode_vs_forward_fp32(cfg, params, toks))
    return stats


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    log("== phase 1: device")
    phase_device()
    log("== phase 2: build")
    phase_build()

    log("== phase 3: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    flash_main = (SERVE_B, max(SERVE_PROMPTS), max(SERVE_PROMPTS), 32, 4, 128,
                  True, 0, 0.0)
    decode_main = (SERVE_B, SERVE_CACHE, 32, 4, 128, 0)
    main_lengths = rng.integers(max(SERVE_PROMPTS) + 1,
                                max(SERVE_PROMPTS) + SERVE_NEW, SERVE_B)
    kernels = [phase_flash(gen, flash_main),
               phase_decode(gen, rng, decode_main, main_lengths),
               phase_ssd(gen, ssd_serving_shape())]
    torch.cuda.empty_cache()

    log("== phase 4: model, full width, 2 layers, fp32, card vs CPU")
    phase_model("yi-9b", args.seed, 128)
    # 300 is not a multiple of the 256-row chunk: the model's pad path
    phase_model("mamba2-2.7b", args.seed, 300)
    torch.cuda.empty_cache()

    # each model's path is read on its own: its serve phase sets the
    # counts to 0 before it runs and reads them after
    log("== phase 5: serve, yi-9b full width and depth, bf16")
    kernel_ms = {rec["name"]: rec["ms"] for rec in kernels}
    stats = {"yi-9b": phase_serve("yi-9b", args.seed, kernel_ms)}
    torch.cuda.empty_cache()
    log("== phase 5: serve, mamba2-2.7b full width and depth, bf16")
    # bf16 decode vs teacher forcing is reported; the paths are held to
    # each other in fp32 (decode_vs_forward_fp32)
    stats["mamba2-2.7b"] = phase_serve("mamba2-2.7b", args.seed, kernel_ms,
                                       min_agreement=None, fp32_check=True,
                                       profile=True)
    path_of = {"flash_attention": "yi-9b", "decode_attention": "yi-9b",
               "ssd_chunk_scan": "mamba2-2.7b"}
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
