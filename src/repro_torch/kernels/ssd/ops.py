"""Public wrapper of the SSD (Mamba-2) chunk-scan kernels.

CPU tensors take the plain version (``ref.ssd_ref``); CUDA tensors launch
the CUDA kernels or raise.  ``ssd_chunk_scan.launches`` counts calls of the
op that launched on the card: one per call, whatever the number of kernels.

* bf16 x/B/C: three kernels per call (``csrc/ssd.cu``): chunk states, the
  state pass over the chunks, and the chunk scan.  The wrapper allocates y,
  the state, an fp32 scratch of the h n x p states of each (batch, chunk)
  and the chunks' decay sums; the kernels allocate nothing.
* fp32 x/B/C: one kernel per call, on the CUDA cores in fp32.

The kernels read x, B and C through their batch and sequence strides, so
the model hands them slices of one convolution output without copying; the
trailing (heads, head_dim) and (groups, d_state) dims must be dense.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import ssd_ref

SMEM_LIMIT = 232_448        # shared memory one block may opt into (H100)
TILES = (64, 32, 16)        # fp32 kernel: chunk rows per tile, the largest that fits
# bf16 kernels: q rows of a scan block, the longest chunk (one scan thread
# per key), heads per scan block, the largest d_state and head_dim
TQ, QMAX, HEADS_PER_BLOCK, NMAX, PMAX = 64, 256, 16, 128, 64
KEY_SPLITS = 2              # scan block: 4 q-row warps per split of the keys
STATES_STAGES = 2           # ring stages of the chunk-states kernel
STATES_TILE = 64            # rows of a chunk-states tile
THREADS = 256
STAGES = {"states": 1, "pass": 2, "scan": 4}
ALL_STAGES = 7
_ARGTYPES = {
    torch.float32: [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
    + [ctypes.c_longlong] * 6 + [ctypes.c_void_p],
    torch.bfloat16: [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
    + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p],
}
_ENTRY = {torch.float32: "ssd_chunk_scan_f32",
          torch.bfloat16: "ssd_chunk_scan_bf16"}


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


def _ld(v: int) -> int:
    """Leading dim (floats) of a shared tile: a multiple of 4 whose quarter
    is odd, so 16-byte reads of 8 consecutive rows hit distinct banks."""
    return v if (v // 4) % 2 else v + 4


def smem_bytes(tile: int, q: int, n: int, p: int) -> int:
    """Shared memory of one fp32 block; mirrors ``layout()`` in
    ``csrc/ssd.cu``: C and B tiles (tile x ld(n)), x*dt and y tiles
    (tile x p), the scores (tile x ld(tile)), the carried and the new state
    (n x p), five per-row arrays of the chunk (dt, two decay sums, two
    decays) and four per-tile decay sums."""
    npad, ppad = _round(n, 4), _round(p, 4)
    qt = _round(q, tile)
    return 4 * (2 * tile * _ld(npad) + 2 * tile * ppad + tile * _ld(tile)
                + 2 * npad * ppad + 5 * qt + 4 * (qt // tile))


def plan(q: int, n: int, p: int) -> int:
    """fp32 kernel: tile rows for chunk length ``q``, d_state ``n`` and
    head_dim ``p``: the largest of ``TILES`` that is not more than twice
    ``q`` and whose block fits ``SMEM_LIMIT``.  Raises ValueError if none
    fits."""
    for tile in TILES:
        if tile > TILES[-1] and tile // 2 >= q:
            continue
        if smem_bytes(tile, q, n, p) <= SMEM_LIMIT:
            return tile
    raise ValueError(
        f"SSD chunk {q}, d_state {n}, head_dim {p}: even {TILES[-1]}-row "
        f"tiles need {smem_bytes(TILES[-1], q, n, p)} bytes of shared "
        f"memory, above the {SMEM_LIMIT} a block may use")


@dataclass(frozen=True)
class Bf16Plan:
    """Launch plan of the three bf16 kernels; mirrors ``launch_bf16`` and
    ``states_smem`` / ``scan_layout`` in ``csrc/ssd.cu``."""
    pp: int                  # head_dim padded to 16, 32 or 64 (a template)
    npad: int                # d_state padded to 16
    qt: int                  # chunk padded to 64 rows
    heads_per_block: int     # heads of one group per scan block
    grids: dict              # kernel -> (x, y, z) blocks of 256 threads
    smem: dict               # kernel -> shared bytes of one block
    scratch_shape: tuple     # (b, nc, h * n * p rounded up to 256) fp32:
                             # each (batch, chunk) row holds the h chunk
                             # states one after the other, then the states
                             # entering the chunk (the hi bf16 halves of each
                             # group of 64 elements, then their lo halves, in
                             # its 256 bytes)
    decay_shape: tuple       # (b, nc, h) fp32: each chunk's sum of dt * A

    @property
    def scratch_bytes(self) -> int:
        return 4 * (_prod(self.scratch_shape) + _prod(self.decay_shape))


def _prod(shape) -> int:
    out = 1
    for v in shape:
        out *= v
    return out


def bf16_plan(b: int, s: int, h: int, p: int, g: int, n: int,
              q: int) -> Bf16Plan:
    """Grids, shared memory and scratch of the bf16 kernels for x (b, s, h,
    p), B/C (b, s, g, n) and chunk ``q`` (s a multiple of q).  Raises
    ValueError for shapes the kernels do not take: a chunk above 256 rows,
    d_state above 128, head_dim above 64, more than 65535 (chunk, batch)
    pairs."""
    if q > QMAX or n > NMAX or p > PMAX:
        raise ValueError(
            f"the bf16 SSD kernels take chunks of at most {QMAX} rows, "
            f"d_state at most {NMAX} and head_dim at most {PMAX}; got chunk "
            f"{q}, d_state {n}, head_dim {p}")
    nc = s // q
    if nc * b > 65535:
        raise ValueError(f"{nc} chunks x batch {b} exceed the grid's 65535")
    pp = 16 if p <= 16 else 32 if p <= 32 else 64
    npad, qt = _round(n, 16), _round(q, TQ)
    hpg = h // g
    heads = min(HEADS_PER_BLOCK, hpg)
    # chunk states: the ring's stages of B and x rows, x' hi and lo, weights
    states = STATES_STAGES * 2 * STATES_TILE * (npad + 8 + pp + 8) \
        + 4 * STATES_TILE * (pp + 8) + 4 * (QMAX + 8)
    # chunk scan: C rows, then B rows or two stages of (x, state hi, lo),
    # then per head the keys' dt and factors and the tile's rows' dt and sums
    # (a used stage then holds the other splits' partial y and y as bf16)
    stage = max(2 * qt * (pp + 8) + 4 * npad * (pp + 8),
                (KEY_SPLITS - 1) * 4 * (pp // 8) * 32 * 16 + 2 * TQ * (pp + 8))
    scan = 2 * TQ * (npad + 8) + max(2 * stage, 2 * qt * (npad + 8)) \
        + 4 * HEADS_PER_BLOCK * (2 * QMAX + 2 * TQ + 1)
    row = _round(h * n * p, 256)     # the state pass: a warp per 256
    return Bf16Plan(
        pp=pp, npad=npad, qt=qt, heads_per_block=heads,
        grids={"states": (nc, h, b),
               "pass": (-(-row // (8 * THREADS)), b, 1),
               "scan": (qt // TQ, g * -(-hpg // heads), nc * b)},
        smem={"states": states, "pass": 0, "scan": scan},
        scratch_shape=(b, nc, row), decay_shape=(b, nc, h))


@functools.cache
def _entry(dtype):
    """The C entry for ``dtype``, with its argument types declared."""
    fn = getattr(_build.library("ssd"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES[dtype]
    fn.restype = ctypes.c_int
    return fn


def _check_shapes(x, dt, A, B, C, chunk: int, init=None) -> int:
    """Validate shapes; return the chunk length min(chunk, s)."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 \
            or B.shape != C.shape:
        raise ValueError(f"want x (b,s,h,p), dt (b,s,h), A (h,), B/C "
                         f"(b,s,g,n); got {tuple(x.shape)}, {tuple(dt.shape)},"
                         f" {tuple(A.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or tuple(B.shape[:2]) != (b, s) or g == 0 or h % g:
        raise ValueError(f"shapes do not pair: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}")
    if init is not None and tuple(init.shape) != (b, h, n, p):
        raise ValueError(f"init {tuple(init.shape)}: want (b, h, n, p) = "
                         f"{(b, h, n, p)}")
    if chunk <= 0 or s == 0:
        raise ValueError(f"chunk {chunk} and sequence {s} must be positive")
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}; "
                         "the caller pads (models/ssm.py does)")
    return q


def check_operands(x, dt, A, B, C, init=None) -> None:
    """What the card's kernels take, whatever the device: x/B/C all float32
    or all bfloat16, dt/A/init float32, dt/A/init contiguous, x/B/C with
    dense last two dims, every tensor aligned to its element size."""
    if x.dtype not in _ENTRY or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x/B/C dtypes {x.dtype}, {B.dtype}, {C.dtype}: want "
                        "all float32 or all bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt/A dtypes {dt.dtype}, {A.dtype}: want float32")
    if init is not None and init.dtype != torch.float32:
        raise TypeError(f"init dtype {init.dtype}: want float32")
    named = [("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)]
    if init is not None:
        named.append(("init", init))
    for name, t in named:
        if t.data_ptr() % t.element_size():
            raise ValueError(f"{name} is not aligned to its element size")
    for name, t in named[1:3] + named[5:]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
            raise ValueError(f"{name}: the last two dims must be dense "
                             f"(strides {t.stride()})")


def _check_device(x, dt, A, B, C, init) -> None:
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C),
                    ("init", init)):
        if t is not None and (not t.is_cuda or t.device != x.device):
            raise ValueError(f"{name} is not on {x.device}")


def _strides(x, B, C) -> tuple:
    return (x.stride(0), x.stride(1), B.stride(0), B.stride(1),
            C.stride(0), C.stride(1))


def bf16_buffers(x, B, q: int):
    """y, final state, scratch and decay sums of one bf16 call, allocated
    with ``torch.empty`` on x's device."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pl = bf16_plan(b, s, h, p, g, n, q)
    dev = x.device
    return (torch.empty((b, s, h, p), dtype=x.dtype, device=dev),
            torch.empty((b, h, n, p), dtype=torch.float32, device=dev),
            torch.empty(pl.scratch_shape, dtype=torch.float32, device=dev),
            torch.empty(pl.decay_shape, dtype=torch.float32, device=dev))


def launch_bf16(x, dt, A, B, C, q: int, init, buffers,
                stages: int = ALL_STAGES) -> None:
    """Launch the bf16 kernels named by ``stages`` (bits of ``STAGES``) on
    ``buffers`` (``bf16_buffers``).  The op is all three; ``chip_smoke.py``
    times each alone.  Counts nothing: ``ssd_chunk_scan`` counts."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y, state, scratch, decay = buffers
    pl = bf16_plan(b, s, h, p, g, n, q)
    err = _entry(torch.bfloat16)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), None if init is None else init.data_ptr(),
        y.data_ptr(), state.data_ptr(), scratch.data_ptr(), decay.data_ptr(),
        b, s, h, p, g, n, q, pl.heads_per_block, *_strides(x, B, C), stages,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_chunk_scan")


def ssd_chunk_scan(x, dt, A, B, C, *, chunk: int = 256, init=None):
    """x: (b, s, h, p); dt: (b, s, h); A: (h,); B/C: (b, s, g, n);
    init: (b, h, n, p) or None.

    Returns (y: (b, s, h, p) in x's dtype, final_state: (b, h, n, p) fp32).
    ``s`` must be a multiple of ``min(chunk, s)``; the state starts at
    ``init``, or at 0.  On the card x/B/C are float32 or bfloat16 and
    dt/A/init float32; bf16 launches three kernels, fp32 one.
    """
    q = _check_shapes(x, dt, A, B, C, chunk, init)
    if x.device.type == "cpu":
        y, state = ssd_ref(x, dt, A, B, C, init)
        return y.to(x.dtype), state
    check_operands(x, dt, A, B, C, init)
    _check_device(x, dt, A, B, C, init)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if x.dtype == torch.bfloat16:
        buffers = bf16_buffers(x, B, q)
        ssd_chunk_scan.launches += 1
        launch_bf16(x, dt, A, B, C, q, init, buffers)
        return buffers[0], buffers[1]
    tile = plan(q, n, p)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    err = _entry(x.dtype)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), None if init is None else init.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, s, h, p, g, n, q, tile,
        *_strides(x, B, C), torch.cuda.current_stream(x.device).cuda_stream)
    ssd_chunk_scan.launches += 1
    _build.check(err, "ssd_chunk_scan")
    return y, state


ssd_chunk_scan.launches = 0
