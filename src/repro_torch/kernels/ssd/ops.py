"""Public wrapper of the SSD (Mamba-2) chunk-scan kernel.

CPU tensors take the plain version (``ref.ssd_ref``); CUDA tensors launch
the CUDA kernel or raise.  ``ssd_chunk_scan.launches`` counts the kernel
launches.

The kernel reads x, B and C through their batch and sequence strides, so
the model hands it slices of one convolution output without copying; the
trailing (heads, head_dim) and (groups, d_state) dims must be dense.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import ssd_ref

SMEM_LIMIT = 232_448        # shared memory one block may opt into (H100)
TILES = (64, 32, 16)        # chunk rows per tile, the largest that fits
_ENTRY = {torch.float32: "ssd_chunk_scan_f32",
          torch.bfloat16: "ssd_chunk_scan_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + \
    [ctypes.c_longlong] * 6 + [ctypes.c_void_p]


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def _ld(v: int) -> int:
    """Leading dim (floats) of a shared tile: a multiple of 4 whose quarter
    is odd, so 16-byte reads of 8 consecutive rows hit distinct banks."""
    return v if (v // 4) % 2 else v + 4


def smem_bytes(tile: int, q: int, n: int, p: int) -> int:
    """Shared memory of one block; mirrors ``layout()`` in ``csrc/ssd.cu``:
    C and B tiles (tile x ld(n)), x*dt and y tiles (tile x p), the scores
    (tile x ld(tile)), the carried and the new state (n x p), five per-row
    arrays of the chunk (dt, two decay sums, two decays) and four per-tile
    decay sums."""
    npad, ppad = _round4(n), _round4(p)
    qt = -(-q // tile) * tile
    return 4 * (2 * tile * _ld(npad) + 2 * tile * ppad + tile * _ld(tile)
                + 2 * npad * ppad + 5 * qt + 4 * (qt // tile))


def plan(q: int, n: int, p: int) -> int:
    """Tile rows for chunk length ``q``, d_state ``n`` and head_dim ``p``:
    the largest of ``TILES`` that is not more than twice ``q`` and whose
    block fits ``SMEM_LIMIT``.  Raises ValueError if none fits."""
    for tile in TILES:
        if tile > TILES[-1] and tile // 2 >= q:
            continue
        if smem_bytes(tile, q, n, p) <= SMEM_LIMIT:
            return tile
    raise ValueError(
        f"SSD chunk {q}, d_state {n}, head_dim {p}: even {TILES[-1]}-row "
        f"tiles need {smem_bytes(TILES[-1], q, n, p)} bytes of shared "
        f"memory, above the {SMEM_LIMIT} a block may use")


@functools.cache
def _entry(dtype):
    """The C entry for ``dtype``, with its argument types declared."""
    fn = getattr(_build.library("ssd"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_shapes(x, dt, A, B, C, chunk: int) -> int:
    """Validate shapes; return the chunk length min(chunk, s)."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 \
            or B.shape != C.shape:
        raise ValueError(f"want x (b,s,h,p), dt (b,s,h), A (h,), B/C "
                         f"(b,s,g,n); got {tuple(x.shape)}, {tuple(dt.shape)},"
                         f" {tuple(A.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, s, h, _ = x.shape
    g = B.shape[2]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or tuple(B.shape[:2]) != (b, s) or g == 0 or h % g:
        raise ValueError(f"shapes do not pair: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}")
    if chunk <= 0 or s == 0:
        raise ValueError(f"chunk {chunk} and sequence {s} must be positive")
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}; "
                         "the caller pads (models/ssm.py does)")
    return q


def _check_card(x, dt, A, B, C) -> None:
    if x.dtype not in _ENTRY or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x/B/C dtypes {x.dtype}, {B.dtype}, {C.dtype}: want "
                        "all float32 or all bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt/A dtypes {dt.dtype}, {A.dtype}: want float32")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} is not on {x.device}")
        if t.data_ptr() % t.element_size():
            raise ValueError(f"{name} is not aligned to its element size")
    if not dt.is_contiguous() or not A.is_contiguous():
        raise ValueError("dt and A must be contiguous")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
            raise ValueError(f"{name}: the last two dims must be dense "
                             f"(strides {t.stride()})")


def ssd_chunk_scan(x, dt, A, B, C, *, chunk: int = 256):
    """x: (b, s, h, p); dt: (b, s, h); A: (h,); B/C: (b, s, g, n).

    Returns (y: (b, s, h, p) in x's dtype, final_state: (b, h, n, p) fp32).
    ``s`` must be a multiple of ``min(chunk, s)``; the state starts at 0.
    On the card x/B/C are float32 or bfloat16 and dt/A float32.
    """
    q = _check_shapes(x, dt, A, B, C, chunk)
    if x.device.type == "cpu":
        y, state = ssd_ref(x, dt, A, B, C)
        return y.to(x.dtype), state
    _check_card(x, dt, A, B, C)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    tile = plan(q, n, p)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    fn = _entry(x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), y.data_ptr(), state.data_ptr(),
             b, s, h, p, g, n, q, tile,
             x.stride(0), x.stride(1), B.stride(0), B.stride(1),
             C.stride(0), C.stride(1), stream)
    ssd_chunk_scan.launches += 1
    _build.check(err, "ssd_chunk_scan")
    return y, state


ssd_chunk_scan.launches = 0
