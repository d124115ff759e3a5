"""Public wrappers of the SSD (Mamba-2) chunk-scan kernels, forward and
backward.

CPU tensors take the plain versions (``ref.ssd_ref``, ``ref.ssd_bwd_ref``);
other tensors go to the operators ``torch.ops.repro_torch.ssd_chunk_scan``
and ``.ssd_chunk_scan_bwd``, whose one implementation launches the CUDA
kernels on CUDA tensors and refuses any other device (``launch.cost``'s
counter intercepts them on ``meta`` tensors and counts their work by
formula).  ``ssd_chunk_scan`` on inputs off the CPU that need a gradient
(grad mode on and an input requiring grad) goes through ``SSDChunkScanFn``:
the forward kernels, and the hand-written backward kernels of
``csrc/ssd_bwd.cu``, never a plain path.  ``ssd_chunk_scan.launches`` and
``ssd_chunk_scan_bwd.launches`` count calls of each op that launched on
the card: one per call, whatever the number of kernels.

* bf16 x/B/C: three kernels per call (``csrc/ssd.cu``): chunk states, the
  state pass over the chunks, and the chunk scan.  The wrapper allocates y,
  the state, an fp32 scratch of the h n x p states of each (batch, chunk)
  and the chunks' decay sums; the kernels allocate nothing.
* fp32 x/B/C: one kernel per call, on the CUDA cores in fp32.

The backward (``csrc/ssd_bwd.cu``, any x/B/C dtype of the forward):

* bf16: five kernels per call, every product on the tensor cores
  (``mma.sync``, hi + lo halves for operands that are not bf16 data):
  the chunk-local state terms; the state pass (the states entering and
  the gradients leaving each chunk, packed hi / lo); the key rows' dx and
  dB, with C B^T once per tile of heads and dy x'^T once per head and tile
  pair, whose decayed M2 it hands to the queries kernel (through a
  scratch of at most ``M2_BYTES``: longer calls run keys and queries over
  slices of the (chunk, batch) rows); the query rows' dC; and the decay
  gradient (ddt, dA) with the sums of dB and dC over each group's head
  tiles.  d cum's intra terms are sums of one fp32 copy of the scores in
  the keys kernel (they cancel in d(dt A)).  What bounds
  it: the tensor cores at ~0.12 ms at mamba2's train shape; the kernels
  execute ~2.3x those FLOPs and move ~1.6 GB of scratch (PERF.md has what
  holds them above it).  ``bwd_bf16_plan`` gives grids, shared memory and
  scratch, and raises before any launch on a shape they do not take.
* fp32: four kernels per call on the CUDA cores in fp32, the first
  design's, kept for full fp32 products (its 5e-4 tolerance and phase 4's
  card-vs-CPU gradients rest on them); ``bwd_plan`` gives their tile.

``bwd_buffers`` allocates the outputs and scratch (``BwdBuffers``);
``launch_bwd`` launches chosen kernels (bits of ``BWD_STAGES[dtype]``) on
them, uncounted, so that ``chip_smoke.py`` can time and check each stage
alone.

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
from repro_torch.kernels.ssd.ref import ssd_bwd_ref, ssd_ref

SMEM_LIMIT = 232_448        # shared memory one block may opt into (H100)
TILES = (64, 32, 16)        # fp32 kernel, backward: chunk rows per tile, the largest that fits
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
# the backward's kernels of each entry, as bits of the ``stages`` of
# launch_bwd; BWD_ALL_STAGES runs either whole
BWD_STAGES = {torch.float32: {"states": 1, "keys": 2, "queries": 4,
                              "finish": 8},
              torch.bfloat16: {"chunk": 1, "pass": 2, "keys": 4,
                               "queries": 8, "finish": 16}}
BWD_ALL_STAGES = 31
BWD_HEADS = 16              # heads of one group per keys / queries block
BWD_TILE = 64               # bf16: rows of a key or query tile
M2_BYTES = 1 << 29          # bf16: the most M2 scratch of one call; longer
                            # calls run keys and queries over slices of it
_BWD_ENTRY = {torch.float32: "ssd_chunk_scan_bwd_f32",
              torch.bfloat16: "ssd_chunk_scan_bwd_bf16"}
# fp32: 20 tensors, (b, s, h, p, g, n, chunk, tile, heads); bf16: 23
# tensors, (b, s, h, p, g, n, chunk, heads, M2 rows); then both the strides,
# the stages and the stream
_BWD_ARGTYPES = {
    dtype: [ctypes.c_void_p] * k + [ctypes.c_int] * 9
    + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p]
    for dtype, k in ((torch.float32, 20), (torch.bfloat16, 23))}


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


def bwd_smem_bytes(tile: int, q: int, n: int, p: int) -> dict:
    """Shared memory of one block of each backward kernel; mirrors
    ``states_floats`` and ``pass_layout`` in ``csrc/ssd_bwd.cu``: the
    chunk's per-row arrays (dt, two decay sums, a factor; per tile three
    sums, and the chunk's) and, in the states kernel, the running state, an
    n-wide and a p-wide row tile and 8 warp partials; in the keys and
    queries kernels their own and the other tile's n- and p-wide rows, the
    decayed scores, the n-wide accumulator and a state; keys add the
    C B^T scores and the p-wide accumulator, queries a second n-wide one."""
    npad, ppad = _round(n, 4), _round(p, 4)
    ldn, ldp, ldt = _ld(npad), _ld(ppad), _ld(tile)
    qt = _round(q, tile)
    rows = 4 * qt + 3 * (qt // tile) + 1
    shared = 2 * tile * (ldn + ldp) + tile * ldt + tile * ldn + npad * ldp \
        + rows
    return {"states": 4 * (npad * ldp + tile * (ldn + ldp) + rows + 8),
            "keys": 4 * (shared + tile * (ldt + ldp) + 2 * tile),
            "queries": 4 * (shared + tile * ldn + tile),
            "finish": 32}


def bwd_plan(q: int, n: int, p: int) -> int:
    """fp32 backward: tile rows for chunk ``q``, d_state ``n`` and head_dim
    ``p``, chosen as ``plan`` chooses the forward's against the largest
    kernel's shared memory.  Raises ValueError if none fits."""
    for tile in TILES:
        if tile > TILES[-1] and tile // 2 >= q:
            continue
        if max(bwd_smem_bytes(tile, q, n, p).values()) <= SMEM_LIMIT:
            return tile
    raise ValueError(
        f"SSD backward, chunk {q}, d_state {n}, head_dim {p}: even "
        f"{TILES[-1]}-row tiles need "
        f"{max(bwd_smem_bytes(TILES[-1], q, n, p).values())} bytes of shared "
        f"memory, above the {SMEM_LIMIT} a block may use")


def state_group(n: int, p: int) -> int:
    """Elements of a packing group of the bf16 backward's state scratch
    (``packed_at`` in ``csrc/ssd_bwd.cu``): 64 where n p is a multiple of
    64, else 8, so a small head (jamba's n p = 16) is not padded to 64."""
    return 64 if (n * p) % 64 == 0 else 8


@dataclass(frozen=True)
class Bf16BwdPlan:
    """Launch plan of the five bf16 backward kernels; mirrors
    ``launch_bf16_pp`` and ``chunk_smem`` / ``keys_layout`` /
    ``queries_layout`` in ``csrc/ssd_bwd.cu``."""
    pp: int                  # head_dim padded to 16, 32 or 64 (a template)
    npad: int                # d_state padded to 16
    qt: int                  # chunk padded to 64 rows
    heads_per_block: int     # heads of one group per keys / queries block
    grids: dict              # kernel -> (x, y, z) blocks of 256 threads;
                             # keys and queries: those of one slice
    smem: dict               # kernel -> shared bytes of one block
    state_row: int           # fp32 of a (batch, chunk) row of the two state
                             # scratches: h heads of n * p rounded up to a
                             # packing group (each packed hi / lo by the
                             # state pass)
    m2_rows: int             # (chunk, batch) rows of a keys / queries slice
    slices: int              # keys / queries launches of each
    m2_shape: tuple          # (m2_rows, h, pairs, 2, tm, tm) bf16: M2 = dy
                             # x'^T o L, hi and lo, of each (q tile, key
                             # tile) pair, key tile at or before the q tile;
                             # tm the chunk rounded up to 16, at most 64
    cols_shape: tuple        # (b, s, h, chunk tiles) fp32: each key tile's
                             # share of C . dC's intra part of a row; None
                             # for a chunk of one tile (the keys kernel adds
                             # it to d cum itself)
    b_nc: int                # (chunk, batch) rows of the call

    @property
    def scratch_bytes(self) -> int:
        cols = _prod(self.cols_shape) if self.cols_shape else 0
        return 4 * (2 * self.b_nc * self.state_row + cols) \
            + 2 * _prod(self.m2_shape)


def bwd_bf16_plan(b: int, s: int, h: int, p: int, g: int, n: int,
                  q: int) -> Bf16BwdPlan:
    """Grids, shared memory and scratch of the bf16 backward for x (b, s,
    h, p), B/C (b, s, g, n) and chunk ``q`` (s a multiple of q).  Raises
    ValueError, before any launch, for shapes its kernels do not take: a
    chunk above 256 rows, d_state above 128, head_dim above 64, more than
    65535 (chunk, batch) pairs."""
    if q > QMAX or n > NMAX or p > PMAX:
        raise ValueError(
            f"the bf16 SSD backward takes chunks of at most {QMAX} rows, "
            f"d_state at most {NMAX} and head_dim at most {PMAX}; got chunk "
            f"{q}, d_state {n}, head_dim {p}")
    nc = s // q
    if nc * b > 65535:
        raise ValueError(f"{nc} chunks x batch {b} exceed the grid's 65535")
    pp = 16 if p <= 16 else 32 if p <= 32 else 64
    npad, qt = _round(n, 16), _round(q, BWD_TILE)
    nt, t = qt // BWD_TILE, BWD_TILE
    lb, lx = 2 * (npad + 8), 2 * (pp + 8)        # bytes of a padded row
    heads = min(BWD_HEADS, h // g)
    tiles = g * -(-(h // g) // heads)
    smem = {
        # two ring stages of (B or C rows, x or dy rows), the scaled rows hi
        # and lo, the rows' two factors and the scan's partials
        "chunk": 2 * t * (lb + lx) + 2 * t * lx + 4 * (2 * QMAX + 8),
        # B rows, C B^T per q tile (fp32), x rows of two heads, dS hi and
        # lo, three stages of (C, dy rows), dt of two heads, the decay tables
        # (dt A, exp of the per-row and between-block sums), the rows' three
        # dots of two halves, the warps' column sums of S per q tile
        "keys": t * lb + 4 * nt * t * t + 2 * t * lx + 2 * npad * lx
        + 3 * t * (lb + lx) + 4 * 2 * QMAX
        + 4 * (2 * QMAX + 16 * 16 + 2 * t) + 4 * 2 * 3 * t + 4 * nt * 4 * t,
        # C rows, B rows of every key tile, dy rows, S_prev hi and lo, three
        # stages of an M2 tile (hi, lo), dt, exp(cum) and the scan's
        # partials, the rows' dots
        "queries": t * lb + nt * t * lb + t * lx + 2 * npad * lx
        + 3 * 2 * 2 * t * (t + 8) + 4 * QMAX + 4 * (t + 8) + 4 * 2 * t,
        "pass": 0, "finish": 0}
    if max(smem.values()) > SMEM_LIMIT:
        raise ValueError(f"SSD backward, chunk {q}, d_state {n}, head_dim "
                         f"{p}: {max(smem.values())} bytes of shared memory, "
                         f"above the {SMEM_LIMIT} a block may use")
    row = h * _round(n * p, state_group(n, p))
    finish = h + -(-(b * s * g * n) // THREADS)
    tm = t if nt > 1 else _round(q, 16)
    m2_row = h * (nt * (nt + 1) // 2) * 2 * tm * tm    # bf16 of a row
    rows = min(nc * b, max(1, M2_BYTES // (2 * m2_row)))
    return Bf16BwdPlan(
        pp=pp, npad=npad, qt=qt, heads_per_block=heads,
        grids={"chunk": (nc, h, b), "pass": (h, b, 1),
               "keys": (tiles, rows, nt), "queries": (tiles, rows, nt),
               "finish": (finish, 1, 1)},
        smem=smem, state_row=row, m2_rows=rows, slices=-(-(nc * b) // rows),
        m2_shape=(rows, h, nt * (nt + 1) // 2, 2, tm, tm),
        cols_shape=(b, s, h, nt) if nt > 1 else None, b_nc=nc * b)


def unpack_states(buf, h: int, n: int, p: int):
    """(b, nc, h, n, p) fp32 of a bf16 backward's state scratch after its
    state pass (``Bf16BwdPlan.state_row``): hi + lo of each element."""
    b, nc, row = buf.shape
    e, k = n * p, state_group(n, p)
    planes = buf.view(torch.bfloat16).reshape(b, nc, row // k, 2, k)
    full = planes[:, :, :, 0].float() + planes[:, :, :, 1].float()
    return full.reshape(b, nc, h, -1)[..., :e].reshape(b, nc, h, n, p)


def bwd_row_dcum(buffers, q: int):
    """Each row's d cum share (b, s, h) fp32 once the keys and queries
    kernels ran: the scratch as it is, but where a bf16 chunk spans more
    than one key tile, plus the key tiles' shares of C . dC (``cols``:
    those of key tiles at or before the row's), which the finish kernel
    adds itself."""
    dcum, cols = buffers.dcum, buffers.cols
    if cols is None:
        return dcum
    b, s, h, nt = cols.shape
    row = torch.arange(s, device=cols.device) % q // BWD_TILE
    keep = torch.arange(nt, device=cols.device)[None, :] <= row[:, None]
    return dcum + torch.where(keep[None, :, None, :], cols, 0.0).sum(-1)


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
    dt/A/init float32; bf16 launches three kernels, fp32 one.  With a
    gradient to take, the call is ``SSDChunkScanFn``'s (the backward
    kernels).
    """
    q = _check_shapes(x, dt, A, B, C, chunk, init)
    if x.device.type == "cpu":
        y, state = ssd_ref(x, dt, A, B, C, init)
        return y.to(x.dtype), state
    check_operands(x, dt, A, B, C, init)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, B, C, init)):
        return SSDChunkScanFn.apply(x, dt, A, B, C, q, init)
    return torch.ops.repro_torch.ssd_chunk_scan(x, dt, A, B, C, q, init)


ssd_chunk_scan.launches = 0


def _op(x, dt, A, B, C, q, init):
    """``repro_torch::ssd_chunk_scan`` over chunks of ``q`` rows: one call
    (three bf16 kernels or one fp32) -> (y, final state)."""
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


# the operator, one implementation for every device (the kernels check it)
_lib = torch.library.Library("repro_torch", "FRAGMENT")
_lib.define("ssd_chunk_scan(Tensor x, Tensor dt, Tensor A, Tensor B, "
            "Tensor C, int chunk, Tensor? init) -> (Tensor, Tensor)")
_lib.impl("ssd_chunk_scan", _op, "CompositeExplicitAutograd")


# ------------------------------------------------------------ the backward
@functools.cache
def _bwd_entry(dtype):
    """The backward's C entry for ``dtype``, with its argument types."""
    fn = getattr(_build.library("ssd_bwd"), _BWD_ENTRY[dtype])
    fn.argtypes = _BWD_ARGTYPES[dtype]
    fn.restype = ctypes.c_int
    return fn


def _check_dy(x, dy, dstate, n: int) -> None:
    b, s, h, p = x.shape
    if tuple(dy.shape) != (b, s, h, p) or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype}: want "
                         f"{(b, s, h, p)} {x.dtype}")
    if dstate is not None and (tuple(dstate.shape) != (b, h, n, p)
                               or dstate.dtype != torch.float32):
        raise ValueError(f"dstate {tuple(dstate.shape)} {dstate.dtype}: want "
                         f"{(b, h, n, p)} float32")
    for name, t in (("dy", dy), ("dstate", dstate)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bwd_heads(h: int, g: int) -> int:
    """Heads of one group per keys / queries block of the backward."""
    return min(BWD_HEADS, h // g)


@dataclass
class BwdBuffers:
    """The outputs and scratch of one backward call (``bwd_buffers``)."""
    dx: torch.Tensor         # (b, s, h, p), x's dtype
    ddt: torch.Tensor        # (b, s, h) fp32
    dA: torch.Tensor         # (h,) fp32
    dB: torch.Tensor         # (b, s, g, n), B's dtype
    dC: torch.Tensor         # (b, s, g, n), C's dtype
    dinit: torch.Tensor      # (b, h, n, p) fp32
    prev: torch.Tensor       # the states entering each chunk, fp32: (b, nc,
                             # h, n, p); bf16: (b, nc, state_row), the chunk
                             # states until the state pass packs them
    grads: torch.Tensor      # the gradients of the states leaving each
                             # chunk, the same layout
    delta: torch.Tensor      # <S_out, dS> (b, nc, h) fp32
    dcum: torch.Tensor       # each row's d cum share (b, s, h) fp32
    dBp: torch.Tensor        # the head tiles' dB partials (b, s, g x tiles,
                             # n) fp32
    dCp: torch.Tensor        # and dC's
    tot: torch.Tensor | None = None    # bf16: each chunk's sum of dt A (b,
                                       # nc, h) fp32
    m2: torch.Tensor | None = None     # bf16: Bf16BwdPlan.m2_shape
    cols: torch.Tensor | None = None   # bf16: Bf16BwdPlan.cols_shape

    @property
    def outputs(self) -> tuple:
        """(dx, ddt, dA, dB, dC, dinit)."""
        return self.dx, self.ddt, self.dA, self.dB, self.dC, self.dinit


def bwd_buffers(x, B, q: int) -> BwdBuffers:
    """The outputs and scratch of one backward call (``BwdBuffers``), with
    ``torch.empty`` on x's device."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = s // q
    tiles = g * -(-(h // g) // bwd_heads(h, g))
    dev, f32 = x.device, torch.float32

    def empty(shape, dtype=f32):
        return None if shape is None else torch.empty(shape, dtype=dtype,
                                                      device=dev)

    states, bf16 = (b, nc, h, n, p), {}
    if x.dtype == torch.bfloat16:
        pl = bwd_bf16_plan(b, s, h, p, g, n, q)
        states = (b, nc, pl.state_row)
        bf16 = dict(tot=empty((b, nc, h)),
                    m2=empty(pl.m2_shape, torch.bfloat16),
                    cols=empty(pl.cols_shape))
    return BwdBuffers(
        dx=empty((b, s, h, p), x.dtype), ddt=empty((b, s, h)),
        dA=empty((h,)), dB=empty((b, s, g, n), B.dtype),
        dC=empty((b, s, g, n), B.dtype), dinit=empty((b, h, n, p)),
        prev=empty(states), grads=empty(states), delta=empty((b, nc, h)),
        dcum=empty((b, s, h)), dBp=empty((b, s, tiles, n)),
        dCp=empty((b, s, tiles, n)), **bf16)


_BWD_FIELDS = ("dx", "ddt", "dA", "dB", "dC", "dinit", "prev", "grads",
               "delta", "dcum", "dBp", "dCp")


def launch_bwd(x, dt, A, B, C, dy, q: int, init, dstate,
               buffers: BwdBuffers, stages: int = BWD_ALL_STAGES) -> None:
    """Launch the backward kernels named by ``stages`` (bits of
    ``BWD_STAGES[x.dtype]``) on ``buffers`` (``bwd_buffers``); all of them
    are ``ssd_chunk_scan_bwd``.  Counts nothing.  The bf16 plan raises
    before any launch on a shape its kernels do not take."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]

    def ptr(t):
        return None if t is None else t.data_ptr()

    tensors = [ptr(getattr(buffers, f)) for f in _BWD_FIELDS]
    if x.dtype == torch.bfloat16:
        pl = bwd_bf16_plan(b, s, h, p, g, n, q)
        tensors += [ptr(buffers.tot), ptr(buffers.m2), ptr(buffers.cols)]
        ints = (b, s, h, p, g, n, q, bwd_heads(h, g), pl.m2_rows)
    else:
        ints = (b, s, h, p, g, n, q, bwd_plan(q, n, p), bwd_heads(h, g))
    err = _bwd_entry(x.dtype)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), ptr(init), dy.data_ptr(), ptr(dstate), *tensors, *ints,
        *_strides(x, B, C), stages,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_chunk_scan_bwd")


def ssd_chunk_scan_bwd(x, dt, A, B, C, dy, *, chunk: int = 256, init=None,
                       dstate=None):
    """(dx, ddt, dA, dB, dC, dinit) of ``ssd_chunk_scan`` at (x, dt, A, B,
    C, init) for the output gradient ``dy`` (x's dtype and shape) and the
    final state's ``dstate`` (b, h, n, p) fp32, or None (zeros).  dx, dB
    and dC come in x's dtype, the rest fp32; dB and dC sum over each
    group's heads.  CPU tensors take ``ssd_bwd_ref``."""
    q = _check_shapes(x, dt, A, B, C, chunk, init)
    _check_dy(x, dy, dstate, B.shape[3])
    if x.device.type == "cpu":
        dx, ddt, dA, dB, dC, dinit = ssd_bwd_ref(x, dt, A, B, C, init, dy,
                                                 dstate, chunk=q)
        return dx.to(x.dtype), ddt, dA, dB.to(B.dtype), dC.to(C.dtype), dinit
    check_operands(x, dt, A, B, C, init)
    return torch.ops.repro_torch.ssd_chunk_scan_bwd(x, dt, A, B, C, dy, q,
                                                    init, dstate)


ssd_chunk_scan_bwd.launches = 0


def _bwd_op(x, dt, A, B, C, dy, q, init, dstate):
    """``repro_torch::ssd_chunk_scan_bwd``: one backward call (five bf16
    kernels or four fp32) -> (dx, ddt, dA, dB, dC, dinit)."""
    _check_device(x, dt, A, B, C, init)
    for name, t in (("dy", dy), ("dstate", dstate)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is not on {x.device}")
    buffers = bwd_buffers(x, B, q)
    ssd_chunk_scan_bwd.launches += 1
    launch_bwd(x, dt, A, B, C, dy, q, init, dstate, buffers)
    return buffers.outputs


_lib.define("ssd_chunk_scan_bwd(Tensor x, Tensor dt, Tensor A, Tensor B, "
            "Tensor C, Tensor dy, int chunk, Tensor? init, Tensor? dstate) "
            "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
_lib.impl("ssd_chunk_scan_bwd", _bwd_op, "CompositeExplicitAutograd")


class SSDChunkScanFn(torch.autograd.Function):
    """The SSD chunk scan with its gradient, off the CPU only: both
    directions are the hand-written kernels (the forward's op, then
    ``ssd_chunk_scan_bwd``).  On the CPU, autograd through the chunked
    plain path of ``models/ssm.py`` is the gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, q, init):
        y, state = torch.ops.repro_torch.ssd_chunk_scan(x, dt, A, B, C, q,
                                                        init)
        ctx.save_for_backward(x, dt, A, B, C, init)
        ctx.q = q
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, init = ctx.saved_tensors
        dy = x.new_zeros(x.shape) if dy is None else dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        dx, ddt, dA, dB, dC, dinit = torch.ops.repro_torch.ssd_chunk_scan_bwd(
            x, dt, A, B, C, dy, ctx.q, init, dstate)
        return dx, ddt, dA, dB, dC, None, None if init is None else dinit
