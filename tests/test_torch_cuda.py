"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes are the Pallas sweep of ``tests/test_kernels.py`` plus ragged
lengths and empty sequences; tolerances fp32 3e-5, bf16 2e-2 (SSD: fp32
5e-4, as the reference's SSD test; bf16 x/B/C 2e-2).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_ref  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
DTYPES = ("float32", "bfloat16")

FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64, True, 0, 0.0),       # GQA causal
    (1, 256, 256, 4, 4, 128, True, 128, 50.0),   # window + softcap
    (2, 128, 384, 8, 2, 64, False, 0, 0.0),      # cross/bidir
    (1, 384, 384, 2, 1, 128, True, 0, 0.0),      # MQA, non-pow2 blocks
    (1, 200, 200, 4, 2, 64, True, 0, 0.0),       # ragged
    (1, 300, 300, 4, 1, 128, True, 0, 0.0),
    (1, 128, 300, 4, 2, 64, False, 0, 0.0),
    (1, 300, 300, 2, 2, 64, True, 100, 20.0),
    # where the bf16 kernel's TMA ring and its 128-row q / 96-key tiles
    # change behaviour
    (1, 64, 1, 4, 2, 128, False, 0, 0.0),        # sk 1
    (1, 64, 63, 4, 2, 128, False, 0, 0.0),       # sk 63
    (1, 96, 65, 4, 1, 128, False, 0, 0.0),       # sk 65
    (1, 128, 127, 4, 2, 64, False, 0, 0.0),      # sk 127
    (1, 128, 129, 4, 2, 128, False, 0, 0.0),     # sk 129
    (1, 128, 150, 4, 2, 128, False, 0, 0.0),     # 2 k tiles: fewer than the ring's 3 stages
    (2, 1, 300, 8, 2, 128, False, 0, 0.0),       # sq 1
    (1, 1, 1, 2, 1, 64, True, 0, 0.0),           # sq = sk = 1
    (2, 100, 300, 8, 2, 128, True, 0, 0.0),      # causal with sq < sk
    (1, 300, 300, 4, 2, 128, True, 100, 0.0),    # window across 128-row tiles
    (1, 300, 300, 4, 2, 64, True, 150, 30.0),    # dh 64, window and softcap
    (3, 200, 131, 4, 2, 128, False, 0, 0.0),     # b > 1, ragged sk
    (3, 131, 131, 4, 4, 128, True, 0, 0.0),      # b > 1, ragged, causal
]
DECODE_SHAPES = [
    (2, 512, 4, 2, 64, 0),
    (2, 512, 4, 4, 128, 128),     # MHA + sliding window
    (1, 300, 8, 2, 64, 0),        # ragged cache length
    (3, 256, 16, 2, 128, 64),
    (2, 300, 24, 2, 128, 0),      # 12 query heads per kv head
    (2, 300, 32, 2, 128, 0),      # 16 query heads per kv head
    (2, 4100, 32, 4, 128, 0),     # S not a multiple of the tile, many splits
]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(rng, b, sq, sk, h, kv, dh):
    return (rng.standard_normal((b, sq, h, dh), np.float32),
            rng.standard_normal((b, sk, kv, dh), np.float32),
            rng.standard_normal((b, sk, kv, dh), np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,softcap",
                         FLASH_SHAPES)
def test_flash_kernel_vs_plain_on_card(cuda, b, sq, sk, h, kv, dh, causal,
                                       window, softcap, dtype):
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
               for a in _qkv(rng, b, sq, sk, h, kv, dh))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_ops.flash_attention.launches
    out = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == before + 1
    assert torch.isfinite(out).all()
    ref = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,S,h,kv,dh,window", DECODE_SHAPES)
def test_decode_kernel_vs_plain_on_card(cuda, b, S, h, kv, dh, window, dtype):
    rng = np.random.default_rng(14)
    q = rng.standard_normal((b, h, dh), np.float32)
    k, v = (rng.standard_normal((b, S, kv, dh), np.float32) for _ in "kv")
    lengths = rng.integers(max(window, 8), S, (b,)).astype(np.int32)
    lengths[0] = 0                    # an empty sequence gets 0
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
               for a in (q, k, v))
    lens = torch.from_numpy(lengths).to(cuda)
    out = decode_ops.decode_attention(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q, k, v, lens, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


SSD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
SSD_SHAPES = [                    # (b, s, h, p, g, n, chunk)
    (2, 128, 4, 16, 1, 32, 32),
    (1, 256, 8, 32, 2, 16, 64),
    (1, 128, 4, 1, 1, 16, 16),    # head_dim 1 (jamba / mamba-1 mode)
    (2, 192, 6, 8, 3, 8, 64),     # uneven groups
    (1, 300, 4, 64, 1, 128, 100),  # chunk not a multiple of the tile
    (2, 512, 4, 64, 1, 128, 256),  # mamba2's head_dim, d_state and chunk
    # the bf16 kernels' head tiles: 20 heads a group (a tile of 16 and one
    # of 4), 8 a group in two groups
    (1, 256, 40, 32, 2, 64, 128),
    (1, 512, 16, 64, 2, 128, 256),
    (4, 2048, 80, 64, 1, 128, 256),  # mamba2-2.7b's serving shape
    # the bf16 scratch packs the heads' states: 24-float states (groups of
    # 64 span heads); jamba's head_dim, d_state and chunk over 40 heads
    (1, 128, 5, 3, 1, 8, 32),
    (2, 256, 40, 1, 1, 16, 16),
]


def _ssd_inputs(cuda, b, s, h, p, g, n, dtype, seed=15):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    B, C = (rng.standard_normal((b, s, g, n)).astype(np.float32)
            for _ in "BC")
    low = getattr(torch, dtype)
    return (torch.from_numpy(x).to(cuda, low), torch.from_numpy(dt).to(cuda),
            torch.from_numpy(A).to(cuda), torch.from_numpy(B).to(cuda, low),
            torch.from_numpy(C).to(cuda, low))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
def test_ssd_kernel_vs_plain_on_card(cuda, b, s, h, p, g, n, chunk, dtype):
    x, dt, A, B, C = _ssd_inputs(cuda, b, s, h, p, g, n, dtype)
    before = ssd_ops.ssd_chunk_scan.launches
    y, state = ssd_ops.ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_chunk_scan.launches == before + 1
    assert y.dtype == x.dtype and state.dtype == torch.float32
    yr, sr = ssd_ref(x, dt, A, B, C)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), yr, atol=tol, rtol=tol)
    torch.testing.assert_close(state, sr, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 64, 4, 16, 1, 32, 32),
    (1, 512, 8, 64, 1, 128, 256),    # mamba2's widths: 16-byte copies
])
def test_ssd_kernel_reads_strided_slices(cuda, b, s, h, p, g, n, chunk):
    """x, B and C as slices of one conv output, as the model passes them."""
    rng = np.random.default_rng(16)
    conv = torch.from_numpy(rng.standard_normal(
        (b, s, h * p + 2 * g * n), np.float32)).to(cuda, torch.bfloat16)
    x = conv[..., :h * p].view(b, s, h, p)
    B = conv[..., h * p:h * p + g * n].view(b, s, g, n)
    C = conv[..., h * p + g * n:].view(b, s, g, n)
    dt = torch.rand((b, s, h), device=cuda)
    A = -torch.rand((h,), device=cuda) - 0.5
    y, state = ssd_ops.ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)
    yr, sr = ssd_ops.ssd_chunk_scan(x.contiguous(), dt, A, B.contiguous(),
                                    C.contiguous(), chunk=chunk)
    torch.testing.assert_close(y, yr, atol=0, rtol=0)
    torch.testing.assert_close(state, sr, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 128, 4, 16, 1, 32, 32),
    (1, 400, 4, 64, 1, 128, 100),   # halves of 200: two ragged q tiles each
    (2, 1024, 16, 64, 1, 128, 256),
    (1, 128, 5, 3, 1, 8, 32),       # 24-float states packed in the scratch
])
def test_ssd_kernel_continues_from_a_state(cuda, b, s, h, p, g, n, chunk,
                                           dtype):
    """The second half started from the first half's state equals the
    whole sequence in one call."""
    x, dt, A, B, C = _ssd_inputs(cuda, b, s, h, p, g, n, dtype, seed=17)
    half = s // 2
    y1, s1 = ssd_ops.ssd_chunk_scan(x[:, :half], dt[:, :half].contiguous(),
                                    A, B[:, :half], C[:, :half], chunk=chunk)
    before = ssd_ops.ssd_chunk_scan.launches
    y2, s2 = ssd_ops.ssd_chunk_scan(x[:, half:], dt[:, half:].contiguous(),
                                    A, B[:, half:], C[:, half:], chunk=chunk,
                                    init=s1)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_chunk_scan.launches == before + 1
    yr, sr = ssd_ref(x, dt, A, B, C)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(torch.cat([y1, y2], 1).float(), yr, atol=tol,
                               rtol=tol)
    torch.testing.assert_close(s2, sr, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_ssd_kernels_in_cuda_graph(cuda):
    """The bf16 op's three launches are captured and replayed."""
    x, dt, A, B, C = _ssd_inputs(cuda, 2, 512, 8, 64, 1, 128, "bfloat16")
    ssd_ops.ssd_chunk_scan(x, dt, A, B, C)          # warm-up, outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, state = ssd_ops.ssd_chunk_scan(x, dt, A, B, C)
    x.copy_(torch.flip(x, (1,)))
    graph.replay()
    torch.cuda.synchronize()
    yr, sr = ssd_ref(x, dt, A, B, C)
    torch.testing.assert_close(y.float(), yr, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(state, sr, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_on_card_never_takes_a_plain_path(cuda, monkeypatch, dtype):
    """ssd_scan with a state, on CUDA tensors, launches the kernels: the
    plain versions are made to raise."""
    from repro_torch.models import ssm

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain path")

    monkeypatch.setattr(ssd_ops, "ssd_ref", refuse)
    monkeypatch.setattr(ssm, "_ssd_chunked", refuse)
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 300, 4, 16, 1, 32, dtype)
    init = torch.randn((1, 4, 32, 16), device=cuda)
    before = ssd_ops.ssd_chunk_scan.launches
    y, state = ssm.ssd_scan(x, dt, A, B, C, 128, init)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_chunk_scan.launches == before + 1
    assert y.shape == x.shape and torch.isfinite(y.float()).all()
    assert torch.isfinite(state).all()


def _decode_lengths_case(cuda, dtype, S, lengths, window=0, h=8, kv=2,
                         dh=128):
    rng = np.random.default_rng(18)
    b = len(lengths)
    q = rng.standard_normal((b, h, dh), np.float32)
    k, v = (rng.standard_normal((b, S, kv, dh), np.float32) for _ in "kv")
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
               for a in (q, k, v))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", (0, 100))
def test_decode_kernel_edge_lengths_on_card(cuda, dtype, window):
    """Lengths 0, 1, one split - 1, one split, one split + 1 and S."""
    S, b, kv = 1000, 6, 2
    chunk, _ = decode_ops.split_plan(
        S, torch.cuda.get_device_properties(cuda).multi_processor_count,
        b * kv)
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, S]
    q, k, v, lens = _decode_lengths_case(cuda, dtype, S, lengths, window,
                                         kv=kv)
    out = decode_ops.decode_attention(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    ref = decode_attention_ref(q, k, v, lens, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_in_cuda_graph_reads_lengths_on_device(cuda, dtype):
    """One capture, two replays with lengths changed in place between
    them: the wrapper must not read lengths on the host."""
    S = 700
    q, k, v, lens = _decode_lengths_case(cuda, dtype, S, [650, 3, 129, 0])
    before = decode_ops.decode_attention.launches
    decode_ops.decode_attention(q, k, v, lens)      # warm-up, outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_ops.decode_attention(q, k, v, lens)
    assert decode_ops.decode_attention.launches == before + 2
    for lengths in ([650, 3, 129, 0], [1, 700, 0, 64]):
        lens.copy_(torch.tensor(lengths, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, lens)
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
