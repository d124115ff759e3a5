"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes are the Pallas sweep of ``tests/test_kernels.py`` plus ragged
lengths and empty sequences; tolerances fp32 3e-5, bf16 2e-2 (SSD: fp32
5e-4, as the reference's SSD test; bf16 x/B/C 2e-2).  The flash-attention
backward kernel is held against autograd through the plain forward
(``attention_bwd_ref``) at the same tolerances; the SSD backward kernels
against ``ssd_bwd_ref`` at the SSD tolerances (ddt and dA also within
2e-5 of their largest entry); the train steps on the card against the
CPU's at 2e-3 (see ``test_full_width_train_step_card_vs_cpu`` and
``test_mamba2_train_step_card_vs_cpu``).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_lse_ref, attention_ref)
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_bwd_ref, ssd_ref  # noqa: E402

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
    # whisper's encoder rows (1500: no multiple of any tile), non-causal;
    # gemma2's window and softcap where the window bites at its length
    (1, 1500, 1500, 4, 4, 64, False, 0, 0.0),
    (1, 5120, 5120, 4, 2, 128, True, 4096, 50.0),
    # granite's heads (24 q / 8 kv: g 3, dh 64) and dbrx's (48 / 8: g 6,
    # dh 128), causal with ragged tails and sq < sk
    (2, 300, 300, 24, 8, 64, True, 0, 0.0),
    (1, 100, 229, 24, 8, 64, True, 0, 0.0),
    (2, 200, 200, 48, 8, 128, True, 0, 0.0),
    (1, 131, 259, 48, 8, 128, True, 0, 0.0),
    # stablelm-3b's head dim 80 (two 64-column boxes, columns 80-127 zero):
    # its heads (32 / 32: g 1) causal with ragged tiles; g 4 with a window
    # and softcap; non-causal, ragged; causal sq < sk
    (2, 200, 200, 32, 32, 80, True, 0, 0.0),
    (1, 300, 300, 8, 2, 80, True, 150, 30.0),
    (2, 129, 127, 4, 4, 80, False, 0, 0.0),
    (1, 65, 129, 4, 1, 80, True, 0, 0.0),
]
DECODE_SHAPES = [                 # (b, S, h, kv, dh, window, softcap)
    (2, 512, 4, 2, 64, 0, 0.0),
    (2, 512, 4, 4, 128, 128, 0.0),     # MHA + sliding window
    (1, 300, 8, 2, 64, 0, 0.0),        # ragged cache length
    (3, 256, 16, 2, 128, 64, 0.0),
    (2, 300, 24, 2, 128, 0, 0.0),      # 12 query heads per kv head
    (2, 300, 32, 2, 128, 0, 0.0),      # 16 query heads per kv head
    (2, 4100, 32, 4, 128, 0, 0.0),     # S not a multiple of the tile
    # softcaps (gemma2: 50), windowed and not, at dh 128 and 64; gemma2's
    # heads (32 q / 16 kv) and window over lengths of 4096-4351
    (2, 512, 4, 4, 128, 128, 50.0),
    (1, 300, 8, 2, 64, 0, 30.0),
    (2, 4352, 32, 16, 128, 4096, 50.0),
    # granite's heads (g 3, dh 64) and dbrx's (g 6, dh 128), ragged caches
    (3, 777, 24, 8, 64, 0, 0.0),
    (2, 1029, 48, 8, 128, 0, 0.0),
    # stablelm-3b's head dim 80: its heads (g 1) over a ragged cache; g 4
    # with a window and softcap; g 16
    (3, 777, 32, 32, 80, 0, 0.0),
    (2, 512, 8, 2, 80, 128, 50.0),
    (1, 300, 16, 1, 80, 0, 30.0),
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
@pytest.mark.parametrize("b,S,h,kv,dh,window,softcap", DECODE_SHAPES)
def test_decode_kernel_vs_plain_on_card(cuda, b, S, h, kv, dh, window,
                                        softcap, dtype):
    rng = np.random.default_rng(14)
    q = rng.standard_normal((b, h, dh), np.float32)
    k, v = (rng.standard_normal((b, S, kv, dh), np.float32) for _ in "kv")
    lengths = rng.integers(max(window, 8), S, (b,)).astype(np.int32)
    lengths[0] = 0                    # an empty sequence gets 0
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
               for a in (q, k, v))
    lens = torch.from_numpy(lengths).to(cuda)
    kw = dict(window=window, softcap=softcap)
    out = decode_ops.decode_attention(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q, k, v, lens, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_decode_on_card(cuda, dtype):
    """whisper's decode-step cross-attention: one query token per head
    against all 1500 frames of the ``ck`` / ``cv`` cache (12 heads, dh 64,
    lengths = the frame count), as ``Model._cross_part`` launches it."""
    rng = np.random.default_rng(15)
    b, S, h, dh = 4, 1500, 12, 64
    q = rng.standard_normal((b, h, dh), np.float32)
    k, v = (rng.standard_normal((b, S, h, dh), np.float32) for _ in "kv")
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
               for a in (q, k, v))
    lens = torch.full((b,), S, dtype=torch.int32, device=cuda)
    before = decode_ops.decode_attention.launches
    out = decode_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_ops.decode_attention.launches == before + 1
    ref = decode_attention_ref(q, k, v, lens)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _card_arch(arch):
    """The fp32 smoke config at head_dim 64 (the kernels take 64 and 128);
    gemma2 with a window of 8, whisper with 40 frames."""
    from dataclasses import replace

    from repro_torch.configs import smoke_config
    from repro_torch.models.config import EncoderConfig, LayerSpec

    cfg = replace(smoke_config(arch), head_dim=64, dtype="float32")
    if arch == "gemma2-27b":
        cfg = replace(cfg, cycle=(LayerSpec(kind="attn", window=8),
                                  LayerSpec(kind="attn", window=0)))
    if cfg.encoder:
        cfg = replace(cfg, encoder=EncoderConfig(n_layers=2, n_frames=40))
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("gemma2-27b", "starcoder2-15b",
                                  "chameleon-34b", "whisper-small",
                                  "dbrx-132b", "granite-moe-3b-a800m",
                                  "jamba-v0.1-52b"))
def test_new_archs_on_card_never_take_a_plain_path(cuda, monkeypatch, arch):
    """Prefill of a 21-token prompt and 4 decode steps on the card with the
    plain attention versions made to raise, against the CPU on the same
    weights (2e-3): flash once per attention layer in prefill (whisper:
    encoder, self and cross), decode once per layer and step (whisper: self
    and cross); gemma2's 8-slot ring wraps.  The MoE archs run their MoE
    MLP at the shipped capacity factor (prefill drops tokens), jamba its
    SSM blocks through the SSD kernel."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.models.param import init_params, tree_map

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain path")

    def run(model, params, dev):
        """Logits of the prefill and of each decode step, on the host."""
        kw = {} if enc is None else {"enc_embeds": enc.to(dev)}
        logits, cache = model.prefill(params, toks[:, :s].to(dev),
                                      cache_len=32, **kw)
        out = [logits.cpu()]
        for t in range(s, s + steps):
            logits, cache = model.decode_step(
                params, cache, toks[:, t].to(dev),
                torch.full((b,), t, device=dev))
            out.append(logits.cpu())
        return out

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _card_arch(arch)
    cpu = Model(cfg, device="cpu")
    p_cpu = init_params(cpu.param_template(),
                        torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(16)
    b, s, steps = 2, 21, 4
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + steps)))
    enc = None if not cfg.encoder else torch.from_numpy(rng.standard_normal(
        (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32))
    want = run(cpu, p_cpu, "cpu")
    for mod, name in ((flash_ops, "attention_ref"),
                      (decode_ops, "decode_attention_ref"),
                      (L, "blocked_attention"), (L, "decode_attention")):
        monkeypatch.setattr(mod, name, refuse)
    f0, d0 = flash_ops.flash_attention.launches, \
        decode_ops.decode_attention.launches
    got = run(Model(cfg), tree_map(lambda t: t.to(cuda), p_cpu), cuda)
    n_attn = sum(spec.kind == "attn" for spec in cfg.layer_specs())
    if cfg.encoder:           # encoder, self and cross; self and cross
        n_flash, per_step = cfg.encoder.n_layers + 2 * n_attn, 2 * n_attn
    else:
        n_flash, per_step = n_attn, n_attn
    assert flash_ops.flash_attention.launches == f0 + n_flash
    assert decode_ops.decode_attention.launches == d0 + steps * per_step
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    assert max(errs) <= 2e-3, errs


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
    # jamba's widths: 8192 heads of head_dim 1, d_state 16, chunk 16
    (1, 256, 8192, 1, 1, 16, 16),
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
@pytest.mark.parametrize("window,softcap", ((0, 0.0), (100, 30.0)))
def test_decode_kernel_edge_lengths_at_dh80_on_card(cuda, dtype, window,
                                                    softcap):
    """stablelm's head dim 80 and heads per kv head (g 1): lengths 0, 1,
    one split - 1, one split, one split + 1 and S, with and without a
    window and softcap."""
    S, b, kv = 1000, 6, 4
    chunk, _ = decode_ops.split_plan(
        S, torch.cuda.get_device_properties(cuda).multi_processor_count,
        b * kv)
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, S]
    q, k, v, lens = _decode_lengths_case(cuda, dtype, S, lengths, window,
                                         h=4, kv=kv, dh=80)
    kw = dict(window=window, softcap=softcap)
    out = decode_ops.decode_attention(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    ref = decode_attention_ref(q, k, v, lens, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dh", (96, 32))
def test_kernels_refuse_other_head_dims_on_card(cuda, dh):
    """A head dim outside HEAD_DIMS (64, 80, 128) raises on the card,
    before any launch, in each attention wrapper: no plain fallback."""
    assert dh not in flash_ops.HEAD_DIMS and dh not in decode_ops.HEAD_DIMS
    q, k, v, do = _bwd_inputs(cuda, "bfloat16", 1, 16, 16, 4, 2, dh)
    lse = torch.zeros((1, 4, 16), device=cuda)
    lens = torch.full((1,), 16, dtype=torch.int32, device=cuda)
    before = (flash_ops.flash_attention.launches,
              flash_ops.flash_attention_bwd.launches,
              decode_ops.decode_attention.launches)
    with pytest.raises(ValueError, match=f"head_dim {dh}"):
        flash_ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match=f"head_dim {dh}"):
        flash_ops.flash_attention_bwd(q, k, v, q, do, lse)
    with pytest.raises(ValueError, match=f"head_dim {dh}"):
        decode_ops.decode_attention(q[:, 0].contiguous(), k, v, lens)
    assert (flash_ops.flash_attention.launches,
            flash_ops.flash_attention_bwd.launches,
            decode_ops.decode_attention.launches) == before


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


@pytest.mark.cuda
def test_from_lake_restores_full_width_yi9b_onto_the_card(cuda):
    """A 2-layer full-width bf16 yi-9b saved as a Hudi checkpoint in a
    MemoryFS, synced to Iceberg, restored through the Iceberg view by
    ``from_lake`` onto the card: equal weights, equal greedy tokens."""
    from dataclasses import replace

    from repro_torch.checkpoint import LSTCheckpointManager, leaf_paths
    from repro_torch.configs import get_config
    from repro_torch.lst import MemoryFS
    from repro_torch.models.model import Model
    from repro_torch.models.param import init_params
    from repro_torch.serve import Request, ServeEngine

    model = Model(replace(get_config("yi-9b"), n_layers=2))
    params = init_params(model.param_template(),
                         torch.Generator(device=cuda).manual_seed(0))
    fs = MemoryFS()
    LSTCheckpointManager(fs, "mem/ckpt", fmt="hudi",
                         sync_targets=("iceberg",)).save(0, {"params": params})
    engine = ServeEngine.from_lake(model, fs, "mem/ckpt", fmt="iceberg",
                                   cache_len=128)
    saved, restored = leaf_paths(params), leaf_paths(engine.params)
    assert [n for n, _ in restored] == [n for n, _ in saved]
    for (name, a), (_, b) in zip(saved, restored):
        assert b.device == a.device and b.dtype == a.dtype, name
        assert torch.equal(a, b), name
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, 63999, n).tolist(), 6) for n in (40, 17)]
    want = ServeEngine(model, params, cache_len=128).generate(reqs)
    assert engine.generate(reqs) == want


# ------------------------------------------------- flash attention backward
BWD_SHAPES = FLASH_SHAPES + [
    (1, 200, 200, 16, 1, 64, True, 0, 0.0),      # 16 query heads per kv head
    (2, 130, 130, 32, 2, 128, True, 0, 0.0),     # g 16 at dh 128, ragged
    (1, 256, 256, 8, 8, 64, True, 64, 30.0),     # g 1, window + softcap
    # the bf16 kernels' tiles (dK/dV: 128 keys a block, q tiles of 64; dQ:
    # 128 q rows a block, key tiles of 64)
    (1, 64, 127, 4, 2, 128, False, 0, 0.0),      # sk one key block - 1
    (1, 129, 129, 4, 2, 64, True, 0, 0.0),       # sk, sq one block + 1
    (1, 65, 129, 4, 1, 128, True, 0, 0.0),       # causal, sq < sk
    (1, 200, 200, 4, 2, 128, True, 70, 0.0),     # window across q tiles
    (2, 192, 192, 16, 2, 128, True, 0, 0.0),     # g 8 at dh 128, b 2
]


def _bwd_inputs(cuda, dtype, b, sq, sk, h, kv, dh, seed=21):
    rng = np.random.default_rng(seed)
    q, k, v = _qkv(rng, b, sq, sk, h, kv, dh)
    do = rng.standard_normal((b, sq, h, dh), np.float32)
    return [torch.from_numpy(a).to(cuda, getattr(torch, dtype))
            for a in (q, k, v, do)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,softcap",
                         BWD_SHAPES)
def test_flash_bwd_kernel_vs_plain_on_card(cuda, b, sq, sk, h, kv, dh,
                                           causal, window, softcap, dtype):
    q, k, v, do = _bwd_inputs(cuda, dtype, b, sq, sk, h, kv, dh)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash_ops.flash_attention_with_lse(q, k, v, **kw)
    before = flash_ops.flash_attention_bwd.launches
    grads = flash_ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention_bwd.launches == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(lse, attention_lse_ref(q, k, **kw), atol=tol,
                               rtol=tol)
    for g, r, t in zip(grads, attention_bwd_ref(q, k, v, do, **kw), (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_bwd_dkdv_at_g1_dh80_on_card(cuda, dtype):
    """stablelm's attention (MHA: g 1, head dim 80) at a training shape:
    each key block's dK / dV come from its one query head, over q tiles
    that end past sq (300: ragged) under a causal mask; dK and dV against
    the plain version's, and the same with the heads as one batch (a
    head's gradients depend on its own head only)."""
    b, s, h, dh = 2, 300, 16, 80
    q, k, v, do = _bwd_inputs(cuda, dtype, b, s, s, h, h, dh)
    kw = dict(causal=True, window=0, softcap=0.0)
    out, lse = flash_ops.flash_attention_with_lse(q, k, v, **kw)
    _, dk, dv = flash_ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    _, rk, rv = attention_bwd_ref(q, k, v, do, **kw)
    torch.testing.assert_close(dk.float(), rk.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(dv.float(), rv.float(), atol=tol, rtol=tol)

    def heads_as_batch(t):
        return t.transpose(1, 2).reshape(b * h, s, 1, dh).contiguous()

    qh, kh, vh, doh = (heads_as_batch(t) for t in (q, k, v, do))
    oh, lh = flash_ops.flash_attention_with_lse(qh, kh, vh, **kw)
    _, dkh, dvh = flash_ops.flash_attention_bwd(qh, kh, vh, oh, doh, lh, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dkh, heads_as_batch(dk))
    assert torch.equal(dvh, heads_as_batch(dv))


@pytest.mark.cuda
def test_flash_bwd_kernels_one_at_a_time_equal_the_op_on_card(cuda):
    """``launch_bwd_bf16`` with one kernel at a time (delta, dK/dV, dQ) on
    one set of buffers gives the op's gradients bit for bit, and counts no
    launch."""
    q, k, v, do = _bwd_inputs(cuda, "bfloat16", 2, 200, 200, 8, 2, 128)
    kw = dict(causal=True, window=0, softcap=0.0)
    out, lse = flash_ops.flash_attention_with_lse(q, k, v, **kw)
    want = flash_ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    before = flash_ops.flash_attention_bwd.launches
    buffers = flash_ops.bwd_buffers(q, k)
    for bit in flash_ops.BWD_STAGES.values():
        flash_ops.launch_bwd_bf16(q, k, v, out, do, lse, buffers, stages=bit,
                                  **kw)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention_bwd.launches == before
    for g, w in zip(buffers[:3], want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_rows_that_see_no_key_give_zero_gradients(cuda, dtype):
    """sq 200 over sk 64 with a window of 32: rows from 95 on see no key.
    Their output is 0, their lse +inf, and their gradients 0, not NaN; the
    other gradients equal the plain ones with those rows' dO set to 0 (the
    plain softmax spreads an empty row over every key)."""
    b, sq, sk, h, kv, dh, window = 1, 200, 64, 4, 2, 64, 32
    q, k, v, do = _bwd_inputs(cuda, dtype, b, sq, sk, h, kv, dh)
    kw = dict(causal=True, window=window, softcap=0.0)
    out, lse = flash_ops.flash_attention_with_lse(q, k, v, **kw)
    dq, dk, dv = flash_ops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    empty = torch.arange(sq, device=cuda) >= sk + window - 1
    assert torch.equal(out[:, empty], torch.zeros_like(out[:, empty]))
    assert torch.isinf(lse[..., empty]).all() and (lse[..., empty] > 0).all()
    assert torch.isfinite(lse[..., ~empty]).all()
    for g in (dq, dk, dv):
        assert torch.isfinite(g.float()).all()
    assert torch.equal(dq[:, empty], torch.zeros_like(dq[:, empty]))
    do0 = do.clone()
    do0[:, empty] = 0
    grads0 = flash_ops.flash_attention_bwd(q, k, v, out, do0, lse, **kw)
    for g, g0 in zip((dq, dk, dv), grads0):
        assert torch.equal(g, g0)          # dO of empty rows is never read
    tol = TOL[dtype]
    for g, r in zip((dq, dk, dv), attention_bwd_ref(q, k, v, do0, **kw)):
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_attention_fn_through_autograd_on_card(cuda):
    """``flash_attention`` on inputs that require grad goes through
    ``FlashAttentionFn``: one forward (with the lse) and one backward launch,
    and autograd's gradients are the backward kernel's."""
    q, k, v, do = _bwd_inputs(cuda, "bfloat16", 2, 256, 256, 8, 2, 128)
    kw = dict(causal=True, window=0, softcap=0.0)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = flash_ops.flash_attention.launches, \
        flash_ops.flash_attention_bwd.launches
    out = flash_ops.flash_attention(*leaves, **kw)
    assert out.grad_fn is not None
    out.backward(do)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == f0 + 1
    assert flash_ops.flash_attention_bwd.launches == b0 + 1
    o, lse = flash_ops.flash_attention_with_lse(q, k, v, **kw)
    for leaf, g in zip(leaves, flash_ops.flash_attention_bwd(q, k, v, o, do,
                                                             lse, **kw)):
        assert torch.equal(leaf.grad, g)
    with torch.no_grad():
        assert flash_ops.flash_attention(*leaves, **kw).grad_fn is None


@pytest.mark.cuda
def test_decode_kernel_refuses_grad_on_card(cuda):
    q = torch.randn(2, 4, 64, device=cuda, requires_grad=True)
    k = torch.randn(2, 32, 2, 64, device=cuda)
    lengths = torch.full((2,), 16, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_ops.decode_attention(q, k, k, lengths)
    with torch.no_grad():
        decode_ops.decode_attention(q, k, k, lengths)


# (b, s, h, p, g, n, chunk): mamba2-2.7b's train shape, g > 1, jamba's
# widths, the Pallas sweep, a chunk not a multiple of the 64-row tile
SSD_BWD_SHAPES = [
    (4, 2048, 80, 64, 1, 128, 256),
    (2, 512, 6, 64, 3, 64, 128),
    (1, 128, 4, 1, 1, 16, 16),
    (2, 128, 4, 16, 1, 32, 32),
    (1, 256, 8, 32, 2, 16, 64),
    (2, 192, 6, 8, 3, 8, 64),
    (1, 300, 4, 64, 1, 128, 100),
]
BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")
# ddt and dA besides within this much of their largest entry: the chunked
# decay gradient sums each row's fp32 rounding of C . dC - x' . dx' into
# every earlier row of the chunk, then over the rows
# (tests/test_torch_ssd_bwd.py)
SSD_BWD_SCALE_TOL = 2e-5


def _ssd_bwd_close(got, want, tol) -> None:
    """dx, dB, dC, dinit within ``tol`` (abs + rel); ddt and dA within it
    plus SSD_BWD_SCALE_TOL of their largest entry."""
    for name, g, w in zip(BWD_NAMES, got, want):
        scale = SSD_BWD_SCALE_TOL * float(w.abs().max()) \
            if name in ("ddt", "dA") else 0.0
        assert torch.isfinite(g.float()).all(), name
        torch.testing.assert_close(g.float(), w, atol=tol + scale, rtol=tol,
                                   msg=lambda m, name=name: f"{name}: {m}")


def _ssd_bwd_inputs(cuda, shape, dtype, seed=18, with_state=False):
    b, s, h, p, g, n, _ = shape
    x, dt, A, B, C = _ssd_inputs(cuda, b, s, h, p, g, n, dtype, seed=seed)
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.standard_normal((b, s, h, p), np.float32)).to(
        cuda, x.dtype)
    init = dstate = None
    if with_state:
        init, dstate = (torch.from_numpy(rng.standard_normal(
            (b, h, n, p), np.float32)).to(cuda) for _ in "ab")
    return x, dt, A, B, C, init, dy, dstate


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", (False, True))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SSD_BWD_SHAPES)
def test_ssd_bwd_kernel_vs_plain_on_card(cuda, shape, dtype, with_state):
    """The backward op (four kernels) against ``ssd_bwd_ref`` on the same
    inputs, with and without an initial state and a final-state gradient,
    at the SSD tolerance (fp32 5e-4, bf16 2e-2)."""
    x, dt, A, B, C, init, dy, dstate = _ssd_bwd_inputs(cuda, shape, dtype,
                                                       with_state=with_state)
    before = ssd_ops.ssd_chunk_scan_bwd.launches
    got = ssd_ops.ssd_chunk_scan_bwd(x, dt, A, B, C, dy, chunk=shape[6],
                                     init=init, dstate=dstate)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_chunk_scan_bwd.launches == before + 1
    assert [t.dtype for t in got] == [x.dtype, torch.float32, torch.float32,
                                      B.dtype, C.dtype, torch.float32]
    want = ssd_bwd_ref(x, dt, A, B, C, init, dy, dstate, chunk=shape[6])
    _ssd_bwd_close(got, want, SSD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 128, 4, 16, 1, 32, 32),
                                   (1, 300, 6, 64, 3, 64, 100),
                                   (1, 128, 4, 1, 1, 16, 16)])
def test_ssd_bwd_stages_vs_plain_stages_on_card(cuda, shape, dtype):
    """Each kernel's scratch against its plain stage: the states entering
    and the gradients leaving each chunk, <S_out, dS> and dinit (fp32: the
    states kernel; bf16: the chunk states and the state pass, the states
    packed hi / lo, in groups of 8 at jamba's widths); dx and x . dx'
    (keys); each row's d cum (queries)."""
    from repro_torch.kernels.ssd import ref as R

    x, dt, A, B, C, init, dy, dstate = _ssd_bwd_inputs(cuda, shape, dtype,
                                                       with_state=True)
    h, p, n, q = shape[2], shape[3], shape[5], shape[6]
    buffers = ssd_ops.bwd_buffers(x, B, q)
    st = R.bwd_chunk_states(x, dt, A, B, C, dy, q)
    prev, grads, dinit, delta = R.bwd_state_pass(*st, init, dstate)
    dx, _, _, direct, dcum = R.bwd_chunk_grads(x, dt, A, B, C, dy, q, prev,
                                               grads)
    tol = SSD_TOL[dtype]
    stages = ssd_ops.BWD_STAGES[x.dtype]

    def run(*names):
        ssd_ops.launch_bwd(x, dt, A, B, C, dy, q, init, dstate, buffers,
                           sum(stages[name] for name in names))
        torch.cuda.synchronize()

    run(*(("chunk", "pass") if x.dtype == torch.bfloat16 else ("states",)))
    got_prev, got_grads = buffers.prev, buffers.grads
    if x.dtype == torch.bfloat16:
        got_prev, got_grads = (ssd_ops.unpack_states(t, h, n, p)
                               for t in (got_prev, got_grads))
    for got, want in ((got_prev, prev), (got_grads, grads),
                      (buffers.delta, delta), (buffers.dinit, dinit)):
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    run("keys")
    torch.testing.assert_close(buffers.dx.float(), dx, atol=tol, rtol=tol)
    torch.testing.assert_close(buffers.ddt, direct, atol=tol, rtol=tol)
    run("queries")
    torch.testing.assert_close(ssd_ops.bwd_row_dcum(buffers, q), dcum,
                               atol=tol, rtol=tol)


@pytest.mark.cuda
def test_ssd_bwd_is_deterministic_on_card(cuda):
    """No float atomics: two calls give the same bits."""
    shape = (2, 512, 40, 64, 1, 128, 256)
    x, dt, A, B, C, _, dy, _ = _ssd_bwd_inputs(cuda, shape, "bfloat16")
    first = ssd_ops.ssd_chunk_scan_bwd(x, dt, A, B, C, dy, chunk=256)
    second = ssd_ops.ssd_chunk_scan_bwd(x, dt, A, B, C, dy, chunk=256)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("s", (512, 300))
def test_ssd_scan_gradients_on_card_go_through_the_kernels(cuda, monkeypatch,
                                                           s):
    """``ssd_scan`` on strided slices of one conv output, with a gradient:
    one forward and one backward launch (the plain versions are made to
    raise), and the gradients of the conv output, dt and A equal the
    backward op's on the same (padded) inputs."""
    from repro_torch.kernels.ssd import ref as R
    from repro_torch.models import ssm as S

    def refuse(*a, **k):
        raise AssertionError("a plain path ran on the card")

    for mod, name in ((R, "ssd_ref"), (R, "ssd_bwd_ref"),
                      (S, "_ssd_chunked")):
        monkeypatch.setattr(mod, name, refuse)
    b, h, p, g, n, q = 2, 8, 64, 1, 128, 256
    rng = np.random.default_rng(19)
    conv = torch.from_numpy(rng.standard_normal(
        (b, s, h * p + 2 * g * n), np.float32)).to(cuda, torch.bfloat16)
    conv.requires_grad_(True)
    dt = torch.rand((b, s, h), device=cuda, requires_grad=True)
    A = (-torch.rand((h,), device=cuda) - 0.5).requires_grad_(True)
    x = conv[..., :h * p].view(b, s, h, p)
    B = conv[..., h * p:h * p + g * n].view(b, s, g, n)
    C = conv[..., h * p + g * n:].view(b, s, g, n)
    f0 = ssd_ops.ssd_chunk_scan.launches
    b0 = ssd_ops.ssd_chunk_scan_bwd.launches
    y, state = S.ssd_scan(x, dt, A, B, C, q)
    dy = torch.randn_like(y)
    grads = torch.autograd.grad((y.float() * dy.float()).sum(),
                                (conv, dt, A))
    torch.cuda.synchronize()
    assert ssd_ops.ssd_chunk_scan.launches == f0 + 1
    assert ssd_ops.ssd_chunk_scan_bwd.launches == b0 + 1
    pad = (-s) % q

    def grow(t):
        return torch.cat([t, t.new_zeros((b, pad, *t.shape[2:]))], 1)

    with torch.no_grad():
        want = ssd_ops.ssd_chunk_scan_bwd(
            grow(x).contiguous(), grow(dt), A, grow(B).contiguous(),
            grow(C).contiguous(), grow(dy).contiguous(), chunk=q)
    assert torch.equal(grads[0][..., :h * p],
                       want[0][:, :s].reshape(b, s, h * p))
    assert torch.equal(grads[0][..., h * p:h * p + g * n],
                       want[3][:, :s].reshape(b, s, g * n))
    assert torch.equal(grads[0][..., h * p + g * n:],
                       want[4][:, :s].reshape(b, s, g * n))
    assert torch.equal(grads[1], want[1][:, :s])
    assert torch.equal(grads[2], want[2])
    assert torch.count_nonzero(want[0][:, s:]) == 0


def _narrow_yi(dtype="bfloat16", layers=2, remat="none"):
    """yi-9b's smoke config at head_dim 64 (the kernels' smallest)."""
    from dataclasses import replace

    from repro_torch.configs import smoke_config
    return replace(smoke_config("yi-9b"), head_dim=64, n_layers=layers,
                   dtype=dtype, remat=remat)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ("none", "block"))
def test_train_step_on_card_never_takes_a_plain_path(cuda, monkeypatch, remat):
    """A train step on the card with the plain attention versions made to
    raise: the gradient of attention comes only from the backward kernel,
    launched once a layer (the forward once a layer, twice with remat)."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.models.param import init_params, tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain path")

    monkeypatch.setattr(flash_ops, "attention_ref", refuse)
    monkeypatch.setattr(flash_ops, "attention_bwd_ref", refuse)
    monkeypatch.setattr(L, "blocked_attention", refuse)
    cfg = _narrow_yi(remat=remat)
    model = Model(cfg)
    params = init_params(model.param_template(),
                         torch.Generator(device=cuda).manual_seed(0))
    before = [p.clone() for p in tree_leaves(params)]
    rng = np.random.default_rng(22)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 96)))
             .to(cuda) for k in ("inputs", "targets")}
    f0, b0 = flash_ops.flash_attention.launches, \
        flash_ops.flash_attention_bwd.launches
    step = make_train_step(model, AdamWConfig(warmup_steps=0), ce_chunk=32)
    params, opt, met = step(params, adamw_init(params), batch)
    torch.cuda.synchronize()
    per_layer = 2 if remat == "block" else 1
    assert flash_ops.flash_attention.launches == f0 + per_layer * 2
    assert flash_ops.flash_attention_bwd.launches == b0 + 2
    assert np.isfinite(float(met["loss"])) and float(met["grad_norm"]) > 0
    moved = [not torch.equal(a, b) for a, b in zip(before,
                                                   tree_leaves(params))]
    assert all(moved)                     # every leaf got a gradient


@pytest.mark.cuda
def test_mamba2_train_step_card_vs_cpu(cuda):
    """mamba2's smoke config at 2 layers, fp32, b 2 x s 40 (the pad path:
    chunk 16): the loss and every gradient of the train loss on the card
    (the SSD forward kernel twice a layer with remat, its backward once)
    against the plain CPU path (torch autograd through the chunked scan).
    The loss within 2e-3; each gradient within 2e-3 of its largest CPU
    entry, as chip_smoke phase 4."""
    from dataclasses import replace

    from repro_torch.checkpoint import leaf_paths
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import Model
    from repro_torch.models.param import init_params, tree_leaves, tree_map
    from repro_torch.train import make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(smoke_config("mamba2-2.7b"), dtype="float32", remat="block")
    p_cpu = init_params(Model(cfg, device="cpu").param_template(),
                        torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(24).integers(
        0, cfg.vocab_size, (2, 41)))
    out = []
    f0 = ssd_ops.ssd_chunk_scan.launches
    b0 = ssd_ops.ssd_chunk_scan_bwd.launches
    for model in (Model(cfg), Model(cfg, device="cpu")):
        dev = model.device
        live = tree_map(lambda t: t.to(dev).requires_grad_(True), p_cpu)
        loss, _ = make_loss_fn(model, ce_chunk=16)(
            live, {"inputs": toks[:, :-1].to(dev),
                   "targets": toks[:, 1:].to(dev)})
        grads = torch.autograd.grad(loss, tree_leaves(live))
        out.append((float(loss.detach()), [g.cpu() for g in grads]))
    assert ssd_ops.ssd_chunk_scan.launches == f0 + 2 * cfg.n_layers
    assert ssd_ops.ssd_chunk_scan_bwd.launches == b0 + cfg.n_layers
    assert abs(out[0][0] - out[1][0]) <= 2e-3
    names = [n for n, _ in leaf_paths(p_cpu)]
    for name, card, cpu in zip(names, out[0][1], out[1][1]):
        err = float((card - cpu).abs().max())
        assert err <= 2e-3 * min(1.0, float(cpu.abs().max())), (name, err)


@pytest.mark.cuda
def test_decode_over_a_split_ring_raises_on_card(cuda):
    """ROADMAP C-m: ``Model._decode_attention`` refuses, on the card, a
    cache whose sequence is split over more than one rank (the decode
    kernel returns no softmax statistics to merge).  A fake process group
    of two ranks (this process rank 0, as the dry run's) lets one card
    hold such a DTensor; the refusal comes before any collective."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import smoke_config
    from repro_torch.models.model import Model

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("seq",))
        model = Model(smoke_config("yi-9b"))
        kv, dh = model.cfg.n_kv_heads, model.cfg.head_dim
        q = torch.randn(2, 1, model.cfg.n_heads, dh, device=cuda)
        local = torch.randn(2, 16, kv, dh, device=cuda)
        kc = DTensor.from_local(local, mesh, [Shard(1)], run_check=False)
        lengths = torch.full((2,), 20, dtype=torch.int32, device=cuda)
        kpos = torch.arange(32, device=cuda)
        pos = torch.full((2,), 19, device=cuda)
        with pytest.raises(NotImplementedError, match="split over ranks"):
            model._decode_attention(q, kc, kc, kpos, pos, lengths)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_full_width_train_step_card_vs_cpu(cuda):
    """yi-9b at full width, 2 layers, fp32, b 1 x s 64, block weights at
    std 1/sqrt(fan-in) (the init's 1/sqrt(layers) saturates attention,
    ROADMAP C-k): the loss and every gradient of the train loss on the card
    (flash forward and backward, per-cycle remat) against the plain CPU
    path.  The loss within 2e-3; each gradient within 2e-3 and within 2e-3
    of its largest entry, as chip_smoke phase 4."""
    from dataclasses import replace

    from repro_torch.checkpoint import leaf_paths
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.param import init_params, tree_leaves, tree_map
    from repro_torch.train import make_loss_fn

    def fan_in_scale(spec):
        if spec.axes[:1] != ("layers",) or spec.init != "normal":
            return spec
        fan_in = (int(np.prod(spec.shape[1:-1])) if spec.axes[-1] == "embed"
                  else spec.shape[1])
        return replace(spec, scale=fan_in ** -0.5)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(get_config("yi-9b"), n_layers=2, dtype="float32")
    p_cpu = init_params(tree_map(fan_in_scale,
                                 Model(cfg, device="cpu").param_template()),
                        torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab_size, (1, 65)))
    out = []
    for model in (Model(cfg), Model(cfg, device="cpu")):
        dev = model.device
        live = tree_map(lambda t: t.to(dev).requires_grad_(True), p_cpu)
        loss, _ = make_loss_fn(model, ce_chunk=64)(
            live, {"inputs": toks[:, :-1].to(dev),
                   "targets": toks[:, 1:].to(dev)})
        grads = torch.autograd.grad(loss, tree_leaves(live))
        out.append((float(loss.detach()), [g.cpu() for g in grads]))
    assert abs(out[0][0] - out[1][0]) <= 2e-3
    names = [n for n, _ in leaf_paths(p_cpu)]
    for name, card, cpu in zip(names, out[0][1], out[1][1]):
        err = float((card - cpu).abs().max())
        assert err <= 2e-3 * min(1.0, float(cpu.abs().max())), (name, err)


def _moe_cfg(capacity_factor):
    """granite's MoE MLP (40 experts, top 8) at width 256, d_ff 128, fp32."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    return replace(get_config("granite-moe-3b-a800m"), d_model=256, d_ff=128,
                   dtype="float32", capacity_factor=capacity_factor)


@pytest.mark.cuda
@pytest.mark.parametrize("cf,s", [(1.25, 512), (0.25, 512), (1.25, 1)])
def test_moe_mlp_on_card_routes_as_the_cpu(cuda, cf, s):
    """One MoE layer on the card against the CPU on the same fp32 weights
    and inputs (4 groups): the chosen experts in order may differ only at a
    near-tie (a gap below 1e-5 between adjacent CPU probabilities of the
    first k + 1); in every group without one, the dispatch slots (so the
    dropped (token, choice) pairs) are equal and the output is within 1e-4
    of its scale; the aux loss within 1e-5 relative."""
    from repro_torch.models import layers as L
    from repro_torch.models.param import init_params, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_cfg(cf)
    p_cpu = init_params(L.moe_template(cfg), torch.Generator().manual_seed(0),
                        device="cpu")
    x = torch.from_numpy(np.random.default_rng(30).standard_normal(
        (4, s, cfg.d_model)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), p_cpu)
        y, aux = L.moe_mlp(x.to(dev), p, cfg)
        _, probs, _, top_e = L.route(x.to(dev), p["router"], cfg.top_k)
        tok, inv = L._dispatch_one(top_e.reshape(4, -1), cfg.n_experts,
                                   L.capacity(cfg, s))
        out[str(dev)] = [t.cpu() for t in (y, aux, probs, top_e, tok, inv)]
    y0, a0, p0, e0, t0, i0 = out["cpu"]
    y1, a1, _, e1, t1, i1 = out["cuda"]
    differ = (e0 != e1).any(-1)                                   # (G, S)
    top = p0.sort(-1, descending=True).values[..., :cfg.top_k + 1]
    gap = (top[..., :-1] - top[..., 1:]).min(-1).values
    assert bool((gap[differ] < 1e-5).all()), gap[differ]
    same = ~differ.any(-1)
    assert bool(same.any())
    assert torch.equal(t0[same], t1[same]) and torch.equal(i0[same], i1[same])
    if cf == 0.25:
        assert bool((i0 == cfg.n_experts * L.capacity(cfg, s)).any())
    assert float((y1 - y0)[same].abs().max()) <= \
        1e-4 * max(1.0, float(y0.abs().max()))
    torch.testing.assert_close(a1, a0, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_route_on_card_breaks_ties_as_the_cpu(cuda):
    """Exact ties in the router's probabilities (the router is the
    identity, so the logits are x, tied by construction): the card orders
    the choices as the CPU does, descending, ties to the lower expert."""
    from repro_torch.models import layers as L

    rng = np.random.default_rng(31)
    x = rng.integers(0, 4, (2, 300, 40)).astype(np.float32) / 4.0
    eye = torch.eye(40)
    want = L.route(torch.from_numpy(x), eye, 8)
    got = L.route(torch.from_numpy(x).to(cuda), eye.to(cuda), 8)
    assert torch.equal(got[3].cpu(), want[3])
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_granite_decode_step_replays_as_cuda_graph(cuda):
    """A decode step at granite's full width (2 layers, bf16: flash and
    decode kernels at g 3 / dh 64, the MoE MLP with 40 experts, top 8)
    captured as a CUDA graph and replayed: its logits and cache equal the
    eager step's on a copy of the same cache, bit for bit, and the graph
    replays with new tokens."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.param import init_params, tree_leaves, tree_map

    cfg = replace(get_config("granite-moe-3b-a800m"), n_layers=2)
    model = Model(cfg)
    params = init_params(model.param_template(),
                         torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(32)
    b, s = 4, 200
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 2))) \
        .to(cuda)
    _, cache = model.prefill(params, toks[:, :s], cache_len=256)
    eager_cache = tree_map(lambda t: t.clone(), cache)
    warm_cache = tree_map(lambda t: t.clone(), cache)
    tok, pos = toks[:, s].clone(), torch.full((b,), s, device=cuda)
    want, _ = model.decode_step(params, eager_cache, tok, pos)
    model.decode_step(params, warm_cache, tok, pos)       # warm-up, outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, _ = model.decode_step(params, cache, tok, pos)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for a, e in zip(tree_leaves(cache), tree_leaves(eager_cache)):
        assert torch.equal(a, e)
    # the next position with a new token, eager on the eager cache
    tok.copy_(toks[:, s + 1])
    pos.fill_(s + 1)
    want2, _ = model.decode_step(params, eager_cache, tok, pos)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want2)
