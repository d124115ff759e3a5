"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; the file
imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Shapes are the Pallas sweep of ``tests/test_kernels.py`` plus ragged
lengths and empty sequences; tolerances fp32 3e-5, bf16 2e-2.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

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
]
DECODE_SHAPES = [
    (2, 512, 4, 2, 64, 0),
    (2, 512, 4, 4, 128, 128),     # MHA + sliding window
    (1, 300, 8, 2, 64, 0),        # ragged cache length
    (3, 256, 16, 2, 128, 64),
    (2, 300, 24, 2, 128, 0),      # 12 query heads per kv head
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
