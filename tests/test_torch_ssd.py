"""The port's SSD chunk scan against the Pallas kernel and its oracle.

On the CPU the wrapper takes its plain version (``ssd_ref``); it is held
against the Pallas kernel in interpret mode at the sweep shapes of
``tests/test_kernels.py`` (fp32 5e-4, as there; bf16 x/B/C with fp32 dt
2e-2, since y is rounded to bf16), and the chunked plain path of
``models/ssm.py`` against the sequential oracle at 5e-4.  The CUDA kernel
itself is held against ``ssd_ref`` in ``tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd.kernel import ssd_chunk_scan as pallas_ssd  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_ref  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 5e-4, "bfloat16": 2e-2}
# (b, s, h, p, g, n, chunk), as tests/test_kernels.py::test_ssd_sweep
SSD_SWEEP = [
    (2, 128, 4, 16, 1, 32, 32),
    (1, 256, 8, 32, 2, 16, 64),
    (1, 128, 4, 1, 1, 16, 16),    # head_dim=1 (jamba / mamba-1 mode)
    (2, 192, 6, 8, 3, 8, 64),     # uneven groups
]


def _inputs(b, s, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SWEEP)
def test_wrapper_matches_pallas_kernel(b, s, h, p, g, n, chunk, dtype):
    x, dt, A, B, C = _inputs(b, s, h, p, g, n)
    jx, jB, jC = (jnp.asarray(a).astype(dtype) for a in (x, B, C))
    jy, jstate = pallas_ssd(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                            chunk=chunk, interpret=True)
    tx, tB, tC = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (x, B, C))
    ty, tstate = ssd_ops.ssd_chunk_scan(tx, torch.from_numpy(dt),
                                        torch.from_numpy(A), tB, tC,
                                        chunk=chunk)
    assert ty.dtype == tx.dtype and tstate.dtype == torch.float32
    assert ty.shape == (b, s, h, p) and tstate.shape == (b, h, n, p)
    _close(ty, jy, TOL[dtype])
    _close(tstate, jstate, TOL[dtype])


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SWEEP)
def test_ref_matches_reference_oracle(b, s, h, p, g, n, chunk):
    arrays = _inputs(b, s, h, p, g, n, seed=1)
    jy, jstate = jax_ssd_ref(*map(jnp.asarray, arrays))
    ty, tstate = ssd_ref(*map(torch.from_numpy, arrays))
    _close(ty, jy, 1e-5)
    _close(tstate, jstate, 1e-5)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 40, 4, 8, 1, 16, 16),     # 40 = 2.5 chunks: the pad path
    (1, 50, 6, 4, 3, 8, 16),      # uneven groups (reference fault C-f)
    (1, 7, 2, 1, 1, 4, 16),       # shorter than one chunk
])
def test_chunked_plain_path_matches_sequential_oracle(b, s, h, p, g, n,
                                                      chunk):
    x, dt, A, B, C = map(torch.from_numpy, _inputs(b, s, h, p, g, n, seed=2))
    y, state = S.ssd_scan(x, dt, A, B, C, chunk)
    yr, sr = ssd_ref(x, dt, A, B, C)
    assert y.shape == (b, s, h, p)
    torch.testing.assert_close(y, yr, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(state, sr, atol=5e-4, rtol=5e-4)


def test_wrapper_raises_on_a_ragged_sequence():
    x, dt, A, B, C = map(torch.from_numpy, _inputs(1, 40, 2, 4, 1, 8))
    with pytest.raises(ValueError, match="not a multiple of the chunk 16"):
        ssd_ops.ssd_chunk_scan(x, dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="do not pair"):
        ssd_ops.ssd_chunk_scan(x, dt[:, :, :1], A, B, C, chunk=8)


def test_kernel_tiling_admits_the_sweep_and_serving_shapes():
    """The tile plan fits shared memory for every sweep shape and for
    mamba2-2.7b's serving shape (Q 256, n 128, p 64: 64-row tiles)."""
    for _, s, _, p, _, n, chunk in SSD_SWEEP:
        q = min(chunk, s)
        tile = ssd_ops.plan(q, n, p)
        assert ssd_ops.smem_bytes(tile, q, n, p) <= ssd_ops.SMEM_LIMIT
        assert tile <= max(16, 2 * q)
    assert ssd_ops.plan(256, 128, 64) == 64
    assert ssd_ops.plan(4096, 128, 64) == 32
    with pytest.raises(ValueError, match="shared memory"):
        ssd_ops.plan(256, 1024, 256)
