"""Port layers against ``repro.models.layers`` on the same inputs.

fp32 agrees to 1e-5.  bf16 agrees to 2e-2: both sides round to bf16 after
each op, but not always at the same points (XLA fuses, PyTorch runs op by
op), so the last bf16 bit can differ.
"""

from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ("float32", "bfloat16")


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return j, t


def _close(j, t, dtype):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=(2, 5, 64)).astype(np.float32), dtype)
    w = rng.normal(size=(64,)).astype(np.float32) * 0.1
    _close(JL.rms_norm(xj, jnp.asarray(w)), TL.rms_norm(xt, torch.from_numpy(w)),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(2, 7, 4, 16)).astype(np.float32), dtype)
    pos = np.arange(3, 10)[None, :]
    _close(JL.rope(xj, jnp.asarray(pos), 10_000.0),
           TL.rope(xt, torch.from_numpy(pos), 10_000.0), dtype)


def test_softcap():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 9)) * 40).astype(np.float32)
    _close(JL.softcap(jnp.asarray(x), 30.0),
           TL.softcap(torch.from_numpy(x), 30.0), "float32")
    xt = torch.from_numpy(x)
    assert TL.softcap(xt, 0.0) is xt          # cap 0 means no cap


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_mlp(dtype):
    rng = np.random.default_rng(3)
    cfg_t = replace(smoke_config("yi-9b"), dtype=dtype)
    cfg_j = replace(jax_smoke_config("yi-9b"), dtype=dtype)
    d, f = cfg_t.d_model, cfg_t.d_ff
    xj, xt = _pair(rng.normal(size=(2, 5, d)).astype(np.float32), dtype)
    pj, pt = {}, {}
    for name, shape in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d))):
        pj[name], pt[name] = _pair(
            (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32),
            dtype)
    _close(JL.mlp(xj, pj, cfg_j), TL.mlp(xt, pt, cfg_t), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window,cap,q_blocks", [
    (True, 0, 0.0, 4),
    (True, 8, 30.0, 4),
    (False, 0, 0.0, 3),
])
def test_blocked_attention(dtype, causal, window, cap, q_blocks):
    rng = np.random.default_rng(4)
    qj, qt = _pair(rng.normal(size=(2, 24, 4, 16)).astype(np.float32), dtype)
    kj, kt = _pair(rng.normal(size=(2, 24, 2, 16)).astype(np.float32), dtype)
    vj, vt = _pair(rng.normal(size=(2, 24, 2, 16)).astype(np.float32), dtype)
    kw = dict(causal=causal, window=window, cap=cap, q_blocks=q_blocks)
    _close(JL.blocked_attention(qj, kj, vj, **kw),
           TL.blocked_attention(qt, kt, vt, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 6])
def test_ring_masked_decode_attention(dtype, window):
    rng = np.random.default_rng(5)
    b, S = 3, 10
    qj, qt = _pair(rng.normal(size=(b, 1, 4, 16)).astype(np.float32), dtype)
    kj, kt = _pair(rng.normal(size=(b, S, 2, 16)).astype(np.float32), dtype)
    vj, vt = _pair(rng.normal(size=(b, S, 2, 16)).astype(np.float32), dtype)
    # ring buffers: a half-filled one, a just-full one, one that wrapped
    pos = np.array([4, 9, 13])
    kpos = np.full((b, S), -1, np.int32)
    for i, p in enumerate(pos):
        for t in range(max(0, p - S + 1), p + 1):
            kpos[i, t % S] = t
    _close(JL.decode_attention(qj, kj, vj, jnp.asarray(kpos), jnp.asarray(pos),
                               window=window),
           TL.decode_attention(qt, kt, vt, torch.from_numpy(kpos),
                               torch.from_numpy(pos), window=window), dtype)
