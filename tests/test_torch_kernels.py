"""Port kernel wrappers against the Pallas kernels and their oracles.

On the CPU the wrappers take their plain PyTorch versions; these are held
against the Pallas kernels run in interpret mode, at the sweep shapes of
``tests/test_kernels.py`` (fp32 3e-5, bf16 2e-2, as there), and against the
reference oracles on ragged shapes the Pallas flash kernel cannot take.
The CUDA kernels themselves are held against the plain versions in
``tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.kernel import \
    decode_attention as pallas_decode  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_attention.kernel import \
    flash_attention as pallas_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402

torch.set_num_threads(2)

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
DTYPES = ("float32", "bfloat16")

FLASH_SWEEP = [
    (2, 256, 256, 4, 2, 64, True, 0, 0.0),       # GQA causal
    (1, 256, 256, 4, 4, 128, True, 128, 50.0),   # window + softcap
    (2, 128, 384, 8, 2, 64, False, 0, 0.0),      # cross/bidir
    (1, 384, 384, 2, 1, 128, True, 0, 0.0),      # MQA, non-pow2 blocks
]
FLASH_RAGGED = [
    (1, 200, 200, 4, 2, 64, True, 0, 0.0),
    (1, 300, 300, 4, 1, 128, True, 0, 0.0),
    (1, 128, 300, 4, 2, 64, False, 0, 0.0),
    (1, 300, 300, 2, 2, 64, True, 100, 20.0),
]
DECODE_SWEEP = [
    (2, 512, 4, 2, 64, 0),
    (2, 512, 4, 4, 128, 128),     # MHA + sliding window
    (1, 300, 8, 2, 64, 0),        # ragged cache length
    (3, 256, 16, 2, 128, 64),
]


def _pair(a, dtype):
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return j, t


def _close(j, t, tol):
    np.testing.assert_allclose(t.float().cpu().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def _qkv(rng, b, sq, sk, h, kv, dh):
    return (rng.standard_normal((b, sq, h, dh), np.float32),
            rng.standard_normal((b, sk, kv, dh), np.float32),
            rng.standard_normal((b, sk, kv, dh), np.float32))


def _decode_inputs(rng, b, S, h, kv, dh, window):
    return (rng.standard_normal((b, h, dh), np.float32),
            rng.standard_normal((b, S, kv, dh), np.float32),
            rng.standard_normal((b, S, kv, dh), np.float32),
            rng.integers(max(window, 8), S, (b,)).astype(np.int32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,softcap", FLASH_SWEEP)
def test_flash_attention_vs_pallas(b, sq, sk, h, kv, dh, causal, window,
                                   softcap, dtype):
    q, k, v = _qkv(np.random.default_rng(7), b, sq, sk, h, kv, dh)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = pallas_flash(qj, kj, vj, bq=128, bk=128, interpret=True, **kw)
    _close(out, flash_ops.flash_attention(qt, kt, vt, **kw), TOL[dtype])


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,softcap",
                         FLASH_RAGGED)
def test_flash_attention_ragged_vs_oracle(b, sq, sk, h, kv, dh, causal,
                                          window, softcap):
    """Ragged sq/sk: the port follows the oracle (the Pallas kernel gives
    NaN here, ROADMAP C-a)."""
    q, k, v = _qkv(np.random.default_rng(8), b, sq, sk, h, kv, dh)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "float32") for a in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = flash_ops.flash_attention(qt, kt, vt, **kw)
    assert torch.isfinite(out).all()
    _close(jax_attention_ref(qj, kj, vj, **kw), out, TOL["float32"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,S,h,kv,dh,window", DECODE_SWEEP)
def test_decode_attention_vs_pallas(b, S, h, kv, dh, window, dtype):
    q, k, v, lengths = _decode_inputs(np.random.default_rng(9), b, S, h, kv,
                                      dh, window)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    out = pallas_decode(qj, kj, vj, jnp.asarray(lengths), window=window,
                        bk=128, interpret=True)
    _close(out, decode_ops.decode_attention(qt, kt, vt,
                                            torch.from_numpy(lengths),
                                            window=window), TOL[dtype])


def test_decode_attention_matches_oracle_with_softcap():
    q, k, v, lengths = _decode_inputs(np.random.default_rng(10), 2, 300, 8, 2,
                                      64, 0)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "float32") for a in (q, k, v))
    out = decode_ops.decode_attention(qt, kt, vt, torch.from_numpy(lengths),
                                      softcap=30.0)
    _close(jax_decode_ref(qj, kj, vj, jnp.asarray(lengths), softcap=30.0),
           out, TOL["float32"])


def test_decode_attention_zero_length_gives_zero():
    """A sequence with nothing to attend to gets 0, as the Pallas kernel
    returns (the reference oracle gives the mean of v there)."""
    q, k, v, _ = _decode_inputs(np.random.default_rng(11), 2, 64, 4, 2, 64, 0)
    lengths = np.array([0, 17], np.int32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out = decode_ops.decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    pallas = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(lengths), bk=64, interpret=True)
    _close(pallas, out, TOL["float32"])


def test_cpu_wrappers_launch_no_kernel():
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 64, 64, 2, 1, 64))
    before = flash_ops.flash_attention.launches
    flash_ops.flash_attention(q, k, v)
    assert flash_ops.flash_attention.launches == before


@pytest.mark.parametrize("pairs", (1, 16, 512))
@pytest.mark.parametrize("num_sms", (1, 8, 132))
@pytest.mark.parametrize("S", (1, 63, 64, 300, 4096))
def test_decode_split_plan_covers_every_row_once(S, num_sms, pairs):
    """The decode kernel's splits: every cache row of [0, S) in exactly one
    split, whole tiles per split, at most MAX_SPLITS splits, no more
    blocks than one wave once a split holds more than a tile, and the plan
    a function of the shapes and the SM count alone (the host never reads
    lengths)."""
    chunk, nsplit = decode_ops.split_plan(S, num_sms, pairs)
    assert chunk % decode_ops.TILE == 0 and chunk > 0
    assert 1 <= nsplit <= decode_ops.MAX_SPLITS
    if chunk > decode_ops.TILE:
        assert nsplit * pairs <= max(num_sms, pairs)
    owner = np.full(S, -1)
    for split in range(nsplit):
        rows = np.arange(split * chunk, min((split + 1) * chunk, S))
        assert (owner[rows] == -1).all()
        owner[rows] = split
    assert (owner >= 0).all()
    assert decode_ops.split_plan(S, num_sms, pairs) == (chunk, nsplit)


def test_decode_split_plan_caps_splits_and_rejects_bad_sizes():
    chunk, nsplit = decode_ops.split_plan(10**6, 100_000, 1)
    assert nsplit <= decode_ops.MAX_SPLITS and chunk * nsplit >= 10**6
    # yi-9b's serving cache on 132 SMs: 8 splits of 512 rows at batch 4
    # (4 x 4 pairs), more and shorter splits at batches 1 and 2
    assert decode_ops.split_plan(4096, 132, 16) == (512, 8)
    assert decode_ops.split_plan(4096, 132, 8) == (256, 16)
    assert decode_ops.split_plan(4096, 132, 4) == (128, 32)
    for bad in ((0, 132, 16), (64, 0, 16), (64, 132, 0)):
        with pytest.raises(ValueError):
            decode_ops.split_plan(*bad)
