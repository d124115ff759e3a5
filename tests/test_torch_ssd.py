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
import torch.nn.functional as F  # noqa: E402

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


# --------------------------------------------------------- bf16 kernels' plan
# (b, s, h, p, g, n, chunk) of mamba2-2.7b's serving batch
SERVING = (4, 2048, 80, 64, 1, 128, 256)
CARD_SWEEP = SSD_SWEEP + [
    (1, 300, 4, 64, 1, 128, 100),
    (1, 256, 40, 32, 2, 64, 128),
    (1, 128, 5, 3, 1, 8, 32),
    (2, 256, 40, 1, 1, 16, 16),
    SERVING,
]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CARD_SWEEP)
def test_bf16_plan_fits_the_card(b, s, h, p, g, n, chunk):
    """Grids, heads per block, shared memory and scratch of the three bf16
    kernels at every shape the card tests and chip_smoke run."""
    q = min(chunk, s)
    pl = ssd_ops.bf16_plan(b, s, h, p, g, n, q)
    nc = s // q
    hpg = h // g
    assert pl.heads_per_block == min(16, hpg)
    assert pl.pp == max(16, 1 << (p - 1).bit_length())
    assert pl.npad % 16 == 0 and n <= pl.npad < n + 16
    assert pl.qt % ssd_ops.TQ == 0 and q <= pl.qt < q + ssd_ops.TQ
    assert pl.grids["states"] == (nc, h, b)
    row = -(-h * n * p // 256) * 256
    assert pl.grids["pass"] == (-(-row // 2048), b, 1)
    tiles, head_tiles, zs = pl.grids["scan"]
    assert tiles * ssd_ops.TQ == pl.qt and zs == nc * b
    # every head of every group falls in exactly one scan block
    assert head_tiles == g * -(-hpg // pl.heads_per_block)
    assert (head_tiles // g) * pl.heads_per_block >= hpg
    assert ((head_tiles // g) - 1) * pl.heads_per_block < hpg
    for kernel in ("states", "scan"):
        assert 0 < pl.smem[kernel] <= ssd_ops.SMEM_LIMIT
    assert pl.scratch_shape == (b, nc, row)
    assert pl.decay_shape == (b, nc, h)
    assert pl.scratch_bytes == 4 * b * nc * (row + h)


def test_bf16_plan_at_the_serving_shape():
    """mamba2-2.7b prefill: 2560 state blocks (three to an SM), 1280 pass
    blocks, 640 scan blocks of 16 heads (one to an SM), 84 MB of scratch."""
    pl = ssd_ops.bf16_plan(*SERVING)
    assert pl.grids == {"states": (8, 80, 4), "pass": (320, 4, 1),
                        "scan": (4, 5, 32)}
    assert pl.heads_per_block == 16 and (pl.pp, pl.npad, pl.qt) == (64, 128,
                                                                     256)
    assert pl.smem["scan"] == 205_888 and pl.smem["states"] == 72_736
    sm_bytes = 233_472              # an SM's shared memory, 1 KB per block
    assert 3 * (pl.smem["states"] + 1024) <= sm_bytes
    assert pl.smem["scan"] + 1024 <= sm_bytes
    assert pl.scratch_bytes == 4 * 4 * 8 * 80 * (128 * 64 + 1)


# jamba-v0.1-52b's SSD widths (8192 heads of head_dim 1, d_state 16, chunk
# 16) at the serving batch and length
JAMBA = (4, 2048, 8192, 1, 1, 16, 16)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CARD_SWEEP + [JAMBA])
def test_bf16_scratch_is_the_size_of_the_states(b, s, h, p, g, n, chunk):
    """The scratch holds one n x p fp32 state per (batch, chunk, head),
    packed, plus less than 256 floats of padding per (batch, chunk) and the
    decay sums: at head_dim 1 and d_state 16 no head is padded to 256."""
    q = min(chunk, s)
    nc = s // q
    pl = ssd_ops.bf16_plan(b, s, h, p, g, n, q)
    states = b * nc * h * n * p
    assert states <= pl.scratch_bytes // 4 - b * nc * h < states + 256 * b * nc


@pytest.mark.parametrize("q,n,p", [(512, 128, 64), (256, 256, 64),
                                   (256, 128, 128)])
def test_bf16_plan_rejects_what_the_kernels_do_not_take(q, n, p):
    with pytest.raises(ValueError, match="bf16 SSD kernels take"):
        ssd_ops.bf16_plan(1, q, 4, p, 1, n, q)
    with pytest.raises(ValueError, match="65535"):
        ssd_ops.bf16_plan(2, 40000 * 16, 4, 64, 1, 128, 16)


def _operands(dtype=torch.bfloat16):
    x, dt, A, B, C = map(torch.from_numpy, _inputs(1, 64, 4, 16, 1, 32))
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype)


@pytest.mark.parametrize("case", ["fp16", "mixed", "dt_bf16", "A_f64",
                                  "init_bf16", "x_not_dense", "dt_strided",
                                  "init_strided"])
def test_operand_checks_reject_what_the_kernels_do_not_take(case):
    """``check_operands`` is what the wrapper runs before a launch on the
    card; it depends on dtypes and layouts alone, so it runs here."""
    x, dt, A, B, C = _operands()
    init = torch.zeros((1, 4, 32, 16))
    if case == "fp16":
        x, B, C = (t.half() for t in (x, B, C))
    elif case == "mixed":
        B = B.float()
    elif case == "dt_bf16":
        dt = dt.bfloat16()
    elif case == "A_f64":
        A = A.double()
    elif case == "init_bf16":
        init = init.bfloat16()
    elif case == "x_not_dense":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "dt_strided":
        dt = dt.transpose(0, 1).contiguous().transpose(0, 1)[:, ::2]
    elif case == "init_strided":
        init = torch.zeros((1, 4, 16, 32)).transpose(2, 3)
    err = TypeError if case in ("fp16", "mixed", "dt_bf16", "A_f64",
                                "init_bf16") else ValueError
    with pytest.raises(err):
        ssd_ops.check_operands(x, dt, A, B, C, init)


def test_operand_checks_take_the_model_layout():
    """Slices of one conv output, as models/ssm.py passes them, pass."""
    conv = torch.zeros((2, 32, 4 * 16 + 2 * 32), dtype=torch.bfloat16)
    x = conv[..., :64].view(2, 32, 4, 16)
    B = conv[..., 64:96].view(2, 32, 1, 32)
    C = conv[..., 96:].view(2, 32, 1, 32)
    ssd_ops.check_operands(x, torch.zeros((2, 32, 4)), torch.zeros(4), B, C,
                           torch.zeros((2, 4, 32, 16)))


def test_wrapper_takes_an_initial_state():
    x, dt, A, B, C = map(torch.from_numpy, _inputs(2, 64, 4, 8, 2, 16))
    init = torch.randn((2, 4, 16, 8), generator=torch.Generator()
                       .manual_seed(3))
    y, state = ssd_ops.ssd_chunk_scan(x, dt, A, B, C, chunk=16, init=init)
    yr, sr = ssd_ref(x, dt, A, B, C, init)
    torch.testing.assert_close(y, yr, atol=0, rtol=0)
    torch.testing.assert_close(state, sr, atol=0, rtol=0)
    y1, s1 = ssd_ops.ssd_chunk_scan(x[:, :32], dt[:, :32], A, B[:, :32],
                                    C[:, :32], chunk=16, init=init)
    y2, s2 = ssd_ops.ssd_chunk_scan(x[:, 32:], dt[:, 32:], A, B[:, 32:],
                                    C[:, 32:], chunk=16, init=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), yr, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(s2, sr, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="init"):
        ssd_ops.ssd_chunk_scan(x, dt, A, B, C, chunk=16, init=init[:1])


# ------------------------------------------- the bf16 kernels' rounding
def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _hi_lo(t):
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _emulate_bf16_kernels(x, dt, A, B, C, Q, rnd):
    """The bf16 kernels' arithmetic in float64, with ``rnd`` applied where
    they round an operand that is not bf16 data: the decayed scores
    C B^T o L o dt, x' = x dt exp(sum after the row) and the state entering
    each chunk.  One group."""
    b, s, h, p = x.shape
    f64 = torch.float64
    a = dt.to(f64) * A.to(f64)
    Bf, Cf, xf = B.to(f64)[:, :, 0], C.to(f64)[:, :, 0], x.to(f64)
    y = torch.zeros(b, s, h, p, dtype=f64)
    S = torch.zeros(b, h, B.shape[-1], p, dtype=f64)
    tril = torch.tril(torch.ones(Q, Q, dtype=f64))[None, :, :, None]
    for c in range(s // Q):
        sl = slice(c * Q, (c + 1) * Q)
        cum = torch.cumsum(a[:, sl], 1)                           # b,Q,h
        dtc = dt[:, sl].to(f64)
        cb = torch.einsum("bqn,bkn->bqk", Cf[:, sl], Bf[:, sl])
        L = torch.exp(cum[:, :, None] - cum[:, None]) * tril       # b,q,k,h
        P = rnd(cb[..., None] * L * dtc[:, None])
        y[:, sl] = torch.einsum("bqkh,bkhp->bqhp", P, xf[:, sl]) + \
            torch.exp(cum)[..., None] * torch.einsum(
                "bqn,bhnp->bqhp", Cf[:, sl], rnd(S))
        w = torch.exp(cum[:, -1:] - cum) * dtc
        S = S * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bkn,bkhp->bhnp", Bf[:, sl], rnd(xf[:, sl] * w[..., None]))
    return y, S


@pytest.mark.parametrize("rounding,fits", [("hi+lo", True), ("bf16", False)])
def test_bf16_kernels_split_their_scaled_operands(rounding, fits):
    """Why the bf16 kernels multiply hi + lo halves: rounding the decayed
    scores, x' and the state to one bf16 each puts y outside 2e-2 of the
    sequential recurrence at mamba2's widths (n 128, p 64, chunk 256) on
    the card tests' inputs; the split stays inside, as exact arithmetic
    with y rounded to bf16 does."""
    g = torch.Generator().manual_seed(1)
    b, s, h, p, n, Q = 1, 768, 4, 64, 128, 256
    x = torch.randn(b, s, h, p, generator=g).bfloat16()
    dt = F.softplus(torch.randn(b, s, h, generator=g))
    A = -torch.exp(0.5 * torch.randn(h, generator=g))
    B = torch.randn(b, s, 1, n, generator=g).bfloat16()
    C = torch.randn(b, s, 1, n, generator=g).bfloat16()
    yr, sr = ssd_ref(x, dt, A, B, C)
    y, state = _emulate_bf16_kernels(
        x, dt, A, B, C, Q, _hi_lo if rounding == "hi+lo" else _bf16)
    y = y.float().bfloat16().float()
    ok_y = bool(((y - yr).abs() <= 2e-2 + 2e-2 * yr.abs()).all())
    ok_s = bool(((state.float() - sr).abs() <= 2e-2 + 2e-2 * sr.abs()).all())
    assert (ok_y and ok_s) == fits


def test_port_ssd_forward_from_a_state_matches_reference():
    """The port's ssd_forward continued from an SSM state (and a conv
    state), against the reference's on the same weights and inputs, in
    fp32; 24 tokens take the pad path of chunk 16."""
    from dataclasses import replace

    import jax
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import ssm as jax_ssm
    from repro.models.model import Model as JaxModel
    from repro.models.param import init_params as jax_init_params
    from repro_torch.configs import smoke_config
    from repro_torch.models.convert import params_from_jax

    jcfg = replace(jax_smoke_config("mamba2-2.7b"), dtype="float32")
    tcfg = replace(smoke_config("mamba2-2.7b"), dtype="float32")
    jm = JaxModel(jcfg)
    jp = jax_init_params(jm.param_template(), jax.random.PRNGKey(0))
    # the first of the stacked SSM layers
    jp = jax.tree.map(lambda a: np.asarray(a)[0], jp["blocks"]["s0"]["ssm"])
    tp = params_from_jax(jp, device="cpu")
    s = tcfg.ssm
    rng = np.random.default_rng(4)
    b, L = 2, 24
    x = rng.standard_normal((b, L, tcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal(
        (b, s.conv_width - 1, s.d_inner + 2 * s.n_groups * s.d_state)
    ).astype(np.float32)
    state = rng.standard_normal(
        (b, s.n_heads, s.d_state, s.head_dim)).astype(np.float32)
    jout, (jconv, jstate) = jax_ssm.ssd_forward(
        jnp.asarray(x), jp, jcfg, jnp.asarray(conv), jnp.asarray(state),
        return_state=True)
    tout, (tconv, tstate) = S.ssd_forward(
        torch.from_numpy(x), tp, tcfg, torch.from_numpy(conv),
        torch.from_numpy(state), return_state=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate),
                               atol=1e-4, rtol=1e-4)
    # the state matters: starting from zeros gives another output
    zout = S.ssd_forward(torch.from_numpy(x), tp, tcfg,
                         torch.from_numpy(conv))
    assert float((zout - tout).abs().max()) > 1e-2
