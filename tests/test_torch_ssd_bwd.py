"""The SSD chunk scan's backward: its plain version against the reference.

``ssd_bwd_ref`` (the port's plain backward, written in the four stages of
the CUDA kernels in ``kernels/ssd/csrc/ssd_bwd.cu``) is held against
``jax.vjp`` of the reference's sequential oracle
``repro.kernels.ssd.ref.ssd_ref`` (not the reference's chunked XLA path,
which sums chunk states over every group: ROADMAP C-f) at the SSD sweep of
``tests/test_kernels.py`` (head_dim 1 and g > 1 among them), with
cotangents for y and the final state, at the reference's SSD tolerance
5e-4 (abs and rel; both sides sum in fp32, in other orders).  ``dinit``
(the oracle takes no initial state) is held against torch autograd through
the port's ``ssd_ref`` at 1e-4.  Padded rows (``models/ssm.py`` pads with
dt = 0 and x = B = C = 0) give zero gradients in every per-row output of
each stage.  On ``meta`` a grad-enabled ``ssd_scan`` goes through
``SSDChunkScanFn``, whose two operators the cost counter counts.  The CUDA
kernels themselves are held against ``ssd_bwd_ref`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as R  # noqa: E402
from repro_torch.launch import cost  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402

torch.set_num_threads(2)

TOL = 5e-4              # the reference's SSD tolerance (abs and rel)
# ddt and dA besides within this much of their largest entry: the chunked
# decay gradient sums each row's fp32 rounding of C . dC - x' . dx' into
# every earlier row of its chunk, then over the rows for dA (ref.py); at
# (1, 256, 8, 32, 2, 16, 64) dA is 4.2e-3 from float64 (6e-6 of its
# largest, 671), the sequential reverse pass 4.2e-4
SCALE_TOL = 2e-5
DINIT_TOL = 1e-4        # against autograd through the same package's oracle
# (b, s, h, p, g, n, chunk), as tests/test_kernels.py::test_ssd_sweep
SSD_SWEEP = [
    (2, 128, 4, 16, 1, 32, 32),
    (1, 256, 8, 32, 2, 16, 64),
    (1, 128, 4, 1, 1, 16, 16),    # head_dim=1 (jamba / mamba-1 mode)
    (2, 192, 6, 8, 3, 8, 64),     # uneven groups
]
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(b, s, h, p, g, n, seed=0):
    """x, dt, A, B, C, the initial state, dy and the final state's
    gradient, fp32 numpy from one seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    B, C = (rng.standard_normal((b, s, g, n)).astype(np.float32)
            for _ in "BC")
    init = rng.standard_normal((b, h, n, p)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dstate = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return x, dt, A, B, C, init, dy, dstate


def _close(got, want, tol, what, scale_tol=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=tol,
        atol=tol + scale_tol * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SWEEP)
def test_bwd_ref_matches_jax_vjp_of_the_oracle(b, s, h, p, g, n, chunk):
    x, dt, A, B, C, _, dy, dstate = _inputs(b, s, h, p, g, n)
    _, vjp = jax.vjp(jax_ssd_ref, *map(jnp.asarray, (x, dt, A, B, C)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    got = R.ssd_bwd_ref(*map(torch.from_numpy, (x, dt, A, B, C)), None,
                        torch.from_numpy(dy), torch.from_numpy(dstate),
                        chunk=chunk)
    for name, g_, w in zip(NAMES, got, want):
        assert g_.dtype == torch.float32 and g_.shape == w.shape
        _close(g_, w, TOL, name, SCALE_TOL if name in ("ddt", "dA") else 0)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 128, 4, 16, 1, 32, 32),
    (2, 192, 6, 8, 3, 8, 64),
    (1, 64, 4, 1, 1, 16, 64),     # one chunk
])
def test_bwd_ref_dinit_matches_autograd_through_the_port_oracle(
        b, s, h, p, g, n, chunk):
    arrays = [torch.from_numpy(a) for a in _inputs(b, s, h, p, g, n, seed=3)]
    x, dt, A, B, C, init, dy, dstate = arrays
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C, init)]
    y, state = R.ssd_ref(*leaves)
    want = torch.autograd.grad((y * dy).sum() + (state * dstate).sum(),
                               leaves)
    got = R.ssd_bwd_ref(x, dt, A, B, C, init, dy, dstate, chunk=chunk)
    for name, g_, w in zip(NAMES + ("dinit",), got, want):
        _close(g_, w, DINIT_TOL, name)


def _padded(seed=4, b=2, s=40, h=4, p=8, g=2, n=16, Q=16):
    """Inputs of ``ssd_scan``'s pad path: s real rows padded to a multiple
    of Q with dt = 0, x = B = C = 0 and (sliced off) dy = 0."""
    x, dt, A, B, C, _, dy, dstate = map(torch.from_numpy,
                                        _inputs(b, s, h, p, g, n, seed))
    pad = (-s) % Q

    def grow(t):
        return torch.cat([t, t.new_zeros((b, pad, *t.shape[2:]))], 1)

    return (x, dt, A, B, C, dy, dstate), \
        (grow(x), grow(dt), A, grow(B), grow(C), grow(dy), dstate), s, Q


STAGE_ROWS = {"dx": 0, "dB": 1, "dC": 2, "ddt_direct": 3, "dcum": 4,
              "ddt": 5}


@pytest.mark.parametrize("output,with_dstate", [
    *((name, False) for name in STAGE_ROWS),
    *((name, True) for name in ("dx", "dB", "dC", "ddt_direct"))])
def test_padded_rows_give_zero_gradients(output, with_dstate):
    """Every per-row output of stages 3 (dx, dB, dC, ddt's direct part, d
    cum) and 4 (ddt) is 0 on the padded rows, and the real rows' final
    gradients are the sequential oracle's on the unpadded sequence.  A
    final-state gradient reaches ddt of the padded rows (the decay of the
    state they pass on; the pad's backward drops it), so ddt is checked
    without one, as is d cum, whose suffix sums carry it there."""
    real, (x, dt, A, B, C, dy, dstate), s, Q = _padded()
    dstate = dstate if with_dstate else None
    states, dstates, total = R.bwd_chunk_states(x, dt, A, B, C, dy, Q)
    prev, grads, dinit, delta = R.bwd_state_pass(states, dstates, total,
                                                 None, dstate)
    rows = list(R.bwd_chunk_grads(x, dt, A, B, C, dy, Q, prev, grads))
    rows.append(R.bwd_decay(dt, A, rows[4], delta, rows[3], Q)[0])
    got = rows[STAGE_ROWS[output]]
    assert torch.count_nonzero(got[:, s:]) == 0
    if output in ("dx", "dB", "dC", "ddt"):
        xr, dtr, Ar, Br, Cr, dyr, dsr = real
        leaves = [t.clone().requires_grad_(True) for t in (xr, dtr, Br, Cr)]
        y, state = R.ssd_ref(leaves[0], leaves[1], Ar, leaves[2], leaves[3])
        loss = (y * dyr).sum() + ((state * dsr).sum() if with_dstate else 0)
        want = dict(zip(("dx", "ddt", "dB", "dC"),
                        torch.autograd.grad(loss, leaves)))[output]
        torch.testing.assert_close(got[:, :s], want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dt_value", (1.0, 8.0))
def test_chunked_path_gradients_past_the_exp_range(dt_value):
    """The CPU's chunked path (``models/ssm.py::_ssd_chunked``) differentiated
    by torch autograd equals autograd through the sequential oracle, also
    where a chunk's |sum of dt A| passes 88 (dt 8 over 16 rows): the decay
    masks its exponent, not its exp, so the masked branch's gradient is
    0, not 0 x inf (ROADMAP C-r)."""
    x, _, A, B, C, _, dy, _ = map(torch.from_numpy,
                                  _inputs(1, 48, 4, 8, 2, 8, seed=7))
    dt = torch.full((1, 48, 4), dt_value) + 0.1 * torch.rand(
        (1, 48, 4), generator=torch.Generator().manual_seed(7))
    A = -A.abs()
    got_leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    y, _ = S.ssd_scan(*got_leaves, 16)
    got = torch.autograd.grad((y * dy).sum(), got_leaves)
    want_leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    y, _ = R.ssd_ref(*want_leaves)
    want = torch.autograd.grad((y * dy).sum(), want_leaves)
    for name, g_, w in zip(NAMES, got, want):
        assert torch.isfinite(g_).all(), name
        _close(g_, w, TOL, name, SCALE_TOL if name in ("ddt", "dA") else 0)


def test_bwd_stages_compose_the_whole_backward():
    """``ssd_bwd_ref`` is its four stages run in turn."""
    arrays = [torch.from_numpy(a) for a in _inputs(1, 96, 4, 8, 2, 8, 5)]
    x, dt, A, B, C, init, dy, dstate = arrays
    whole = R.ssd_bwd_ref(x, dt, A, B, C, init, dy, dstate, chunk=32)
    st = R.bwd_chunk_states(x, dt, A, B, C, dy, 32)
    prev, grads, dinit, delta = R.bwd_state_pass(*st, init, dstate)
    dx, dB, dC, direct, dcum = R.bwd_chunk_grads(x, dt, A, B, C, dy, 32,
                                                 prev, grads)
    ddt, dA = R.bwd_decay(dt, A, dcum, delta, direct, 32)
    for w, g_ in zip(whole, (dx, ddt, dA, dB, dC, dinit)):
        assert torch.equal(w, g_)
    # the state pass's entering states are the oracle's at chunk edges
    _, s32 = R.ssd_ref(x[:, :32], dt[:, :32], A, B[:, :32], C[:, :32], init)
    torch.testing.assert_close(prev[:, 1], s32, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_cpu_wrapper_is_the_plain_backward(dtype):
    low = getattr(torch, dtype)
    x, dt, A, B, C, init, dy, dstate = map(
        torch.from_numpy, _inputs(1, 64, 4, 8, 1, 16, seed=6))
    x, B, C, dy = (t.to(low) for t in (x, B, C, dy))
    before = ssd_ops.ssd_chunk_scan_bwd.launches
    got = ssd_ops.ssd_chunk_scan_bwd(x, dt, A, B, C, dy, chunk=32, init=init,
                                     dstate=dstate)
    want = R.ssd_bwd_ref(x, dt, A, B, C, init, dy, dstate, chunk=32)
    assert ssd_ops.ssd_chunk_scan_bwd.launches == before
    assert [t.dtype for t in got] == [low, torch.float32, torch.float32, low,
                                      low, torch.float32]
    for g_, w in zip(got, want):
        assert torch.equal(g_, w.to(g_.dtype))
    with pytest.raises(ValueError, match="dy"):
        ssd_ops.ssd_chunk_scan_bwd(x, dt, A, B, C, dy[:, :32], chunk=32)


def test_autograd_function_refuses_cpu_tensors():
    """As ``FlashAttentionFn``: its operators launch on CUDA tensors only
    (the CPU's gradient is autograd through the chunked plain path)."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in
                      _inputs(1, 32, 2, 4, 1, 8)[:5])
    with pytest.raises(ValueError, match="not on"):
        ssd_ops.SSDChunkScanFn.apply(x.requires_grad_(True), dt, A, B, C, 32,
                                     None)


def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


@pytest.mark.parametrize("s", (64, 40))
def test_grad_enabled_scan_on_meta_counts_both_kernels(s):
    """``models/ssm.py::ssd_scan`` on ``meta`` with a gradient to take:
    y comes from ``SSDChunkScanFn``, the counter counts one forward and,
    once the gradient is taken, one backward, each by its formula at the
    padded length, and x, dt, A, B and C get gradients of their shapes."""
    b, h, p, g, n, Q = 2, 4, 16, 1, 16, 32
    conv = _meta(b, s, h * p + 2 * g * n, grad=True)
    x = conv[..., :h * p].view(b, s, h, p)
    B = conv[..., h * p:h * p + g * n].view(b, s, g, n)
    C = conv[..., h * p + g * n:].view(b, s, g, n)
    dt, A = _meta(b, s, h, grad=True), _meta(h, grad=True)
    counter = cost.CostCounter()
    with counter:
        y, state = S.ssd_scan(x, dt, A, B, C, Q)
        assert type(state.grad_fn).__name__ == "SSDChunkScanFnBackward"
        assert type(y.grad_fn.next_functions[0][0]).__name__ == \
            "SSDChunkScanFnBackward"
        grads = torch.autograd.grad(y.sum() + state.sum(), (conv, dt, A))
    sp = -(-s // Q) * Q
    k = counter.summary()["kernels"]
    fwd = cost.ssd_work(b, sp, h, p, g, n, Q, 4)
    bwd = cost.ssd_bwd_work(b, sp, h, p, g, n, Q, 4, dstate=True)
    assert k["ssd_chunk_scan"] == {"calls": 1, "flops": fwd[0],
                                   "bytes": fwd[1]}
    assert k["ssd_chunk_scan_bwd"] == {"calls": 1, "flops": bwd[0],
                                       "bytes": bwd[1]}
    assert [tuple(t.shape) for t in grads] == [tuple(conv.shape), (b, s, h),
                                               (h,)]


def test_bwd_work_at_mamba2_train_shape():
    """PERF.md's bound of the backward at mamba2-2.7b's train shape."""
    flops, nbytes = cost.ssd_bwd_work(4, 2048, 80, 64, 1, 128, 256)
    assert f"{flops:.4g}" == "1.186e+11"
    assert round(nbytes / 1e6, 2) == 265.29


@pytest.mark.parametrize("q,n,p,tile", [
    (256, 128, 64, 64),           # mamba2-2.7b
    (16, 16, 1, 16),              # jamba-v0.1-52b
    (128, 64, 64, 64),
    (100, 128, 64, 64),           # a chunk not a multiple of the tile
    (256, 128, 128, 32),          # wider than the bf16 forward takes
])
def test_bwd_plan_fits_the_card(q, n, p, tile):
    assert ssd_ops.bwd_plan(q, n, p) == tile
    assert max(ssd_ops.bwd_smem_bytes(tile, q, n, p).values()) <= \
        ssd_ops.SMEM_LIMIT


def test_bwd_plan_refuses_what_no_tile_fits():
    with pytest.raises(ValueError, match="shared memory"):
        ssd_ops.bwd_plan(256, 512, 256)


# ------------------------------------------- the bf16 backward's rounding
def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _hi_lo(t):
    hi = _bf16(t)
    return hi + _bf16(t - hi)


BF16_OPERANDS = ("x w", "dy e", "M1", "M2", "dS", "S_prev")


def _emulate_bf16_bwd(x, dt, A, B, C, dy, Q, rnd):
    """The bf16 backward kernels' arithmetic in float64 (one group, no
    initial state), with ``rnd[name]`` applied where they round an operand
    that is not bf16 data: the chunk states' x w (w = dt exp(sum after the
    row)) and the state gradients' dy e (e = exp(cum)); M1 = C B^T o L and
    M2 = dy x'^T o L, the A fragments of the keys kernel's products; the
    leaving-state gradient dS (also in <S_out, dS>) and the entering state
    S_prev as the keys and queries kernels read them.  d cum's intra terms
    are sums of S = (C B^T) o (dy x'^T) o L (unrounded), as the keys kernel
    forms them; dx, dB and dC round to bf16 at the end.

    What this cannot show: d cum's intra terms taken from the two hi + lo
    products (C . dC and x' . dx' with dC and dx' accumulated on the tensor
    cores) put ddt and dA outside phase 3's criterion on the card, yet
    emulated here, with the products in float64 or in float32, they stay
    inside it.  chip_smoke phase 3 alone guards that choice."""
    b, s, h, p = x.shape
    f64 = torch.float64
    a = dt.to(f64) * A.to(f64)
    Bf, Cf, xf, dyf, dtf = (B.to(f64)[:, :, 0], C.to(f64)[:, :, 0],
                            x.to(f64), dy.to(f64), dt.to(f64))
    nc, n = s // Q, B.shape[-1]
    tril = torch.tril(torch.ones(Q, Q, dtype=f64))[None, :, :, None]
    cums = [torch.cumsum(a[:, c * Q:(c + 1) * Q], 1) for c in range(nc)]
    states, dstates = [], []
    for c, cum in enumerate(cums):
        sl = slice(c * Q, (c + 1) * Q)
        w = dtf[:, sl] * torch.exp(cum[:, -1:] - cum)
        states.append(torch.einsum("bkn,bkhp->bhnp", Bf[:, sl],
                                   rnd["x w"](xf[:, sl] * w[..., None])))
        dstates.append(torch.einsum(
            "bqn,bqhp->bhnp", Cf[:, sl],
            rnd["dy e"](dyf[:, sl] * torch.exp(cum)[..., None])))
    S, prev = torch.zeros(b, h, n, p, dtype=f64), []
    for c, cum in enumerate(cums):
        prev.append(S)
        S = S * torch.exp(cum[:, -1])[..., None, None] + states[c]
    G, grads = torch.zeros_like(S), [None] * nc
    for c in reversed(range(nc)):
        grads[c] = G
        G = G * torch.exp(cums[c][:, -1])[..., None, None] + dstates[c]
    outs = prev[1:] + [S]
    delta = [(outs[c] * rnd["dS"](grads[c])).sum((-2, -1)) for c in range(nc)]
    dx = torch.zeros(b, s, h, p, dtype=f64)
    dB, dC = (torch.zeros(b, s, n, dtype=f64) for _ in "BC")
    dcum, direct = (torch.zeros(b, s, h, dtype=f64) for _ in "cd")
    for c, cum in enumerate(cums):
        sl = slice(c * Q, (c + 1) * Q)
        L = torch.exp(cum[:, :, None] - cum[:, None]) * tril      # b,q,k,h
        cb = torch.einsum("bqn,bkn->bqk", Cf[:, sl], Bf[:, sl])[..., None]
        xd = torch.einsum("bqhp,bkhp->bqkh", dyf[:, sl], xf[:, sl]) \
            * dtf[:, None, sl]
        M1, M2 = rnd["M1"](cb * L), rnd["M2"](xd * L)
        dS, Sp = rnd["dS"](grads[c]), rnd["S_prev"](prev[c])
        ea = torch.exp(cum[:, -1:] - cum)[..., None]
        ec = torch.exp(cum)[..., None]
        st_x = ea * torch.einsum("bkn,bhnp->bkhp", Bf[:, sl], dS)
        st_c = ec * torch.einsum("bqhp,bhnp->bqhn", dyf[:, sl], Sp)
        dxs = torch.einsum("bqkh,bqhp->bkhp", M1, dyf[:, sl]) + st_x
        dB[:, sl] = (torch.einsum("bqkh,bqn->bkhn", M2, Cf[:, sl])
                     + (ea * dtf[:, sl, :, None]) * torch.einsum(
                         "bkhp,bhnp->bkhn", xf[:, sl], dS)).sum(2)
        dCh = torch.einsum("bqkh,bkn->bqhn", M2, Bf[:, sl]) + st_c
        dC[:, sl] = dCh.sum(2)
        xs = xf[:, sl] * dtf[:, sl, :, None]
        Sm = cb * xd * L
        dcum[:, sl] = Sm.sum(2) + (Cf[:, sl, None] * st_c).sum(-1) \
            - Sm.sum(1) - (xs * st_x).sum(-1)
        direct[:, sl] = (xf[:, sl] * dxs).sum(-1)
        dx[:, sl] = dxs * dtf[:, sl, :, None]
    da = torch.flip(torch.cumsum(torch.flip(dcum.reshape(b, nc, Q, h), (2,)),
                                 2), (2,)) + torch.stack(delta, 1)[:, :, None]
    da = da.reshape(b, s, h)
    return (_bf16(dx), direct + A.to(f64) * da, (dtf * da).sum((0, 1)),
            _bf16(dB[:, :, None]), _bf16(dC[:, :, None]))


@pytest.mark.parametrize("rounding,fits", [
    ("hi+lo", True), ("bf16", False),
    *((f"bf16 {name}", False) for name in BF16_OPERANDS)])
def test_bf16_backward_splits_its_scaled_operands(rounding, fits):
    """Why the bf16 backward multiplies hi + lo halves wherever an operand
    is not bf16 data: with every such operand split, dx, ddt, dA, dB and
    dC stay within chip_smoke phase 3's criterion against the float64 plain
    backward (SSD_TOL 2e-2 abs and rel, ddt and dA besides 2e-5 of their
    largest entry) at mamba2's widths (n 128, p 64, chunk 256, three chunks,
    |sum of dt A| past 350); one bf16 rounding of them all, or of any one of
    them alone ("bf16 <operand>"), does not fit."""
    g = torch.Generator().manual_seed(1)
    b, s, h, p, n, Q = 1, 768, 4, 64, 128, 256
    x = torch.randn(b, s, h, p, generator=g).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g))
    A = -torch.exp(0.5 * torch.randn(h, generator=g))
    B = torch.randn(b, s, 1, n, generator=g).bfloat16()
    C = torch.randn(b, s, 1, n, generator=g).bfloat16()
    dy = torch.randn(b, s, h, p, generator=g).bfloat16()
    rnd = dict.fromkeys(BF16_OPERANDS, _bf16 if rounding == "bf16" else _hi_lo)
    if rounding.startswith("bf16 "):
        rnd[rounding[5:]] = _bf16
    got = _emulate_bf16_bwd(x, dt, A, B, C, dy, Q, rnd)
    f64 = torch.float64
    want = R.ssd_bwd_ref(*(t.to(f64) for t in (x, dt, A, B, C)), None,
                         dy.to(f64), None, chunk=Q)
    ok = True
    for name, g_, w in zip(NAMES, got, want):
        atol = 2e-2 + (SCALE_TOL * float(w.abs().max())
                       if name in ("ddt", "dA") else 0.0)
        ok &= bool(((g_ - w).abs() <= atol + 2e-2 * w.abs()).all())
    assert ok == fits


# (b, s, h, p, g, n, chunk): chip_smoke's SSD_BWD_SHAPES (mamba2-2.7b's
# train shape, g 3, jamba's widths over 4 heads and at full width over
# phase 11's b x s) and a chunk not a multiple of 64
BF16_BWD_SHAPES = [(4, 2048, 80, 64, 1, 128, 256),
                   (2, 512, 6, 64, 3, 64, 128),
                   (1, 128, 4, 1, 1, 16, 16),
                   (4, 2048, 8192, 1, 1, 16, 16),
                   (1, 300, 4, 64, 1, 128, 100)]


@pytest.mark.parametrize("shape", BF16_BWD_SHAPES)
def test_bwd_bf16_plan_takes_the_card_shapes(shape):
    """The bf16 backward's plan at every shape chip_smoke checks: padded
    widths, 64-row tiles, grids, every block within the card's shared
    memory, the scratch's shapes: each head's state padded to a packing
    group (64 elements, or 8 where n p is not a multiple of 64), M2 tiles
    of the chunk's rows (at most 64) over as many (chunk, batch) rows as
    fit M2_BYTES, key-tile partials only where a chunk has several tiles."""
    b, s, h, p, g, n, q = shape
    pl = ssd_ops.bwd_bf16_plan(*shape)
    nc, nt = s // q, -(-q // 64)
    tiles = g * -(-(h // g) // min(16, h // g))
    group = 64 if n * p % 64 == 0 else 8
    tm = 64 if nt > 1 else -(-q // 16) * 16
    pairs = nt * (nt + 1) // 2
    rows = min(nc * b, ssd_ops.M2_BYTES // (h * pairs * 2 * tm * tm * 2))
    assert pl.pp == (16 if p <= 16 else 32 if p <= 32 else 64)
    assert (pl.npad, pl.qt) == (-(-n // 16) * 16, nt * 64)
    assert pl.heads_per_block == min(16, h // g)
    assert pl.grids["chunk"] == (nc, h, b)
    assert pl.grids["pass"] == (h, b, 1)
    assert pl.grids["keys"] == pl.grids["queries"] == (tiles, rows, nt)
    assert (pl.m2_rows, pl.slices) == (rows, -(-(nc * b) // rows))
    assert max(pl.smem.values()) <= ssd_ops.SMEM_LIMIT
    assert pl.state_row == h * -(-(n * p) // group) * group
    assert pl.m2_shape == (rows, h, pairs, 2, tm, tm)
    assert 2 * np.prod(pl.m2_shape) <= ssd_ops.M2_BYTES
    assert pl.cols_shape == ((b, s, h, nt) if nt > 1 else None)


def test_bwd_bf16_plan_at_mamba2_train_shape():
    """PERF.md's layout of the bf16 backward at mamba2-2.7b's train shape:
    640 keys and queries blocks of one group's 16 heads, one block to an SM
    (186-225 KB), in one slice, 2,560 chunk blocks at three to an SM, ~598
    MB of scratch (the M2 tiles 420 MB of it)."""
    pl = ssd_ops.bwd_bf16_plan(4, 2048, 80, 64, 1, 128, 256)
    assert pl.grids["keys"] == (5, 32, 4)
    assert pl.slices == 1
    assert pl.smem == {"chunk": 73760, "keys": 229376, "queries": 190240,
                       "pass": 0, "finish": 0}
    assert pl.scratch_bytes == 597_688_320
    assert 2 * np.prod(pl.m2_shape) == 419_430_400


def test_bwd_bf16_scratch_at_jamba_train_shape():
    """jamba-v0.1-52b's SSM at its train shape (b 4, s 2048: 8,192 heads of
    head_dim 1, d_state 16, chunk 16): the state scratches hold n p = 16
    elements a head unpadded, as the fp32 layout does (0.54 GB for the two);
    the M2 tiles are 16 x 16 and run in 8 slices of 64 (chunk, batch) rows,
    0.54 GB, where 64 x 64 tiles over every row would take 68.7 GB; no
    key-tile partials.  The bf16 scratch is at most twice the fp32
    layout's states."""
    b, s, h, p, g, n, q = 4, 2048, 8192, 1, 1, 16, 16
    pl = ssd_ops.bwd_bf16_plan(b, s, h, p, g, n, q)
    states = 2 * 4 * b * (s // q) * h * n * p      # (b, nc, h, n, p) fp32 x 2
    assert 4 * 2 * b * (s // q) * pl.state_row == states == 536_870_912
    assert pl.m2_shape == (64, h, 1, 2, 16, 16)
    assert pl.slices == 8
    assert pl.cols_shape is None
    assert 2 * b * (s // q) * h * 2 * 64 * 64 == 68_719_476_736
    assert pl.scratch_bytes == 1_073_741_824 <= 2 * states
@pytest.mark.parametrize("shape", [
    (1, 512, 4, 128, 1, 128, 256),      # head_dim above 64
    (1, 512, 4, 64, 1, 256, 256),       # d_state above 128
    (1, 1024, 4, 64, 1, 128, 512),      # chunk above 256
    (65536, 256, 4, 64, 1, 128, 256),   # (chunk, batch) pairs
])
def test_bwd_bf16_plan_refuses_what_its_kernels_do_not_take(shape):
    with pytest.raises(ValueError):
        ssd_ops.bwd_bf16_plan(*shape)


@pytest.mark.parametrize("n,p", [(6, 5), (8, 8), (16, 1)])
def test_unpack_states_reads_the_state_pass_layout(n, p):
    """The bf16 state pass packs each head's n p elements in groups of 64
    (n p a multiple of 64) or of 8 (else; the head padded to a whole
    group): the group's hi bf16 halves, then its lo halves;
    ``unpack_states`` gives hi + lo back as (b, nc, h, n, p), within 2^-16
    of the fp32 states.  n p = 30 pads to 32, 64 and jamba's 16 do not."""
    b, nc, h = 2, 3, 5
    e = n * p
    k = 64 if e % 64 == 0 else 8
    states = torch.randn(b, nc, h, e, generator=torch.Generator()
                         .manual_seed(2))
    hi = states.bfloat16()
    lo = (states - hi.float()).bfloat16()
    pad = -(-e // k) * k
    flat = torch.zeros(b, nc, h, 2, pad, dtype=torch.bfloat16)
    flat[:, :, :, 0, :e], flat[:, :, :, 1, :e] = hi, lo
    groups = flat.reshape(b, nc, h, 2, pad // k, k).transpose(3, 4)
    buf = groups.reshape(b, nc, -1).view(torch.float32)
    assert buf.shape[-1] == ssd_ops.bwd_bf16_plan(
        b, nc * 16, h, p, 1, n, 16).state_row
    got = ssd_ops.unpack_states(buf, h, n, p)
    want = states.reshape(b, nc, h, n, p)
    torch.testing.assert_close(got, want, atol=0, rtol=2.0 ** -16)


def _row_buffers(dcum, cols):
    """BwdBuffers holding only ``dcum`` and ``cols`` (what bwd_row_dcum
    reads)."""
    return ssd_ops.BwdBuffers(*[None] * 9, dcum, None, None, cols=cols)


def test_bwd_row_dcum_adds_the_key_tiles_that_reach_a_row():
    """bf16: a row's d cum is its stored share plus the key tiles' shares
    of C . dC from tiles at or before its own (later slots are never
    written: NaN here); fp32 buffers and bf16 chunks of one tile (no
    ``cols``) hold it whole."""
    b, s, h, q = 1, 200, 2, 100                   # tiles of 64: 2 a chunk
    dcum = torch.ones(b, s, h)
    cols = torch.full((b, s, h, 2), float("nan"))
    rows = torch.arange(s) % q
    cols[:, :, :, 0] = 2.0
    cols[:, rows >= 64, :, 1] = 3.0
    got = ssd_ops.bwd_row_dcum(_row_buffers(dcum, cols), q)
    want = torch.where((rows >= 64)[None, :, None], 6.0, 3.0).expand(b, s, h)
    torch.testing.assert_close(got, want)
    assert ssd_ops.bwd_row_dcum(_row_buffers(dcum, None), q) is dcum
