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
