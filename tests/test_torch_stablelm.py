"""stablelm-3b's head_dim 80 in the port, against the reference, on the CPU.

The attention wrappers at dh 80 (on the CPU they take their plain
versions): the forward and decode against the Pallas kernels run in
interpret mode (as ``tests/test_kernels.py`` runs them), the backward
against ``jax.vjp`` of the reference's ``blocked_attention`` (what the
reference trains through: its Pallas kernel has no backward), in fp32 and
bf16, causal and windowed, at g 1 (stablelm's MHA) and g 4.  Tolerances:
fp32 3e-5 and bf16 2e-2 (atol and rtol), the kernel tests' own.

A narrow stablelm config at head_dim 80 (2 layers, the weights carried
across by ``params_from_jax``): prefill and decode-step logits against the
reference ``Model`` at 2e-3 (the reference's decode-consistency tolerance,
as ``tests/test_torch_model.py``), and the train loss and every gradient
against ``jax.value_and_grad`` at 2e-4 atol / 2e-3 rtol (as
``tests/test_torch_train.py``).  Its block weights are drawn at std
1/sqrt(fan-in), as chip_smoke's phase 4 draws them: at the init's own std
(1/sqrt(layers), ROADMAP C-k) the embedding's gradient reaches 3.9 and
both packages' fp32 gradients lie 2.7e-4 (the port) and 4.1e-4 (the
reference) from float64, so no fp32 pair could meet 2e-4.  Then
``examples/torch_serve_flex.py --device cpu`` (the paper's Scenario 3)
end to end.  The CUDA kernels at
dh 80 are held against the plain versions in ``tests/test_torch_cuda.py``.
"""

import os
import subprocess
import sys
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.decode_attention.kernel import \
    decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention.kernel import \
    flash_attention as pallas_flash  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from repro.models.param import is_spec as jax_is_spec  # noqa: E402
from repro.train.loop import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch.checkpoint import leaf_paths  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import tree_map  # noqa: E402
from repro_torch.train import make_loss_fn  # noqa: E402

torch.set_num_threads(2)

DH = get_config("stablelm-3b").head_dim
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
DTYPES = ("float32", "bfloat16")
LOGITS_TOL = 2e-3
ATOL, RTOL = 2e-4, 2e-3

# (b, sq, sk, h, kv, causal, window, softcap) at head_dim 80: stablelm's
# MHA (g 1) causal, g 4 windowed with a softcap, g 4 non-causal over a
# longer key sequence
FLASH_SHAPES = [
    (2, 256, 256, 4, 4, True, 0, 0.0),
    (1, 256, 256, 8, 2, True, 96, 30.0),
    (2, 128, 256, 4, 1, False, 0, 0.0),
]
# (b, sq, h, kv, causal, window, softcap): the backward's (sq == sk, where
# blocked_attention's masks agree with the kernels')
BWD_SHAPES = [
    (2, 64, 4, 4, True, 0, 0.0),
    (1, 96, 8, 2, True, 40, 20.0),
    (1, 48, 4, 1, False, 0, 0.0),
]
# (b, S, h, kv, window): g 1 over a ragged cache, g 4 with a window
DECODE_SHAPES = [
    (2, 512, 4, 4, 0),
    (3, 300, 16, 4, 64),
]


def _pair(a, dtype):
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return j, t


def _close(want, got, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=tol, err_msg=msg)


def _normal(rng, *shape):
    return rng.standard_normal(shape, np.float32)


# --------------------------------------------------------------- kernels
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,sq,sk,h,kv,causal,window,softcap", FLASH_SHAPES)
def test_flash_forward_at_dh80_vs_pallas(b, sq, sk, h, kv, causal, window,
                                         softcap, dtype):
    rng = np.random.default_rng(80)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(a, dtype) for a in (_normal(rng, b, sq, h, DH),
                                  _normal(rng, b, sk, kv, DH),
                                  _normal(rng, b, sk, kv, DH)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = pallas_flash(qj, kj, vj, bq=128, bk=128, interpret=True, **kw)
    got = flash_ops.flash_attention(qt, kt, vt, **kw)
    assert got.shape == (b, sq, h, DH) and got.dtype == qt.dtype
    _close(want, got, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,kv,causal,window,softcap", BWD_SHAPES)
def test_flash_backward_at_dh80_vs_reference_grad(b, s, h, kv, causal,
                                                  window, softcap, dtype):
    """dq, dk, dv of the port's backward wrapper (dk / dv summed over the
    g query heads of each kv head) against jax.vjp of the reference's
    ``blocked_attention`` in the same dtype."""
    rng = np.random.default_rng(81)
    arrays = (_normal(rng, b, s, h, DH), _normal(rng, b, s, kv, DH),
              _normal(rng, b, s, kv, DH), _normal(rng, b, s, h, DH))
    pairs = [_pair(a, dtype) for a in arrays]
    (qj, kj, vj, doj), (qt, kt, vt, dot) = zip(*pairs)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = flash_ops.flash_attention(qt, kt, vt, **kw)
    got = flash_ops.flash_attention_bwd(qt, kt, vt, out, dot, None, **kw)

    def fwd(q_, k_, v_):
        return jax_layers.blocked_attention(q_, k_, v_, causal=causal,
                                            window=window, cap=softcap,
                                            q_blocks=4)

    want = jax.vjp(fwd, qj, kj, vj)[1](doj)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == qt.dtype
        _close(w, g, TOL[dtype], name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,S,h,kv,window", DECODE_SHAPES)
def test_decode_at_dh80_vs_pallas(b, S, h, kv, window, dtype):
    rng = np.random.default_rng(82)
    lengths = rng.integers(max(window, 8), S, (b,)).astype(np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(a, dtype) for a in (_normal(rng, b, h, DH),
                                  _normal(rng, b, S, kv, DH),
                                  _normal(rng, b, S, kv, DH)))
    want = pallas_decode(qj, kj, vj, jnp.asarray(lengths), window=window,
                         bk=128, interpret=True)
    got = decode_ops.decode_attention(qt, kt, vt, torch.from_numpy(lengths),
                                      window=window)
    _close(want, got, TOL[dtype])


def test_head_dim_80_is_a_kernel_head_dim():
    """The card's kernels take stablelm's head dim (a CUDA tensor at any
    other head dim raises, ``tests/test_torch_cuda.py``)."""
    assert DH == 80
    assert DH in flash_ops.HEAD_DIMS and DH in decode_ops.HEAD_DIMS


# ----------------------------------------------------------------- model
def _fan_in_std(spec):
    """A stacked block weight (reference ``ParamSpec``) drawn at std
    1/sqrt(fan-in), the contracted dims: ``embed`` in, or all but
    ``embed`` out (chip_smoke's ``well_conditioned``)."""
    if spec.axes[:1] != ("layers",) or spec.init != "normal" \
            or spec.scale is not None:
        return spec
    dims = [n for n, a in zip(spec.shape, spec.axes) if a != "layers"]
    fan_in = (int(np.prod(dims[:-1])) if spec.axes[-1] == "embed"
              else dims[0])
    return replace(spec, scale=fan_in ** -0.5)


@pytest.fixture(scope="module")
def stablelm_pair():
    """(jax model, jax params, port model, port params): stablelm's fp32
    smoke config (2 layers, 4 MHA heads) at head_dim 80, block weights at
    std 1/sqrt(fan-in)."""
    jm = JaxModel(replace(jax_smoke_config("stablelm-3b"), head_dim=DH,
                          dtype="float32"))
    tpl = jax.tree.map(_fan_in_std, jm.param_template(), is_leaf=jax_is_spec)
    jp = jax_init_params(tpl, jax.random.PRNGKey(3))
    tm = Model(replace(smoke_config("stablelm-3b"), head_dim=DH,
                       dtype="float32"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_stablelm_at_dh80_prefill_and_decode_match_reference(stablelm_pair):
    jm, jp, tm, tp = stablelm_pair
    assert tm.cfg.head_dim == DH and tm.cfg.n_layers == 2
    b, s = 2, 24
    toks = np.random.default_rng(83).integers(0, tm.cfg.vocab_size,
                                              (b, s + 2))
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks[:, :s]), cache_len=s + 8)
    tlast, tcache = tm.prefill(tp, torch.from_numpy(toks[:, :s]),
                               cache_len=s + 8)
    _close(jlast, tlast, LOGITS_TOL, "prefill")
    for t in range(s, s + 2):
        pos = np.full((b,), t, np.int32)
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t]),
                                    jnp.asarray(pos))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(toks[:, t]),
                                    torch.from_numpy(pos).long())
        _close(jl, tl, LOGITS_TOL, f"decode at {t}")


def test_stablelm_at_dh80_loss_and_gradients_match_reference(stablelm_pair):
    jm, jp, tm, _ = stablelm_pair
    rng = np.random.default_rng(84)
    inputs = rng.integers(0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    targets = rng.integers(0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    targets[0, :3] = -1
    (jl, _), jg = jax.value_and_grad(jax_make_loss_fn(jm, ce_chunk=8),
                                     has_aux=True)(
        jp, {"inputs": jnp.asarray(inputs), "targets": jnp.asarray(targets)})
    live = tree_map(lambda t: t.requires_grad_(True),
                    params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu"))
    tl, _ = make_loss_fn(tm, ce_chunk=8)(
        live, {"inputs": torch.from_numpy(inputs),
               "targets": torch.from_numpy(targets)})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=ATOL,
                               rtol=RTOL)
    want = dict(leaf_paths(jax.tree.map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), jg)))
    got = dict(leaf_paths(tree_map(lambda t: t.grad, live)))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


# --------------------------------------------------------------- example
def test_serve_flex_example_on_the_cpu():
    """Scenario 3: train, checkpoint as Hudi (synced inline to Iceberg),
    restore through the Iceberg view, serve the reference example's four
    requests of 12 tokens each."""
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, os.path.join(root, "examples", "torch_serve_flex.py"),
         "--steps", "4", "--device", "cpu"], env=env, capture_output=True,
        text=True, timeout=300, cwd=root)
    assert r.returncode == 0, r.stdout + r.stderr
    served = [line for line in r.stdout.splitlines()
              if line.startswith("req")]
    assert len(served) == 4, r.stdout
    for line in served:
        tokens = line.split(" -> ")[1].strip("[]").split(", ")
        assert len(tokens) == 12 and all(0 <= int(t) < 256 for t in tokens)
    assert "served from the Iceberg view of Hudi-written checkpoints" \
        in r.stdout
