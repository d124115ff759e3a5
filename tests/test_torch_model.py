"""The port's yi-9b against the reference model, on the same weights.

The reference initialises the smoke config (fp32); ``params_from_jax``
carries its weights across.  Logits agree to 2e-3, the reference's own
decode-consistency tolerance (``tests/test_models.py``).
"""

from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models.config import LayerSpec  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import count_params, init_params  # noqa: E402

torch.set_num_threads(2)

B, S = 2, 24
TOL = 2e-3


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) on the same weights."""
    jm = JaxModel(replace(jax_smoke_config("yi-9b"), dtype="float32"))
    jp = jax_init_params(jm.param_template(), jax.random.PRNGKey(0))
    tm = Model(replace(smoke_config("yi-9b"), dtype="float32"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(s=S + 1):
    return np.random.default_rng(0).integers(0, 256, (B, s))


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def test_forward_logits_match_reference(pair):
    jm, jp, tm, tp = pair
    toks = _tokens()
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    tl, aux = tm.forward(tp, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tl.shape == (B, S + 1, 256)
    assert _max_err(jl, tl.numpy()) < TOL
    assert float(aux) == 0.0


def test_prefill_and_decode_match_reference(pair):
    jm, jp, tm, tp = pair
    toks = _tokens()
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks[:, :S]), cache_len=S + 8)
    tlast, tcache = tm.prefill(tp, torch.from_numpy(toks[:, :S]),
                               cache_len=S + 8)
    assert _max_err(jlast, tlast.numpy()) < TOL
    # the ring-order cache equals the reference's while the prompt fits
    np.testing.assert_array_equal(np.asarray(jcache["s0"]["kpos"]),
                                  tcache["s0"]["kpos"].numpy())
    pos = np.full((B,), S, np.int32)
    jl2, _ = jm.decode_step(jp, jcache, jnp.asarray(toks[:, S]),
                            jnp.asarray(pos))
    tl2, _ = tm.decode_step(tp, tcache, torch.from_numpy(toks[:, S]),
                            torch.from_numpy(pos).long())
    assert _max_err(jl2, tl2.numpy()) < TOL


def test_prefill_decode_reproduce_teacher_forcing(pair):
    _, _, tm, tp = pair
    toks = torch.from_numpy(_tokens(S + 3))
    full, _ = tm.forward(tp, toks)
    last, cache = tm.prefill(tp, toks[:, :S], cache_len=S + 8)
    assert float((full[:, S - 1] - last).abs().max()) < TOL
    for t in range(S, S + 3):
        logits, cache = tm.decode_step(tp, cache, toks[:, t],
                                       torch.full((B,), t))
        assert float((full[:, t] - logits).abs().max()) < TOL


def test_ring_cache_wraps_with_a_window():
    """A windowed layer keeps the last `window` positions, slot = pos % sc,
    so decode still reproduces teacher forcing on ragged prompt lengths
    (the reference's layout drops a key there, ROADMAP C-b)."""
    cfg = replace(smoke_config("yi-9b"), dtype="float32",
                  cycle=(LayerSpec(kind="attn", window=8),
                         LayerSpec(kind="attn")))
    tm = Model(cfg, device="cpu")
    tp = init_params(tm.param_template(), torch.Generator().manual_seed(0),
                     device="cpu")
    toks = torch.from_numpy(_tokens(27))
    full, _ = tm.forward(tp, toks)
    _, cache = tm.prefill(tp, toks[:, :25], cache_len=32)
    logits, _ = tm.decode_step(tp, cache, toks[:, 25], torch.full((B,), 25))
    assert float((full[:, 25] - logits).abs().max()) < TOL


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_param_template_matches_reference():
    jt = _leaves(JaxModel(jax_get_config("yi-9b")).param_template())
    tt = _leaves(Model(get_config("yi-9b"), device="cpu").param_template())
    assert sorted(jt) == sorted(tt)
    for path, js in jt.items():
        ts = tt[path]
        assert (ts.shape, ts.dtype, ts.init, ts.scale) == \
            (js.shape, js.dtype, js.init, js.scale), path
    jc = _leaves(JaxModel(jax_get_config("yi-9b")).cache_template(2, 64))
    tc = _leaves(Model(get_config("yi-9b"), device="cpu").cache_template(2, 64))
    assert {p: (s.shape, s.dtype, s.init) for p, s in jc.items()} == \
        {p: (s.shape, s.dtype, s.init) for p, s in tc.items()}


def test_full_config_parameter_count():
    n = count_params(Model(get_config("yi-9b"), device="cpu").param_template())
    assert 8e9 <= n <= 10e9, f"{n:,}"


def test_init_params_kinds_and_device():
    tm = Model(smoke_config("yi-9b"), device="cpu")
    p = init_params(tm.param_template(), torch.Generator().manual_seed(1),
                    device="cpu")
    assert p["blocks"]["s0"]["attn"]["wq"].dtype == torch.bfloat16
    assert p["blocks"]["s0"]["attn"]["wq"].shape == (2, 64, 4, 16)
    assert torch.count_nonzero(p["final_norm"]["scale"]) == 0
    cache = tm._new_cache(2, 16)
    assert bool((cache["s0"]["kpos"] == -1).all())
    assert abs(float(p["embed"].float().std()) - 0.02) < 0.005
