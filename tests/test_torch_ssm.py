"""The port's mamba2 (SSM blocks) against the reference model and engine.

The reference initialises the mamba2-2.7b smoke config in fp32;
``params_from_jax`` carries its weights across (fp32 ``dt_bias`` /
``a_log`` / ``skip_d``, ``conv_w`` with its 0.2 init scale).  Logits agree
to 2e-3, the reference's own decode-consistency tolerance
(``tests/test_models.py``); the caches to 1e-4 (fp32, only the order of
the sums differs).
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
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import count_params  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

torch.set_num_threads(2)

ARCH = "mamba2-2.7b"
B, S = 2, 24            # 24 tokens = 1.5 chunks of 16: the pad path
TOL = 2e-3
CACHE_TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) on the same weights."""
    jm = JaxModel(replace(jax_smoke_config(ARCH), dtype="float32"))
    jp = jax_init_params(jm.param_template(), jax.random.PRNGKey(0))
    tm = Model(replace(smoke_config(ARCH), dtype="float32"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(s=S + 2):
    return np.random.default_rng(0).integers(0, 256, (B, s))


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def test_weights_carry_across(pair):
    _, jp, _, tp = pair
    p = tp["blocks"]["s0"]["ssm"]
    for name in ("dt_bias", "a_log", "skip_d", "conv_w"):
        assert p[name].dtype == torch.float32
        np.testing.assert_array_equal(
            p[name].numpy(), np.asarray(jp["blocks"]["s0"]["ssm"][name]))
    assert abs(float(p["conv_w"].std()) - 0.2) < 0.02
    assert float(p["skip_d"].min()) == 1.0


def test_forward_logits_match_reference(pair):
    jm, jp, tm, tp = pair
    toks = _tokens()
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    tl, aux = tm.forward(tp, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tl.shape == (B, S + 2, 256)
    assert _max_err(jl, tl.numpy()) < TOL
    assert float(aux) == 0.0


def test_prefill_and_decode_match_reference(pair):
    jm, jp, tm, tp = pair
    toks = _tokens()
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks[:, :S]))
    tlast, tcache = tm.prefill(tp, torch.from_numpy(toks[:, :S]))
    assert _max_err(jlast, tlast.numpy()) < TOL
    for t in range(S, S + 2):
        pos = np.full((B,), t, np.int32)
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t]),
                                    jnp.asarray(pos))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(toks[:, t]),
                                    torch.from_numpy(pos).long())
        assert _max_err(jl, tl.numpy()) < TOL
    for key in ("conv", "state"):
        want = np.asarray(jcache["s0"][key])
        got = tcache["s0"][key]
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=CACHE_TOL,
                                   rtol=CACHE_TOL)


def test_prefill_decode_reproduce_teacher_forcing(pair):
    _, _, tm, tp = pair
    toks = torch.from_numpy(_tokens(S + 3))
    full, _ = tm.forward(tp, toks)
    last, cache = tm.prefill(tp, toks[:, :S])
    assert float((full[:, S - 1] - last).abs().max()) < TOL
    for t in range(S, S + 3):
        logits, cache = tm.decode_step(tp, cache, toks[:, t],
                                       torch.full((B,), t))
        assert float((full[:, t] - logits).abs().max()) < TOL


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_param_and_cache_templates_match_reference():
    jm, tm = JaxModel(jax_get_config(ARCH)), Model(get_config(ARCH),
                                                   device="cpu")
    jt, tt = _leaves(jm.param_template()), _leaves(tm.param_template())
    assert sorted(jt) == sorted(tt)
    for path, js in jt.items():
        ts = tt[path]
        assert (ts.shape, ts.dtype, ts.init, ts.scale) == \
            (js.shape, js.dtype, js.init, js.scale), path
    jc, tc = _leaves(jm.cache_template(4, 64)), _leaves(tm.cache_template(4, 64))
    assert {p: (s.shape, s.dtype, s.init) for p, s in jc.items()} == \
        {p: (s.shape, s.dtype, s.init) for p, s in tc.items()}
    assert tc["/s0/state"].shape == (64, 4, 80, 128, 64)


def test_full_config_parameter_count():
    n = count_params(Model(get_config(ARCH), device="cpu").param_template())
    assert 2.2e9 <= n <= 3.2e9, f"{n:,}"


PROMPT_LENS = (5, 9, 3, 7)
MAX_NEW = (6, 4, 6, 2)


def test_greedy_tokens_equal_reference_engine():
    jm = JaxModel(replace(jax_smoke_config(ARCH), dtype="float32"))
    jp = jax_init_params(jm.param_template(), jax.random.PRNGKey(1))
    tm = Model(replace(smoke_config(ARCH), dtype="float32"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 255, n).tolist() for n in PROMPT_LENS]
    want = JaxServeEngine(jm, jp, cache_len=32).generate(
        [JaxRequest(p, n) for p, n in zip(prompts, MAX_NEW)])
    got = ServeEngine(tm, tp, cache_len=32).generate(
        [Request(p, n) for p, n in zip(prompts, MAX_NEW)])
    assert got == want
    assert [len(o) for o in got] == list(MAX_NEW)
