"""The port's gemma2-27b, starcoder2-15b, chameleon-34b and whisper-small
against the reference model, on the same weights.

Each check is one test parametrised over the four archs, at their smoke
configs in fp32; the reference initialises the weights and
``params_from_jax`` carries them across.  Logits and losses agree to 2e-3,
the reference's own decode-consistency tolerance (``tests/test_models.py``).
whisper gets the same frame embeddings on both sides, drawn with numpy
from a seed.  gemma2 runs ``tests/test_models.py``'s window-8 cycle, and
its comparisons with the reference use S = 24 (a multiple of the window):
beyond that the reference's windowed cache layout drops a key (ROADMAP
C-b), so a ragged prompt is held against the port's own teacher forcing.
The MoE archs (dbrx-132b, granite-moe-3b-a800m, jamba-v0.1-52b) join the
config, template and parameter-count tests; ``tests/test_torch_moe.py``
holds their models.

    PYTHONPATH=src python -m pytest -q tests/test_torch_archs.py
"""

from dataclasses import fields, replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models.config import LayerSpec as JaxLayerSpec  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train.loop import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import config as port_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import count_params  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train.loop import make_loss_fn  # noqa: E402

torch.set_num_threads(2)

ARCHS = ("gemma2-27b", "starcoder2-15b", "chameleon-34b", "whisper-small")
CONFIG_ARCHS = ARCHS + ("dbrx-132b", "granite-moe-3b-a800m", "jamba-v0.1-52b")
# full-config parameter counts, the reference's ranges (tests/test_models.py)
PARAM_RANGES = {"gemma2-27b": (24e9, 30e9), "starcoder2-15b": (14e9, 17e9),
                "chameleon-34b": (30e9, 38e9),
                "whisper-small": (0.15e9, 0.35e9),
                "dbrx-132b": (120e9, 142e9),
                "granite-moe-3b-a800m": (2.5e9, 4.5e9),
                "jamba-v0.1-52b": (45e9, 60e9)}
B, S = 2, 24
TOL = 2e-3


def _smoke(arch, get, spec_cls):
    """The fp32 smoke config; gemma2 with a window of 8 (its window of
    4096 would not bite at these lengths)."""
    cfg = replace(get(arch), dtype="float32")
    if arch == "gemma2-27b":
        cfg = replace(cfg, cycle=(spec_cls(kind="attn", window=8),
                                  spec_cls(kind="attn", window=0)))
    return cfg


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax model, jax params, port model, port params) on the same weights."""
    arch = request.param
    jm = JaxModel(_smoke(arch, jax_smoke_config, JaxLayerSpec))
    jp = jax_init_params(jm.param_template(), jax.random.PRNGKey(0))
    tm = Model(_smoke(arch, smoke_config, port_config.LayerSpec),
               device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, s))


def _frames(cfg):
    """(jax kwargs, port kwargs): the same seeded frame embeddings for an
    encoder config, none otherwise."""
    if not cfg.encoder:
        return {}, {}
    e = np.random.default_rng(1).standard_normal(
        (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return {"enc_embeds": jnp.asarray(e)}, {"enc_embeds": torch.from_numpy(e)}


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_forward_logits_match_reference(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(S + 1)
    jkw, tkw = _frames(tm.cfg)
    jl, _ = jm.forward(jp, jnp.asarray(toks), **jkw)
    tl, aux = tm.forward(tp, torch.from_numpy(toks), **tkw)
    assert tl.dtype == torch.float32 and tl.shape == (B, S + 1, 256)
    assert bool(torch.isfinite(tl).all())
    assert _max_err(jl, tl.numpy()) < TOL
    assert float(aux) == 0.0


def test_prefill_and_decode_match_reference(pair):
    """Last-position logits, every cache leaf (positions exactly; keys,
    values and the cross caches within TOL of their scale) and one decode
    step."""
    jm, jp, tm, tp = pair
    toks = _tokens(S + 1)
    jkw, tkw = _frames(tm.cfg)
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks[:, :S]), cache_len=S + 8,
                               **jkw)
    tlast, tcache = tm.prefill(tp, torch.from_numpy(toks[:, :S]),
                               cache_len=S + 8, **tkw)
    assert _max_err(jlast, tlast.numpy()) < TOL
    jl, tl = _leaves(jcache), _leaves(tcache)
    assert sorted(jl) == sorted(tl)
    for path, ja in jl.items():
        ja, ta = np.asarray(ja), tl[path].numpy()
        assert ja.shape == ta.shape, path
        if path.endswith("kpos"):
            np.testing.assert_array_equal(ja, ta, err_msg=path)
        else:
            assert _max_err(ja, ta) < TOL * (1 + np.abs(ja).max()), path
    pos = np.full((B,), S, np.int32)
    jl2, _ = jm.decode_step(jp, jcache, jnp.asarray(toks[:, S]),
                            jnp.asarray(pos))
    tl2, _ = tm.decode_step(tp, tcache, torch.from_numpy(toks[:, S]),
                            torch.from_numpy(pos).long())
    assert _max_err(jl2, tl2.numpy()) < TOL


def test_decode_reproduces_teacher_forcing(pair):
    """Prefill of a ragged 21-token prompt and 5 decode steps against the
    port's own forward pass; gemma2's 8-slot ring wraps on the way."""
    _, _, tm, tp = pair
    s, steps = 21, 5
    toks = torch.from_numpy(_tokens(s + steps, seed=2))
    _, tkw = _frames(tm.cfg)
    full, _ = tm.forward(tp, toks, **tkw)
    last, cache = tm.prefill(tp, toks[:, :s], cache_len=32, **tkw)
    assert float((full[:, s - 1] - last).abs().max()) < TOL
    for t in range(s, s + steps):
        logits, cache = tm.decode_step(tp, cache, toks[:, t],
                                       torch.full((B,), t))
        assert float((full[:, t] - logits).abs().max()) < TOL, t


def test_loss_matches_reference(pair):
    """``make_loss_fn``'s loss (chunked CE + z-loss; whisper with its frame
    embeddings in the batch) against the reference's."""
    jm, jp, tm, tp = pair
    toks = _tokens(S + 1, seed=3)
    jkw, tkw = _frames(tm.cfg)
    jloss, _ = jax_make_loss_fn(jm, ce_chunk=8)(
        jp, {"inputs": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:]), **jkw})
    with torch.no_grad():
        tloss, met = make_loss_fn(tm, ce_chunk=8)(
            tp, {"inputs": torch.from_numpy(toks[:, :-1]),
                 "targets": torch.from_numpy(toks[:, 1:]), **tkw})
    assert abs(float(jloss) - float(tloss)) < TOL
    assert float(met["tokens"]) == B * S


def test_greedy_serving_equals_reference(pair):
    """The engines on a batch of unequal prompts (longest 16: gemma2's
    8-slot ring holds the reference's layout); whisper gets zero frames on
    both sides."""
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 255, n).tolist() for n in (5, 16, 3, 9)]
    news = (6, 4, 6, 2)
    want = JaxServeEngine(jm, jp, cache_len=32).generate(
        [JaxRequest(p, n) for p, n in zip(prompts, news)])
    got = ServeEngine(tm, tp, cache_len=32).generate(
        [Request(p, n) for p, n in zip(prompts, news)])
    assert got == want


def _as_port(v):
    """A reference config object (or a tuple of them) as the port's."""
    for cls in (port_config.LayerSpec, port_config.SSMConfig,
                port_config.EncoderConfig, port_config.ModelConfig):
        if type(v).__name__ == cls.__name__:
            return cls(**{f.name: _as_port(getattr(v, f.name))
                          for f in fields(v)})
    if isinstance(v, tuple):
        return tuple(_as_port(e) for e in v)
    return v


@pytest.mark.parametrize("arch", CONFIG_ARCHS)
def test_configs_equal_reference(arch):
    assert get_config(arch) == _as_port(jax_get_config(arch))
    assert smoke_config(arch) == _as_port(jax_smoke_config(arch))


@pytest.mark.parametrize("arch", CONFIG_ARCHS)
def test_templates_match_reference(arch):
    """Param and cache templates of the full config, leaf by leaf: shape,
    dtype, init and scale (the cache: shape, dtype, init)."""
    jm, tm = JaxModel(jax_get_config(arch)), Model(get_config(arch),
                                                   device="cpu")
    jt, tt = _leaves(jm.param_template()), _leaves(tm.param_template())
    assert sorted(jt) == sorted(tt)
    for path, js in jt.items():
        ts = tt[path]
        assert (ts.shape, ts.dtype, ts.init, ts.scale) == \
            (js.shape, js.dtype, js.init, js.scale), path
    jc, tc = _leaves(jm.cache_template(2, 64)), _leaves(tm.cache_template(2, 64))
    assert {p: (s.shape, s.dtype, s.init) for p, s in jc.items()} == \
        {p: (s.shape, s.dtype, s.init) for p, s in tc.items()}


@pytest.mark.parametrize("arch", CONFIG_ARCHS)
def test_full_config_parameter_count(arch):
    lo, hi = PARAM_RANGES[arch]
    n = count_params(Model(get_config(arch), device="cpu").param_template())
    assert lo <= n <= hi, f"{n:,}"
