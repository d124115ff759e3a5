"""The port's serve engine against the reference engine, on the same
weights and the same batch of unequal prompts."""

from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import init_params  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

torch.set_num_threads(2)

PROMPT_LENS = (5, 9, 3, 7)
MAX_NEW = (6, 4, 6, 2)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 255, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def engines():
    jm = JaxModel(replace(jax_smoke_config("yi-9b"), dtype="float32"))
    jp = jax_init_params(jm.param_template(), jax.random.PRNGKey(1))
    tm = Model(replace(smoke_config("yi-9b"), dtype="float32"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return (JaxServeEngine(jm, jp, cache_len=32),
            ServeEngine(tm, tp, cache_len=32))


def test_greedy_tokens_equal_reference(engines):
    jeng, teng = engines
    prompts = _prompts()
    want = jeng.generate([JaxRequest(p, n) for p, n in zip(prompts, MAX_NEW)])
    got = teng.generate([Request(p, n) for p, n in zip(prompts, MAX_NEW)])
    assert got == want
    assert [len(o) for o in got] == list(MAX_NEW)


def test_temperature_sampling_is_deterministic_per_seed(engines):
    _, teng = engines
    reqs = [Request(p, 5) for p in _prompts()]
    a = teng.generate(reqs, temperature=1.0, seed=7)
    b = teng.generate(reqs, temperature=1.0, seed=7)
    assert a == b
    assert all(0 <= t < 256 for out in a for t in out)
    runs = {str(teng.generate(reqs, temperature=1.0, seed=s))
            for s in range(4)}
    assert len(runs) > 1            # the seed does steer the draws


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = smoke_config("yi-9b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    tpl = Model(cfg, device="cpu").param_template()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(tpl, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"embed": np.zeros((2, 2), np.float32)})


def test_engine_rejects_params_on_another_device(engines):
    _, teng = engines
    moved = dict(teng.params, embed=teng.params["embed"].to("meta"))
    with pytest.raises(ValueError, match="params are on"):
        ServeEngine(teng.model, moved)
