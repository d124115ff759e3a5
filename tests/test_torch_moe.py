"""The port's MoE MLP and its three archs (dbrx-132b, granite-moe-3b-a800m,
jamba-v0.1-52b) against the reference, on the same weights and inputs.

Inputs come from numpy seeds; the reference initialises the weights and
``params_from_jax`` carries them across.  Routing is held exactly: the
dispatch's slots, the chosen experts and the dropped (token, choice)
pairs are equal index for index.  Numbers are held at the tolerances
stated in each test: fp32 outputs to 2e-5 (a layer) or 2e-3 (a model,
the reference's decode-consistency tolerance, ``tests/test_models.py``),
bf16 to 2e-2 of the output's scale, gradients as ``test_torch_train.py``
holds yi-9b's (2e-4 + 2e-3 relative).

    PYTHONPATH=src python -m pytest -q tests/test_torch_moe.py
"""

from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train.loop import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch.checkpoint import leaf_paths  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import tree_map  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train.loop import make_loss_fn  # noqa: E402

torch.set_num_threads(2)

MOE_ARCHS = ("dbrx-132b", "granite-moe-3b-a800m", "jamba-v0.1-52b")
B, S = 2, 24
TOL = 2e-3


def _np(t):
    return t.detach().float().numpy()


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# ------------------------------------------------------------- dispatch
DISPATCH_CASES = [      # (tokens x choices, experts, capacity, draw)
    (48, 4, 8, "uniform"),       # over-full experts drop
    (48, 4, 16, "uniform"),      # 12 a expert on average: nothing drops
    (40, 8, 8, "skewed"),        # most entries on experts 0 and 1
    (32, 4, 8, "one"),           # every entry on one expert
    (16, 8, 16, "uniform"),      # C = S*k
    (2, 4, 2, "uniform"),        # one token, two choices (decode)
]


@pytest.mark.parametrize("nk,E,C,draw", DISPATCH_CASES)
def test_dispatch_one_equals_reference(nk, E, C, draw):
    """``gather_tok`` and ``inv`` equal the reference's, index for index,
    for random expert ids with ties and over-full experts; a batch of rows
    dispatches each row as the reference dispatches it alone."""
    rng = np.random.default_rng(nk * 31 + E)
    rows = []
    for r in range(3):
        if draw == "uniform":
            eid = rng.integers(0, E, nk)
        elif draw == "skewed":
            eid = np.minimum(rng.geometric(0.6, nk) - 1, E - 1)
        else:
            eid = np.full(nk, r % E)
        rows.append(eid)
    eids = np.stack(rows)
    got_tok, got_inv = L._dispatch_one(torch.from_numpy(eids), E, C)
    for r, eid in enumerate(eids):
        want_tok, want_inv = JL._dispatch_one(jnp.asarray(eid, jnp.int32),
                                              E, C)
        np.testing.assert_array_equal(got_tok[r].numpy(), np.asarray(want_tok))
        np.testing.assert_array_equal(got_inv[r].numpy(), np.asarray(want_inv))


# -------------------------------------------------------------- moe_mlp
def _layer_pair(dtype, cf, seed=0):
    """(reference cfg, its params, port cfg, port params) of granite's smoke
    MoE layer (8 experts, top 2, gated SiLU) at ``dtype`` and ``cf``."""
    jcfg = replace(jax_smoke_config("granite-moe-3b-a800m"), dtype=dtype,
                   capacity_factor=cf)
    tcfg = replace(smoke_config("granite-moe-3b-a800m"), dtype=dtype,
                   capacity_factor=cf)
    jp = jax_init_params(JL.moe_template(jcfg), jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _jax_dropped(x, jp, jcfg):
    """The reference's dropped (token, choice) mask of ``moe_mlp``'s
    routing, (G, S*k)."""
    G, S_, _ = x.shape
    E, k = jcfg.n_experts, jcfg.top_k
    C = min(JL._round_up(max(1, int(np.ceil(S_ * k / E * jcfg.capacity_factor
                                            ))), 8), S_ * k)
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", x.astype(jnp.float32),
                                      jp["router"]), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    _, inv = jax.vmap(lambda e: JL._dispatch_one(e, E, C))(
        top_e.reshape(G, S_ * k))
    return np.asarray(inv) == E * C, np.asarray(top_e)


MOE_CASES = [           # (dtype, capacity factor, tokens, tolerance)
    ("float32", 8.0, 24, 2e-5),      # nothing drops
    ("float32", 0.25, 24, 2e-5),     # most choices drop
    ("bfloat16", 1.25, 24, 2e-2),
    ("float32", 1.25, 1, 2e-5),      # one token: C = k, nothing drops
]


@pytest.mark.parametrize("dtype,cf,s,tol", MOE_CASES)
def test_moe_mlp_matches_reference(dtype, cf, s, tol):
    """Output and aux loss of one MoE layer against the reference's; the
    chosen experts, in order, and the dropped (token, choice) pairs equal.
    Tolerance: ``tol`` of the output's scale (fp32 2e-5, bf16 2e-2), the
    aux loss to 1e-5 relative."""
    jcfg, jp, tcfg, tp = _layer_pair(dtype, cf)
    x = np.random.default_rng(7).standard_normal((B, s, tcfg.d_model)) \
        .astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jy, jaux = JL.moe_mlp(jx, jp, jcfg)
    ty, taux = L.moe_mlp(tx, tp, tcfg)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    scale = float(np.abs(np.asarray(jy, np.float32)).max())
    assert _max_err(jy, _np(ty)) <= tol * max(1.0, scale)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)

    want_drop, want_e = _jax_dropped(jx, jp, jcfg)
    _, _, _, top_e = L.route(tx, tp["router"], tcfg.top_k)
    C = L.capacity(tcfg, s)
    _, inv = L._dispatch_one(top_e.reshape(B, -1), tcfg.n_experts, C)
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    np.testing.assert_array_equal(inv.numpy() == tcfg.n_experts * C,
                                  want_drop)
    if cf == 0.25:
        assert want_drop.any()
    if cf == 8.0 or s == 1:
        assert not want_drop.any()



def test_moe_combine_on_a_one_rank_dtensor_mesh(tmp_path, monkeypatch):
    """The DTensor branch of ``moe_mlp``'s combine (the product and sum
    over k; DTensor's einsum fails at granite's prefill_32k): on a
    one-rank gloo mesh its output equals, bit for bit, the same sum taken
    on plain tensors, and is within fp32 rounding (1e-6 of the output's
    scale) of the einsum plain tensors keep."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from repro_torch.parallel import Sharder

    _jcfg, _jp, tcfg, tp = _layer_pair("float32", 1.25)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32))
    y_einsum, aux = L.moe_mlp(x, tp, tcfg)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        rep = [Replicate()]
        dx = distribute_tensor(x, mesh, rep)
        dp = {k: distribute_tensor(v, mesh, rep) for k, v in tp.items()}
        sh = Sharder.for_mesh(mesh)
        with sh.region():
            dy, daux = L.moe_mlp(dx, dp, tcfg, sh=sh)
        assert isinstance(dy, DTensor)
        y_dtensor, aux_dtensor = dy.full_tensor(), daux.full_tensor()
    finally:
        dist.destroy_process_group()
    # plain tensors through the DTensor branch: the same order of sums
    monkeypatch.setattr(L, "DTensor", torch.Tensor)
    y_sum, _ = L.moe_mlp(x, tp, tcfg)
    assert torch.equal(y_dtensor, y_sum)
    assert torch.equal(aux_dtensor, aux)
    scale = float(y_einsum.abs().max())
    assert float((y_dtensor - y_einsum).abs().max()) <= 1e-6 * scale

def test_route_breaks_ties_toward_the_lower_expert():
    """Equal probabilities: the choices come in descending order, ties to
    the lower expert id, as ``jax.lax.top_k`` gives them."""
    logits = np.array([[[0.0, 1.0, 1.0, 0.0, 1.0, 2.0]]], np.float32)
    eye = np.eye(6, dtype=np.float32)
    _, _, tw, te = L.route(torch.from_numpy(logits), torch.from_numpy(eye), 4)
    jw, je = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), 4)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(te.numpy(), [[[5, 1, 2, 4]]])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)


# -------------------------------------------------------------- models
def _pair(arch, **kw):
    """(jax model, jax params, port model, port params): the fp32 smoke
    config (with ``kw``) on the same weights."""
    jm = JaxModel(replace(jax_smoke_config(arch), dtype="float32", **kw))
    jp = jax_init_params(jm.param_template(), jax.random.PRNGKey(0))
    tm = Model(replace(smoke_config(arch), dtype="float32", **kw),
               device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request):
    return _pair(request.param)


def _tokens(s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, s))


def test_forward_logits_and_aux_match_reference(pair):
    """The shipped capacity factor (1.25): the smoke configs' over-full
    experts drop on both sides alike.  Logits to 2e-3, aux to 1e-5
    relative."""
    jm, jp, tm, tp = pair
    toks = _tokens(S + 1)
    jl, jaux = jm.forward(jp, jnp.asarray(toks))
    tl, taux = tm.forward(tp, torch.from_numpy(toks))
    assert tl.shape == (B, S + 1, 256) and bool(torch.isfinite(tl).all())
    assert _max_err(jl, tl.numpy()) < TOL
    assert float(taux) > 0.0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_prefill_and_decode_match_reference(pair):
    """Last-position logits, every cache leaf (positions exactly, the rest
    within 2e-3 of its scale) and one decode step (2e-3)."""
    jm, jp, tm, tp = pair
    toks = _tokens(S + 1, seed=1)
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks[:, :S]), cache_len=S + 8)
    tlast, tcache = tm.prefill(tp, torch.from_numpy(toks[:, :S]),
                               cache_len=S + 8)
    assert _max_err(jlast, tlast.numpy()) < TOL
    jl, tl = _leaves(jcache), _leaves(tcache)
    assert sorted(jl) == sorted(tl)
    for path, ja in jl.items():
        ja, ta = np.asarray(ja), tl[path].numpy()
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_reproduces_teacher_forcing(arch):
    """At capacity factor 8.0 nothing drops (``tests/test_models.py``'s
    setting): a ragged 21-token prefill and 5 decode steps against the
    port's forward pass and the reference's, at 2e-3."""
    jm, jp, tm, tp = _pair(arch, capacity_factor=8.0)
    s, steps = 21, 5
    toks = _tokens(s + steps, seed=2)
    jfull, _ = jm.forward(jp, jnp.asarray(toks))
    full, _ = tm.forward(tp, torch.from_numpy(toks))
    assert _max_err(jfull, full.numpy()) < TOL
    last, cache = tm.prefill(tp, torch.from_numpy(toks[:, :s]), cache_len=32)
    assert float((full[:, s - 1] - last).abs().max()) < TOL
    for t in range(s, s + steps):
        logits, cache = tm.decode_step(tp, cache,
                                       torch.from_numpy(toks[:, t]),
                                       torch.full((B,), t))
        assert float((full[:, t] - logits).abs().max()) < TOL, t


def test_granite_served_tokens_equal_reference_engine():
    """Both engines on a batch of unequal prompts (left-padded: the pads
    take expert capacity on both sides, ROADMAP C-d)."""
    jm, jp, tm, tp = _pair("granite-moe-3b-a800m")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 255, n).tolist() for n in (5, 16, 3, 9)]
    news = (6, 4, 6, 2)
    want = JaxServeEngine(jm, jp, cache_len=32).generate(
        [JaxRequest(p, n) for p, n in zip(prompts, news)])
    got = ServeEngine(tm, tp, cache_len=32).generate(
        [Request(p, n) for p, n in zip(prompts, news)])
    assert got == want


@pytest.mark.parametrize("remat", ("none", "block"))
def test_granite_loss_and_every_gradient_match_reference(remat):
    """``make_loss_fn``'s loss (chunked CE, z-loss and the MoE aux loss)
    and every parameter's gradient against ``jax.value_and_grad`` of the
    reference's, at 2e-4 + 2e-3 relative; with ``remat="block"`` the
    checkpointed cycles carry the aux loss through their backward."""
    jm, jp, tm, tp = _pair("granite-moe-3b-a800m", remat=remat)
    toks = _tokens(S + 1, seed=3)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    (jl, jmet), jg = jax.value_and_grad(jax_make_loss_fn(jm, ce_chunk=8),
                                        has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    live = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tl, tmet = make_loss_fn(tm, ce_chunk=8)(
        live, {k: torch.from_numpy(v) for k, v in batch.items()})
    tl.backward()
    assert float(tmet["aux"].detach()) > 0.0
    for got, want in ((tl, jl), (tmet["aux"], jmet["aux"]),
                      (tmet["ce"], jmet["ce"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   atol=2e-4, rtol=2e-3)
    want = dict(leaf_paths(jax.tree.map(np.asarray, jg)))
    got = dict(leaf_paths(tree_map(lambda t: t.grad, live)))
    assert sorted(got) == sorted(want)
    assert any("router" in name for name in got)
    for name, w in want.items():
        np.testing.assert_allclose(_np(got[name]), w, atol=2e-4, rtol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_templates_and_carried_leaves_match_reference(arch):
    """Param and cache templates of the smoke config equal the reference's
    leaf for leaf, and ``params_from_jax`` carries every MoE leaf (the fp32
    router, the bf16 expert weights) bit for bit."""
    jm = JaxModel(jax_smoke_config(arch))
    tm = Model(smoke_config(arch), device="cpu")
    jt, tt = _leaves(jm.param_template()), _leaves(tm.param_template())
    assert sorted(jt) == sorted(tt)
    for path, js in jt.items():
        ts = tt[path]
        assert (ts.shape, ts.dtype, ts.init, ts.scale, ts.axes) == \
            (js.shape, js.dtype, js.init, js.scale, js.axes), path
    jc, tc = _leaves(jm.cache_template(2, 64)), _leaves(tm.cache_template(2, 64))
    assert {p: (s.shape, s.dtype, s.init) for p, s in jc.items()} == \
        {p: (s.shape, s.dtype, s.init) for p, s in tc.items()}
    jp = jax_init_params(jm.param_template(), jax.random.PRNGKey(1))
    tp = _leaves(params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    moe = {p: a for p, a in _leaves(jp).items()
           if p.rsplit("/", 1)[-1] in ("router", "w_in", "w_gate", "w_out")
           and "/mlp/" in p}
    assert any(p.endswith("router") for p in moe)
    for path, ja in moe.items():
        ja = np.asarray(ja)
        t = tp[path]
        assert str(t.dtype) == f"torch.{ja.dtype.name}", path
        if ja.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          ja.view(np.int16), err_msg=path)
        else:
            np.testing.assert_array_equal(t.numpy(), ja, err_msg=path)
