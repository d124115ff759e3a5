"""The port's training half against the reference, on the CPU.

Inputs are made with numpy from a seed; weights go across through
``params_from_jax``.  Tolerances: the optimizer and the schedule 1e-6
(fp32, the same arithmetic); the loss and every gradient of the train step
2e-4 atol / 2e-3 rtol, as the reference's own grad-accumulation test
(``tests/test_train_and_sharding.py``), since the attention and the sums
run in another order; the attention gradients 3e-5 (fp32) and 2e-2 (bf16),
the kernel tolerances.
"""

from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import _leaf_paths as jax_leaf_paths  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.param import init_params as jax_init_params  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.train.loop import chunked_cross_entropy as jax_chunked_ce  # noqa: E402
from repro.train.loop import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.train.loop import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.loop import \
    train_state_template as jax_train_state_template  # noqa: E402
from repro_torch.checkpoint import leaf_paths  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_ref)
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.param import (ParamSpec, init_params,  # noqa: E402
                                      tree_map)
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, warmup_cosine)
from repro_torch.optim.adamw import _global_norm, compress_int8  # noqa: E402
from repro_torch.train import (chunked_cross_entropy,  # noqa: E402
                               make_loss_fn, make_train_step,
                               train_state_template)

torch.set_num_threads(2)

ATOL, RTOL = 2e-4, 2e-3


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ------------------------------------------------------------------ loss
CE_CASES = [  # b, s, d, v, chunk, softcap, padded
    (2, 32, 16, 50, 8, 0.0, False),
    (2, 30, 16, 50, 8, 0.0, True),       # 8 does not divide 30: chunk 6
    (1, 24, 8, 37, 24, 30.0, True),      # final softcap, one chunk
]


@pytest.mark.parametrize("b,s,d,v,chunk,cap,padded", CE_CASES)
def test_chunked_ce_matches_reference(b, s, d, v, chunk, cap, padded):
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.1).astype(np.float32)
    targets = rng.integers(0, v, (b, s)).astype(np.int32)
    if padded:
        targets[:, ::3] = -1
    want = jax_chunked_ce(jnp.asarray(hidden), jnp.asarray(w),
                          jnp.asarray(targets), final_softcap=cap,
                          chunk=chunk)
    got = chunked_cross_entropy(torch.from_numpy(hidden), torch.from_numpy(w),
                                torch.from_numpy(targets), final_softcap=cap,
                                chunk=chunk)
    for a, g in zip(want, got):
        np.testing.assert_allclose(_np(g), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    # the CE against the direct formula over the whole (b, s, V) logits
    logits = torch.from_numpy(hidden) @ torch.from_numpy(w)
    if cap:
        logits = torch.tanh(logits / cap) * cap
    t = torch.from_numpy(targets).long()
    direct = torch.nn.functional.cross_entropy(
        logits.reshape(-1, v), t.reshape(-1), ignore_index=-1)
    assert abs(float(got[1]) - float(direct)) < 1e-5
    assert int(got[2]) == int((targets >= 0).sum())


def test_chunked_ce_ignores_padding():
    rng = np.random.default_rng(1)
    hidden = torch.from_numpy(rng.standard_normal((1, 8, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 11)).astype(np.float32))
    targets = torch.tensor([[1, 2, -1, -1, 3, -1, 4, 5]])
    _, _, n = chunked_cross_entropy(hidden, w, targets, chunk=4)
    assert int(n) == 5


def test_chunked_ce_gradient_recomputes_each_chunk():
    """With grad on, each chunk is a checkpoint: the gradients equal those
    of the plain formula, and the head weight's gradient sums over chunks."""
    rng = np.random.default_rng(2)
    h0 = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((8, 13)).astype(np.float32))
    t = torch.from_numpy(rng.integers(-1, 13, (2, 16)))
    grads = []
    for chunk in (4, 16):
        h, w = h0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        loss, _, _ = chunked_cross_entropy(h, w, t, chunk=chunk)
        loss.backward()
        grads.append((h.grad, w.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------- optimizer
def _opt_tree(rng):
    return {"w": rng.standard_normal((4, 5)).astype(np.float32),
            "blk": {"b": rng.standard_normal((7,)).astype(np.float32),
                    "a": rng.standard_normal((3, 2)).astype(np.float32)}}


@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (100.0, 0.0), (0.05, 0.3)])
def test_adamw_steps_match_reference(clip, wd):
    """N steps on the same gradients: params and every state leaf within
    1e-6 (fp32)."""
    rng = np.random.default_rng(3)
    p0 = _opt_tree(rng)
    jcfg = JaxAdamWConfig(peak_lr=1e-2, warmup_steps=3, total_steps=20,
                          grad_clip=clip, weight_decay=wd)
    tcfg = AdamWConfig(peak_lr=1e-2, warmup_steps=3, total_steps=20,
                       grad_clip=clip, weight_decay=wd)
    jp = jax.tree.map(jnp.asarray, p0)
    jopt = jax_adamw_init(jp)
    tp = tree_map(torch.from_numpy, jax.tree.map(np.copy, p0))
    topt = adamw_init(tp)
    for _ in range(6):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape)
                         .astype(np.float32), p0)
        jp, jopt, jm = jax_adamw_update(jp, jax.tree.map(jnp.asarray, g),
                                        jopt, jcfg)
        tp, topt, tm = adamw_update(tp, tree_map(torch.from_numpy, g), topt,
                                    tcfg)
        np.testing.assert_allclose(_np(tm["grad_norm"]),
                                   np.asarray(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(_np(tm["lr"]), np.asarray(jm["lr"]),
                                   rtol=1e-6)
    assert int(topt["step"]) == int(jopt["step"]) == 6
    assert topt["step"].dtype == torch.int32
    want = dict(jax_leaf_paths({"params": jp, "opt": jopt}))
    got = dict(leaf_paths({"params": tp, "opt": topt}))
    assert sorted(want) == sorted(got)
    for name, a in want.items():
        np.testing.assert_allclose(_np(got[name]), np.asarray(a, np.float32),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_adamw_keeps_param_dtype_and_leaves_the_init_params_alone():
    gen = torch.Generator().manual_seed(0)
    p32 = {"w": torch.randn(4, 3, generator=gen)}
    p16 = {"w": p32["w"].to(torch.bfloat16)}
    for params in (p32, p16):
        before = params["w"].clone()
        opt = adamw_init(params)
        assert opt["master"]["w"].dtype == torch.float32
        assert opt["master"]["w"].data_ptr() != params["w"].data_ptr()
        opt["master"]["w"].add_(1.0)
        assert torch.equal(params["w"], before)
        params, opt, _ = adamw_update(params, {"w": torch.ones_like(
            params["w"])}, opt, AdamWConfig(warmup_steps=0))
        assert params["w"].dtype == before.dtype
        assert torch.equal(params["w"], opt["master"]["w"].to(before.dtype))


def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    cfg = AdamWConfig(peak_lr=0.5, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    for _ in range(60):
        params, opt, _ = adamw_update(params, {"w": 2 * params["w"]}, opt,
                                      cfg)
    assert float(params["w"].abs().max()) < 0.5


@pytest.mark.parametrize("step", [0, 1, 3, 4, 10, 55, 100, 150])
def test_warmup_cosine_matches_reference(step):
    kw = dict(peak_lr=3e-4, warmup_steps=4, total_steps=100)
    got = warmup_cosine(step, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jax_warmup_cosine(step, **kw)),
                               rtol=1e-6)
    got = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    np.testing.assert_allclose(float(got), float(jax_warmup_cosine(step, **kw)),
                               rtol=1e-6)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(4)
    tree = _opt_tree(rng)
    from repro.optim.adamw import _global_norm as jax_global_norm
    np.testing.assert_allclose(
        float(_global_norm(tree_map(torch.from_numpy, tree))),
        float(jax_global_norm(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_grad_compression_error_bound(seed):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.standard_normal(1024) * 0.1).astype(np.float32))
    q = compress_int8(g, torch.Generator().manual_seed(seed))
    # bounded quantization error: at most one step of the scale
    assert float((q - g).abs().max()) <= float(g.abs().max()) / 127 + 1e-6
    # the noise comes from the generator: same seed, same result
    assert torch.equal(q, compress_int8(g, torch.Generator().manual_seed(seed)))


# -------------------------------------------------------------- attention
BWD_SHAPES = [  # b, sq, sk, h, kv, dh, causal, window, softcap
    (2, 64, 64, 4, 2, 16, True, 0, 0.0),
    (1, 48, 48, 4, 4, 32, True, 16, 20.0),
    (2, 32, 40, 8, 2, 16, False, 0, 0.0),
    (1, 40, 40, 8, 1, 16, True, 0, 0.0),
]


def _qkv_do(rng, b, sq, sk, h, kv, dh):
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh),
             (b, sq, h, dh))]


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,window,softcap", BWD_SHAPES)
def test_attention_bwd_ref_matches_reference_grad(b, sq, sk, h, kv, dh,
                                                  causal, window, softcap):
    """The plain backward against jax.vjp of the reference oracle, and of
    the reference's ``blocked_attention`` (what the reference trains
    through) where its masks agree (sq == sk)."""
    rng = np.random.default_rng(5)
    q, k, v, do = _qkv_do(rng, b, sq, sk, h, kv, dh)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v, do)),
                            **kw)
    refs = [lambda q_, k_, v_: jax_attention_ref(q_, k_, v_, **kw)]
    if sq == sk:
        refs.append(lambda q_, k_, v_: jax_layers.blocked_attention(
            q_, k_, v_, causal=causal, window=window, cap=softcap,
            q_blocks=4))
    for fn in refs:
        def grads(q_, k_, v_, do_, fn=fn):
            return jax.vjp(fn, q_, k_, v_)[1](do_)
        for g, w in zip(got, jax.jit(grads)(*map(jnp.asarray, (q, k, v, do)))):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=3e-5,
                                       rtol=3e-5)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_flash_attention_fn_refuses_cpu_tensors(dtype):
    """``FlashAttentionFn`` is the kernels' gradient and nothing else: on
    CPU tensors it raises before any launch (``flash_attention`` there
    returns the plain forward, which autograd differentiates)."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               .requires_grad_(True)
               for a in _qkv_do(rng, 1, 24, 24, 4, 2, 64)[:3])
    before = flash_ops.flash_attention.launches
    with pytest.raises(ValueError, match="q is not on"):
        flash_ops.FlashAttentionFn.apply(q, k, v, True, 8, 10.0)
    assert flash_ops.flash_attention.launches == before


def test_flash_attention_bwd_on_cpu_takes_the_plain_version():
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(a) for a in _qkv_do(rng, 1, 16, 16, 2,
                                                         1, 16))
    before = flash_ops.flash_attention_bwd.launches
    got = flash_ops.flash_attention_bwd(q, k, v, None, do, None, causal=True)
    assert flash_ops.flash_attention_bwd.launches == before
    for g, w in zip(got, attention_bwd_ref(q, k, v, do, causal=True)):
        assert torch.equal(g, w)


# ----------------------------------------------------------- grad guards
def _meta(*shape, grad=True, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype, requires_grad=grad)


def test_decode_kernel_wrapper_refuses_inputs_that_need_grad():
    """A tensor off the CPU with requires_grad under grad mode raises before
    any launch (a meta tensor stands in for a CUDA one); under no_grad the
    guard lets it through to the device checks."""
    q, k, v = _meta(2, 4, 64), _meta(2, 32, 2, 64), _meta(2, 32, 2, 64)
    lengths = torch.empty(2, device="meta", dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_ops.decode_attention(q, k, v, lengths)
    with torch.no_grad(), pytest.raises(ValueError, match="not on"):
        decode_ops.decode_attention(q, k, v, lengths)


def test_ssd_kernel_wrapper_refuses_inputs_that_need_grad():
    """Since the SSD backward kernels the wrapper refuses no gradient: a
    grad-enabled call off the CPU (a meta tensor stands in for a CUDA one)
    dispatches to ``SSDChunkScanFn`` (the cost counter stands in for the
    launches), under no_grad straight to the operator; without the counter
    the operator's one implementation refuses any device but CUDA."""
    from repro_torch.launch.cost import CostCounter

    b, s, h, p, g, n = 1, 64, 2, 16, 1, 16
    x = _meta(b, s, h, p)
    dt, A = _meta(b, s, h, grad=False), _meta(h, grad=False)
    B, C = _meta(b, s, g, n, grad=False), _meta(b, s, g, n, grad=False)
    with CostCounter():
        y, state = ssd_ops.ssd_chunk_scan(x, dt, A, B, C, chunk=32)
        assert type(y.grad_fn).__name__ == "SSDChunkScanFnBackward"
        with torch.no_grad():
            y, _ = ssd_ops.ssd_chunk_scan(x, dt, A, B, C, chunk=32)
        assert y.grad_fn is None
    with pytest.raises(ValueError, match="not on"):
        ssd_ops.ssd_chunk_scan(x.detach(), dt, A, B, C.requires_grad_(True),
                               chunk=32)


# ------------------------------------------------------------ train step
@pytest.fixture(scope="module")
def yi_pair():
    """The reference's fp32 yi-9b smoke params and the port's copy."""
    jm = JaxModel(replace(jax_smoke_config("yi-9b"), dtype="float32"))
    jp = jax_init_params(jm.param_template(), jax.random.PRNGKey(0))
    tm = Model(replace(smoke_config("yi-9b"), dtype="float32"), device="cpu")
    return jm, jp, tm


def _batch(rng, b=4, s=16, vocab=256):
    inputs = rng.integers(0, vocab, (b, s)).astype(np.int32)
    targets = rng.integers(0, vocab, (b, s)).astype(np.int32)
    targets[0, :3] = -1
    return inputs, targets


def _port_params(jp):
    return params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _assert_trees_close(got, want, atol=ATOL, rtol=RTOL):
    want = dict(jax_leaf_paths(want))
    got = dict(leaf_paths(got))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(_np(got[name]), np.asarray(w, np.float32),
                                   atol=atol, rtol=rtol, err_msg=name)


def test_loss_and_every_gradient_match_reference(yi_pair):
    jm, jp, tm = yi_pair
    inputs, targets = _batch(np.random.default_rng(8))
    jloss_fn = jax_make_loss_fn(jm, ce_chunk=8)
    (jl, jaux), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        jp, {"inputs": jnp.asarray(inputs), "targets": jnp.asarray(targets)})
    tp = {k: v for k, v in _port_params(jp).items()}
    live = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tl, taux = make_loss_fn(tm, ce_chunk=8)(
        live, {"inputs": torch.from_numpy(inputs),
               "targets": torch.from_numpy(targets)})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(taux["ce"].detach()), float(jaux["ce"]),
                               atol=ATOL, rtol=RTOL)
    assert int(taux["tokens"]) == int(jaux["tokens"]) == 4 * 16 - 3
    _assert_trees_close(tree_map(lambda t: t.grad, live), jg)


def test_params_after_one_train_step_match_reference(yi_pair):
    jm, jp, tm = yi_pair
    inputs, targets = _batch(np.random.default_rng(9))
    cfg = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jm, JaxAdamWConfig(**cfg),
                                        ce_chunk=8))
    jp1, jopt1, jmet = jstep(jp, jax_adamw_init(jp),
                             {"inputs": jnp.asarray(inputs),
                              "targets": jnp.asarray(targets)})
    tp = _port_params(jp)
    tstep = make_train_step(tm, AdamWConfig(**cfg), ce_chunk=8)
    tp1, topt1, tmet = tstep(tp, adamw_init(tp),
                             {"inputs": torch.from_numpy(inputs),
                              "targets": torch.from_numpy(targets)})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), atol=ATOL, rtol=RTOL)
    _assert_trees_close({"params": tp1, "opt": topt1},
                        {"params": jp1, "opt": jopt1})


@pytest.mark.parametrize("arch", ("stablelm-3b", "yi-9b"))
def test_grad_accum_matches_full_batch(arch):
    cfg = replace(smoke_config(arch), dtype="float32")
    model = Model(cfg, device="cpu")
    params = init_params(model.param_template(),
                         torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(10)
    batch = {k: torch.from_numpy(a) for k, a in
             zip(("inputs", "targets"), _batch(rng, 4, 16, cfg.vocab_size))}
    batch["targets"][0, :3] = 0          # equal token counts per microbatch
    out = []
    for accum in (1, 2):
        p = tree_map(torch.clone, params)
        p, _, met = make_train_step(model, AdamWConfig(), grad_accum=accum,
                                    ce_chunk=16)(p, adamw_init(p), batch)
        out.append((p, met))
    np.testing.assert_allclose(float(out[0][1]["loss"]),
                               float(out[1][1]["loss"]), rtol=1e-5)
    for (name, a), (_, b) in zip(leaf_paths(out[0][0]), leaf_paths(out[1][0])):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-4, rtol=2e-3,
                                   err_msg=name)


def test_remat_gives_the_same_gradients(yi_pair):
    """Per-cycle checkpointing changes what is saved, not the values."""
    _, jp, tm = yi_pair
    tm_remat = Model(replace(tm.cfg, remat="block"), device="cpu")
    inputs, targets = _batch(np.random.default_rng(11))
    batch = {"inputs": torch.from_numpy(inputs),
             "targets": torch.from_numpy(targets)}
    grads = []
    for model in (tm, tm_remat):
        live = tree_map(lambda t: t.clone().requires_grad_(True),
                        _port_params(jp))
        loss, _ = make_loss_fn(model, ce_chunk=8)(live, batch)
        loss.backward()
        grads.append(leaf_paths(tree_map(lambda t: t.grad, live)))
    for (name, a), (_, b) in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5, msg=name)


def test_forward_hidden_matches_reference(yi_pair):
    jm, jp, tm = yi_pair
    toks = np.random.default_rng(12).integers(0, 256, (2, 12))
    jh, _ = jm.forward_hidden(jp, jnp.asarray(toks))
    th, aux = tm.forward_hidden(_port_params(jp), torch.from_numpy(toks))
    assert th.shape == (2, 12, tm.cfg.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(_np(th), np.asarray(jh), atol=ATOL, rtol=RTOL)


def test_serving_entries_stay_in_inference_mode(yi_pair):
    _, jp, tm = yi_pair
    tp = tree_map(lambda t: t.requires_grad_(True), _port_params(jp))
    toks = torch.from_numpy(np.random.default_rng(13).integers(0, 256, (1, 6)))
    logits, _ = tm.forward(tp, toks)
    assert logits.is_inference() and not logits.requires_grad
    last, cache = tm.prefill(tp, toks, cache_len=8)
    assert last.is_inference()
    step, _ = tm.decode_step(tp, cache, toks[:, -1], torch.tensor([6]))
    assert step.is_inference()


def test_mamba2_loss_and_gradients_match_reference():
    """SSM blocks train on the CPU through the chunked plain path."""
    jm = JaxModel(replace(jax_smoke_config("mamba2-2.7b"), dtype="float32"))
    jp = jax_init_params(jm.param_template(), jax.random.PRNGKey(3))
    tm = Model(replace(smoke_config("mamba2-2.7b"), dtype="float32"),
               device="cpu")
    inputs, targets = _batch(np.random.default_rng(14), 2, 32)
    (jl, _), jg = jax.value_and_grad(jax_make_loss_fn(jm, ce_chunk=16),
                                     has_aux=True)(
        jp, {"inputs": jnp.asarray(inputs), "targets": jnp.asarray(targets)})
    live = tree_map(lambda t: t.clone().requires_grad_(True),
                    _port_params(jp))
    tl, _ = make_loss_fn(tm, ce_chunk=16)(
        live, {"inputs": torch.from_numpy(inputs),
               "targets": torch.from_numpy(targets)})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=ATOL,
                               rtol=RTOL)
    _assert_trees_close(tree_map(lambda t: t.grad, live), jg)


def test_train_state_template_names_and_shapes_match_reference():
    jm = JaxModel(jax_smoke_config("yi-9b"))
    tm = Model(smoke_config("yi-9b"), device="cpu")
    jp, jopt = jax_train_state_template(jm)
    tp, topt = train_state_template(tm)
    want = [(n, tuple(s.shape), str(s.dtype)) for n, s in
            jax_leaf_paths({"params": jp, "opt": jopt})]
    got = [(n, tuple(s.shape), s.dtype) for n, s in
           leaf_paths({"params": tp, "opt": topt})]
    assert got == want
    assert all(isinstance(s, ParamSpec) for _, s in leaf_paths(topt))
