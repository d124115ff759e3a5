"""Train step: chunked cross-entropy, grad accumulation, AdamW.

The reference's ``repro/train/loop.py`` in torch:

* **Chunked cross-entropy** — the (b, s, V) logits are never formed at
  once: the loss walks sequence chunks, projects each to the vocab and
  reduces at once.  Under autograd each chunk is a non-reentrant
  ``torch.utils.checkpoint``, so its logits are recomputed in the backward
  instead of saved (the reference's ``jax.checkpoint`` of the scan body):
  at b 4 x s 2048 x vocab 64000 the fp32 logits would be 2.1 GB.
* **Gradient accumulation** — microbatches along axis 0, gradients summed
  in fp32 and averaged, the loss averaged.

Sharded (a ``Model`` built with a ``Sharder`` on a mesh, params and state
placed as DTensors by ``Sharder.distribute``): the targets are constrained
to (batch, seq) beside the model's tokens, the loss projects chunks onto
the vocab-sharded head, and each gradient is redistributed to its
parameter's placements (the ``Sharder``'s specs of the param template)
before the optimizer, as the reference's ``pin`` with ``grad_pspecs``.
The step runs in ``Sharder.region`` (backward included).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.models.model import Model
from repro_torch.models.param import ParamSpec, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.parallel.sharding import placements

f32 = torch.float32


def _ce_chunk(h, head_w, t, final_softcap: float):
    """(sum of CE, sum of lse², valid tokens) of one chunk, in fp32."""
    logits = (h @ head_w).to(f32)
    if final_softcap:
        logits = torch.tanh(logits / final_softcap) * final_softcap
    lse = torch.logsumexp(logits, dim=-1)
    idx = t.clamp(min=0).long()
    if isinstance(logits, DTensor):
        # DTensor's gather over the vocab-sharded dim cannot reduce its
        # result (the mask it keeps has an embedding's shape): pick the
        # target logit by a comparison with the vocab ids instead
        vocab = torch.arange(logits.shape[-1], device=idx.device)
        hit = vocab == idx[..., None]
        tgt = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    else:
        tgt = torch.gather(logits, -1, idx[..., None])[..., 0]
    valid = (t >= 0).to(logits.dtype)
    return torch.stack([torch.sum((lse - tgt) * valid),
                        torch.sum(torch.square(lse) * valid),
                        torch.sum(valid)])


def chunked_cross_entropy(hidden, head_w, targets, *, final_softcap: float = 0.0,
                          chunk: int = 512, z_weight: float = 1e-4):
    """Mean CE over valid (target >= 0) tokens, walking sequence chunks.

    hidden: (b, s, d); head_w: (d, V); targets: (b, s) int (-1 = pad).
    Returns (loss with the z-loss, mean CE, valid token count), 0-d fp32.
    """
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    remat = torch.is_grad_enabled()
    total = 0
    for i in range(s // chunk):
        h = hidden[:, i * chunk:(i + 1) * chunk]
        t = targets[:, i * chunk:(i + 1) * chunk]
        if remat:
            part = checkpoint(_ce_chunk, h, head_w, t, final_softcap,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            part = _ce_chunk(h, head_w, t, final_softcap)
        total = total + part
    ce, zl, n = total.unbind(0)
    n = torch.clamp(n, min=1.0)
    return ce / n + z_weight * zl / n, ce / n, n


def make_loss_fn(model: Model, *, ce_chunk: int = 512):
    cfg = model.cfg

    def loss_fn(params, batch):
        hidden, aux = model.forward_hidden(
            params, batch["inputs"], enc_embeds=batch.get("enc_embeds"))
        loss, ce, n = chunked_cross_entropy(
            hidden, model.head_weights(params),
            model.sh(batch["targets"], "batch", "seq"),
            final_softcap=cfg.final_softcap, chunk=ce_chunk)
        return loss + aux, {"ce": ce, "aux": aux, "tokens": n}

    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn`` at ``params``; grads in the params'
    dtypes, as the reference's ``jax.value_and_grad``."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, _aux = loss_fn(live, batch)
        flat = tree_leaves(live)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(flat, grads)])
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    grad_accum: int = 1, ce_chunk: int = 512):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    With grad_accum > 1 the batch is split along axis 0 into microbatches
    whose gradients are summed in fp32 and averaged before the optimizer;
    the loss is the mean of theirs.  The update is in place
    (``adamw_update``): the returned params and state are the given ones.
    For a sharded model each gradient is first redistributed to its
    parameter's placements.
    """
    loss_fn = make_loss_fn(model, ce_chunk=ce_chunk)
    sh = model.sh
    pspecs = None if sh.mesh is None \
        else sh.template_pspecs(model.param_template())

    def pin(grads):
        if pspecs is None:
            return grads
        return _zip_map(lambda g, spec: g.redistribute(
            sh.mesh, placements(spec, sh.mesh)), grads, pspecs)

    def train_step(params, opt_state, batch):
        with sh.region():
            return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
            mb = batch["inputs"].shape[0] // grad_accum
            gsum, lsum = None, torch.zeros((), dtype=f32,
                                           device=batch["inputs"].device)
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                lo, g = _value_and_grad(loss_fn, params, micro)
                g = tree_map(lambda x: x.to(f32), g)
                gsum = g if gsum is None else _add(gsum, g)
                lsum = lsum + lo
            grads = tree_map(lambda x: x / grad_accum, gsum)
            loss = lsum / grad_accum
        grads = pin(grads)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def _zip_map(fn, a, b):
    """Leafwise fn(a, b) of two trees with the same keys."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, v, b[k]) for k, v in a.items()}
    return fn(a, b)


def _add(a, b):
    """Leafwise a + b of two trees with the same keys."""
    return _zip_map(lambda x, y: x + y, a, b)


def _opt_template(param_tpl) -> dict:
    """``ParamSpec`` tree of the AdamW state of a param template."""
    def f32_like(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, s.axes, "float32", "zeros")
    return {"step": ParamSpec((), (), "int32", "zeros"),
            "m": tree_map(f32_like, param_tpl),
            "v": tree_map(f32_like, param_tpl),
            "master": tree_map(f32_like, param_tpl)}


def train_state_template(model: Model):
    """``ParamSpec`` trees of (params, opt_state): shapes and dtypes, no
    allocation (the reference returns ``ShapeDtypeStruct``s)."""
    ptpl = model.param_template()
    return ptpl, _opt_template(ptpl)
