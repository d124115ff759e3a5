"""The port's model: the attention, SSM and MoE cycles of the reference, and
its encoder-decoder (whisper): all ten architectures of its registry.

Layers are grouped into a repeating *cycle*; stacked cycle parameters carry
a leading layer dim, and the reference's ``lax.scan`` over them becomes a
Python loop over index ``c``.  Entry points:

* ``forward_hidden`` — the train pass, with autograd: final-norm hidden
  states (b, s, d) and the aux loss (the loss projects them chunk by chunk)
* ``forward``     — full teacher-forced pass -> (logits fp32, aux)
* ``prefill``     — forward + KV cache construction
* ``decode_step`` — one new token against the cache (updated in place)

An encoder config (whisper) runs ``encode`` first in ``forward_hidden``,
``forward`` and ``prefill``, over the frame embeddings ``enc_embeds``
(b, frames, d): non-causal attention blocks with RoPE, then the encoder's
final norm.  Each decoder block then attends to the encoder output in its
cross part (no RoPE, qk-norm, window or softcap); prefill stores the
projected ``ck`` / ``cv`` in the cache, and decode reads them there.

The last three run under ``torch.inference_mode``.  In the train pass
each cycle is rematerialised (``torch.utils.checkpoint``, non-reentrant)
unless ``cfg.remat == "none"``, as the reference's ``jax.checkpoint`` per
cycle does: the backward runs each cycle's forward again, so flash
attention launches twice per layer and its backward once.  Stacked cycle
parameters are split once per pass with ``unbind``, whose backward stacks
the per-layer gradients in one pass.

Attention dispatch: on the card, prefill / train / encoder attention goes
through the CUDA flash-attention kernel (with a gradient,
``FlashAttentionFn``: the hand-written backward kernel) and decode through
the CUDA decode-attention kernel (with ``lengths = min(pos + 1, cache
size)``; for cross-attention ``lengths`` = the frame count); on the CPU
both take the plain versions in ``layers``, with torch autograd.  The cache is
written in ring order (slot = position % cache size), which matches the
reference whenever the prompt fits the cache.

SSM blocks (``models/ssm.py``): on the card the SSD chunk scan of prefill /
train goes through the CUDA SSD kernel, on the CPU through the chunked
plain path; the single-token decode step is plain PyTorch on both.  Their
cache is the conv tail and the fp32 state, written in place.  The SSD
kernels have no backward yet (ROADMAP B6): a grad-enabled train pass of
SSM blocks raises on the card and runs the chunked plain path on the CPU.

MoE blocks (``spec.moe``) take ``layers.moe_mlp`` for their MLP, on both
devices.  Each MLP part returns its aux loss (0 for a dense MLP); blocks,
cycles and the stack sum them, and ``forward_hidden`` / ``forward``
return the sum, as the reference does.  Prefill and decode compute it and
drop it.  The capacity depends on the tokens of a call, so a prefill, a
decode step (one token: nothing drops) and a teacher-forced pass can drop
different tokens at the same ``capacity_factor``, as in the reference.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DTYPES, resolve_device
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.param import (ParamSpec, stack_cycle, tree_leaves,
                                      tree_map)

f32 = torch.float32


# the encoder's one-block cycle (reference ``Model.encode``)
ENCODER_CYCLE = (LayerSpec(kind="attn", causal=False),)


# ------------------------------------------------------------- templates
def _attn_template(cfg: ModelConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = {"ln": L.norm_template(cfg),
         "wq": ParamSpec((d, h, dh), ("embed", "heads", "head_dim"), cfg.dtype),
         "wk": ParamSpec((d, kv, dh), ("embed", "kv_heads", "head_dim"),
                         cfg.dtype),
         "wv": ParamSpec((d, kv, dh), ("embed", "kv_heads", "head_dim"),
                         cfg.dtype),
         "wo": ParamSpec((h, dh, d), ("heads", "head_dim", "embed"),
                         cfg.dtype)}
    if cfg.qk_norm:
        t["qn"] = {"scale": ParamSpec((dh,), (None,), "float32", "zeros")}
        t["kn"] = {"scale": ParamSpec((dh,), (None,), "float32", "zeros")}
    if cfg.post_block_norm:
        t["post_ln"] = L.norm_template(cfg)
    return t


def _mlp_part_template(cfg: ModelConfig, spec: LayerSpec) -> dict:
    t = {"ln": L.norm_template(cfg)}
    t.update(L.moe_template(cfg) if spec.moe else L.mlp_template(cfg))
    if cfg.post_block_norm:
        t["post_ln"] = L.norm_template(cfg)
    return t


def _block_template(cfg: ModelConfig, spec: LayerSpec) -> dict:
    if spec.kind == "attn":
        t = {"attn": _attn_template(cfg)}
    else:
        t = {"ssm": {"ln": L.norm_template(cfg), **S.ssm_template(cfg)}}
    if spec.cross_attn:
        t["cross"] = _attn_template(cfg)
    if spec.mlp:
        t["mlp"] = _mlp_part_template(cfg, spec)
    return t


def _unstack(tree, n: int) -> list:
    """A tree of stacked (n, ...) tensors -> n trees of per-layer views."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: sub[c] for k, sub in subs.items()} for c in range(n)]
    return list(tree.unbind(0))


def _proj(x, w):
    """x (b, s, d) @ w (d, ...) -> (b, s, ...), contiguous."""
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).view(b, s, *w.shape[1:])


class Model:
    def __init__(self, cfg: ModelConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    # --------------------------------------------------------- param spec
    def param_template(self) -> dict:
        cfg = self.cfg
        tpl = {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), cfg.dtype, "normal", 0.02),
            "blocks": stack_cycle(
                {f"s{i}": _block_template(cfg, spec)
                 for i, spec in enumerate(cfg.cycle)}, cfg.n_cycles),
            "final_norm": L.norm_template(cfg),
        }
        if not cfg.tie_embeddings:
            tpl["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                       ("embed", "vocab"), cfg.dtype,
                                       "normal", 0.02)
        if cfg.encoder:
            tpl["encoder"] = {
                "blocks": stack_cycle(
                    {"s0": _block_template(cfg, ENCODER_CYCLE[0])},
                    cfg.encoder.n_layers),
                "final_norm": L.norm_template(cfg),
            }
        return tpl

    def cache_template(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        per_cycle = {}
        for i, spec in enumerate(cfg.cycle):
            if spec.kind != "attn":
                c = S.ssm_cache_template(cfg, batch)
            else:
                sc = min(spec.window, cache_len) if spec.window else cache_len
                kvshape = (batch, sc, cfg.n_kv_heads, cfg.head_dim)
                kvaxes = ("batch", "kvseq", "kv_heads", "head_dim")
                c = {"k": ParamSpec(kvshape, kvaxes, cfg.dtype, "zeros"),
                     "v": ParamSpec(kvshape, kvaxes, cfg.dtype, "zeros"),
                     "kpos": ParamSpec((batch, sc), ("batch", "kvseq"),
                                       "int32", "neg_ones")}
            if spec.cross_attn:
                xshape = (batch, cfg.encoder.n_frames, cfg.n_kv_heads,
                          cfg.head_dim)
                xaxes = ("batch", "frames", "kv_heads", "head_dim")
                c["ck"] = ParamSpec(xshape, xaxes, cfg.dtype, "zeros")
                c["cv"] = ParamSpec(xshape, xaxes, cfg.dtype, "zeros")
            per_cycle[f"s{i}"] = c
        return stack_cycle(per_cycle, cfg.n_cycles)

    def _new_cache(self, batch: int, cache_len: int) -> dict:
        def alloc(s: ParamSpec):
            return torch.full(s.shape, -1 if s.init == "neg_ones" else 0,
                              dtype=DTYPES[s.dtype], device=self.device)
        return tree_map(alloc, self.cache_template(batch, cache_len))

    # ------------------------------------------------------------- blocks
    def _project_qkv(self, h, p, positions, use_rope: bool = True):
        cfg = self.cfg
        q, k, v = _proj(h, p["wq"]), _proj(h, p["wk"]), _proj(h, p["wv"])
        if cfg.qk_norm:
            q = L.rms_norm(q, p["qn"]["scale"], cfg.norm_eps)
            k = L.rms_norm(k, p["kn"]["scale"], cfg.norm_eps)
        if use_rope:
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _attn_part(self, x, p, spec: LayerSpec, *, mode, cache, pos):
        cfg = self.cfg
        b, sq, _ = x.shape
        h = L.apply_norm(x, p["ln"], cfg)
        if mode == "decode":
            positions = pos[:, None]                      # (b,1)
        else:
            positions = torch.arange(sq, device=x.device)[None, :]
        q, k, v = self._project_qkv(h, p, positions)
        on_card = x.device.type == "cuda"

        if mode == "decode":
            # the cache tensors are views into the stacked cache: written
            # in place, slot = pos % sc
            sc = cache["k"].shape[1]
            idx = pos % sc
            barange = torch.arange(b, device=x.device)
            cache["k"][barange, idx] = k[:, 0]
            cache["v"][barange, idx] = v[:, 0]
            cache["kpos"][barange, idx] = pos.to(torch.int32)
            if on_card:
                lengths = torch.clamp(pos + 1, max=sc).to(torch.int32)
                o = decode_attention(q[:, 0].contiguous(), cache["k"],
                                     cache["v"], lengths, window=spec.window,
                                     softcap=cfg.attn_softcap)[:, None]
            else:
                o = L.decode_attention(q, cache["k"], cache["v"],
                                       cache["kpos"], pos, window=spec.window,
                                       cap=cfg.attn_softcap)
        else:
            if on_card:
                o = flash_attention(q, k, v, causal=spec.causal,
                                    window=spec.window,
                                    softcap=cfg.attn_softcap)
            else:
                o = L.blocked_attention(q, k, v, causal=spec.causal,
                                        window=spec.window,
                                        cap=cfg.attn_softcap,
                                        q_blocks=cfg.attn_q_blocks)
            if mode == "prefill":
                self._fill_cache(cache, k, v)
        bs = b * sq
        out = (o.reshape(bs, -1) @ p["wo"].reshape(-1, cfg.d_model)) \
            .view(b, sq, cfg.d_model)
        if cfg.post_block_norm:
            out = L.apply_norm(out, p["post_ln"], cfg)
        return x + out

    @staticmethod
    def _fill_cache(cache, k, v) -> None:
        """Write the last min(s, sc) prefill positions in ring order."""
        b, s = k.shape[:2]
        sc = cache["k"].shape[1]
        take = min(s, sc)
        positions = torch.arange(s - take, s, device=k.device)
        slots = positions % sc
        cache["k"][:, slots] = k[:, s - take:]
        cache["v"][:, slots] = v[:, s - take:]
        cache["kpos"][:, slots] = positions.to(torch.int32)

    def _cross_part(self, x, p, *, mode, cache, enc_out):
        """Cross-attention to the encoder output: no RoPE, qk-norm, window
        or softcap.  ``ck`` / ``cv`` are projected from ``enc_out`` (and
        written into the cache in prefill) or, in decode, read from the
        cache.  The template's ``post_ln`` (a config with post-block norms)
        is not applied, as in the reference."""
        cfg = self.cfg
        b, sq, _ = x.shape
        h = L.apply_norm(x, p["ln"], cfg)
        q = _proj(h, p["wq"])
        if mode == "decode":
            ck, cv = cache["ck"], cache["cv"]
        else:
            ck, cv = _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])
            if mode == "prefill":
                cache["ck"].copy_(ck)
                cache["cv"].copy_(cv)
        if x.device.type != "cuda":
            o = L.blocked_attention(q, ck, cv, causal=False,
                                    q_blocks=cfg.attn_q_blocks)
        elif mode == "decode":
            lengths = torch.full((b,), ck.shape[1], dtype=torch.int32,
                                 device=x.device)
            o = decode_attention(q[:, 0].contiguous(), ck, cv,
                                 lengths)[:, None]
        else:
            o = flash_attention(q, ck, cv, causal=False)
        out = (o.reshape(b * sq, -1) @ p["wo"].reshape(-1, cfg.d_model)) \
            .view(b, sq, cfg.d_model)
        return x + out

    def _mlp_part(self, x, p, spec: LayerSpec):
        """-> (x + MLP(x), aux loss: 0 for a dense MLP)."""
        cfg = self.cfg
        h = L.apply_norm(x, p["ln"], cfg)
        if spec.moe:
            y, aux = L.moe_mlp(h, p, cfg)
        else:
            y, aux = L.mlp(h, p, cfg), 0.0
        if cfg.post_block_norm:
            y = L.apply_norm(y, p["post_ln"], cfg)
        return x + y, aux

    def _ssm_part(self, x, p, *, mode, cache):
        """SSD mixer; prefill and decode write the conv tail and the state
        into the cache views in place."""
        cfg = self.cfg
        h = L.apply_norm(x, p["ln"], cfg)
        if mode == "train":
            return x + S.ssd_forward(h, p, cfg)
        if mode == "prefill":
            y, (conv, state) = S.ssd_forward(h, p, cfg, return_state=True)
        else:
            y, (conv, state) = S.ssd_decode(h, p, cfg, cache["conv"],
                                            cache["state"])
        cache["conv"].copy_(conv)
        cache["state"].copy_(state)
        return x + y

    def apply_block(self, x, p, spec: LayerSpec, *, mode, cache=None,
                    pos=None, enc_out=None):
        """-> (x, aux loss of the block's MLP)."""
        aux = 0.0
        if spec.kind == "attn":
            x = self._attn_part(x, p["attn"], spec, mode=mode, cache=cache,
                                pos=pos)
        else:
            x = self._ssm_part(x, p["ssm"], mode=mode, cache=cache)
        if spec.cross_attn:
            x = self._cross_part(x, p["cross"], mode=mode, cache=cache,
                                 enc_out=enc_out)
        if spec.mlp:
            x, aux = self._mlp_part(x, p["mlp"], spec)
        return x, aux

    # -------------------------------------------------------------- stacks
    def _cycle(self, x, cp, *, mode, cache=None, pos=None, enc_out=None,
               cycle=None):
        """One cycle of blocks (``cycle``, the config's by default): ``cp`` /
        ``cache`` hold its layer's parameters / cache views by block key.
        Returns (x, the blocks' summed aux loss)."""
        aux = 0.0
        for i, spec in enumerate(cycle or self.cfg.cycle):
            key = f"s{i}"
            x, a = self.apply_block(
                x, cp[key], spec, mode=mode,
                cache=None if cache is None else cache[key], pos=pos,
                enc_out=enc_out)
            aux = aux + a
        return x, aux

    def _run_blocks(self, x, blocks, *, mode, cache=None, pos=None,
                    enc_out=None, cycle=None):
        """The stack of cycles in ``blocks`` (stacked, leading layer dim).
        Returns (x, the aux loss summed over cycles, an fp32 scalar)."""
        cfg = self.cfg
        n = tree_leaves(blocks)[0].shape[0]
        layers = _unstack(blocks, n)
        remat = mode == "train" and cfg.remat != "none" \
            and torch.is_grad_enabled()
        aux = 0.0
        for c in range(n):
            if remat:
                x, a = checkpoint(self._cycle, x, layers[c], mode=mode,
                                  enc_out=enc_out, cycle=cycle,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = self._cycle(x, layers[c], mode=mode,
                                   cache=None if cache is None else
                                   tree_map(lambda t: t[c], cache), pos=pos,
                                   enc_out=enc_out, cycle=cycle)
            aux = aux + a
        if not isinstance(aux, torch.Tensor):          # no MoE block
            aux = torch.zeros((), dtype=f32, device=x.device)
        return x, aux

    def encode(self, params, enc_embeds):
        """The encoder over frame embeddings (b, frames, d): non-causal
        attention blocks, then the encoder's final norm."""
        enc = params["encoder"]
        x, _ = self._run_blocks(enc_embeds, enc["blocks"], mode="encode",
                                cycle=ENCODER_CYCLE)
        return L.apply_norm(x, enc["final_norm"], self.cfg)

    def head_weights(self, params):
        """(d_model, vocab) output projection."""
        return params["embed"].T if self.cfg.tie_embeddings \
            else params["lm_head"]

    def _head(self, x, params):
        cfg = self.cfg
        x = L.apply_norm(x, params["final_norm"], cfg)
        logits = x @ self.head_weights(params)
        return L.softcap(logits.to(f32), cfg.final_softcap)

    def _embed(self, params, tokens):
        cfg = self.cfg
        x = params["embed"][tokens].to(DTYPES[cfg.dtype])
        if cfg.embed_scale:
            x = x * math.sqrt(cfg.d_model)
        return x

    # ------------------------------------------------------------ entries
    def forward_hidden(self, params, tokens, enc_embeds=None):
        """The train pass, with autograd: final-norm hidden states
        (b, s, d) and the aux loss (the MoE blocks' sum, 0 without MoE);
        no logits are formed.
        Reference: ``repro/models/model.py::Model.forward_hidden``."""
        cfg = self.cfg
        if tokens.device.type == "cuda" and torch.is_grad_enabled() and \
                any(spec.kind != "attn" for spec in cfg.cycle):
            raise NotImplementedError(
                f"{cfg.name}: training SSM blocks on the card needs the SSD "
                f"backward kernel (ROADMAP B6)")
        enc_out = self.encode(params, enc_embeds) if self.cfg.encoder \
            else None
        x = self._embed(params, tokens)
        x, aux = self._run_blocks(x, params["blocks"], mode="train",
                                  enc_out=enc_out)
        return L.apply_norm(x, params["final_norm"], cfg), aux

    @torch.inference_mode()
    def forward(self, params, tokens, enc_embeds=None):
        """Teacher-forced pass -> (logits (b,s,V) fp32, aux loss)."""
        enc_out = self.encode(params, enc_embeds) if self.cfg.encoder \
            else None
        x = self._embed(params, tokens)
        x, aux = self._run_blocks(x, params["blocks"], mode="train",
                                  enc_out=enc_out)
        return self._head(x, params), aux

    @torch.inference_mode()
    def prefill(self, params, tokens, cache_len: int | None = None,
                enc_embeds=None):
        """Build the cache; returns (last-position logits (b,V), cache)."""
        cache_len = cache_len or tokens.shape[1]
        cache = self._new_cache(tokens.shape[0], cache_len)
        enc_out = self.encode(params, enc_embeds) if self.cfg.encoder \
            else None
        x = self._embed(params, tokens)
        x, _ = self._run_blocks(x, params["blocks"], mode="prefill",
                                cache=cache, enc_out=enc_out)
        return self._head(x[:, -1:], params)[:, 0], cache

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens, pos):
        """One token step. tokens: (b,), pos: (b,) -> (logits (b,V), cache).

        The cache is updated in place (and returned)."""
        x = self._embed(params, tokens[:, None])
        x, _ = self._run_blocks(x, params["blocks"], mode="decode",
                                cache=cache, pos=pos)
        return self._head(x, params)[:, 0], cache
