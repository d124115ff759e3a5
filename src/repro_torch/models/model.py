"""Decoder model of the port: the attention and SSM cycles of the reference.

Layers are grouped into a repeating *cycle*; stacked cycle parameters carry
a leading layer dim, and the reference's ``lax.scan`` over them becomes a
Python loop over index ``c``.  Entry points:

* ``forward``     — full teacher-forced pass -> (logits fp32, aux)
* ``prefill``     — forward + KV cache construction
* ``decode_step`` — one new token against the cache (updated in place)

Attention dispatch: on the card, prefill / train attention goes through the
CUDA flash-attention kernel and decode through the CUDA decode-attention
kernel (with ``lengths = min(pos + 1, cache size)``); on the CPU both take
the plain versions in ``layers``.  The cache is written in ring order
(slot = position % cache size), which matches the reference whenever the
prompt fits the cache.

SSM blocks (``models/ssm.py``): on the card the SSD chunk scan of prefill /
train goes through the CUDA SSD kernel, on the CPU through the chunked
plain path; the single-token decode step is plain PyTorch on both.  Their
cache is the conv tail and the fp32 state, written in place.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import DTYPES, resolve_device
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.param import ParamSpec, stack_cycle, tree_map

f32 = torch.float32


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for the parts of the reference model this slice leaves out."""
    missing = []
    if cfg.encoder:
        missing.append(("the encoder", "A11"))
    if cfg.qk_norm:
        missing.append(("qk_norm", "A11"))
    for spec in cfg.cycle:
        if spec.moe:
            missing.append(("the MoE MLP", "A12"))
        if spec.cross_attn:
            missing.append(("cross-attention", "A11"))
    if missing:
        what, item = missing[0]
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported to repro_torch yet "
            f"(ROADMAP {item})")


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
    t.update(L.mlp_template(cfg))
    if cfg.post_block_norm:
        t["post_ln"] = L.norm_template(cfg)
    return t


def _block_template(cfg: ModelConfig, spec: LayerSpec) -> dict:
    if spec.kind == "attn":
        t = {"attn": _attn_template(cfg)}
    else:
        t = {"ssm": {"ln": L.norm_template(cfg), **S.ssm_template(cfg)}}
    if spec.mlp:
        t["mlp"] = _mlp_part_template(cfg, spec)
    return t


def _proj(x, w):
    """x (b, s, d) @ w (d, ...) -> (b, s, ...), contiguous."""
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).view(b, s, *w.shape[1:])


class Model:
    def __init__(self, cfg: ModelConfig, *, device=None):
        _check_ported(cfg)
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
        return tpl

    def cache_template(self, batch: int, cache_len: int) -> dict:
        cfg = self.cfg
        per_cycle = {}
        for i, spec in enumerate(cfg.cycle):
            if spec.kind != "attn":
                per_cycle[f"s{i}"] = S.ssm_cache_template(cfg, batch)
                continue
            sc = min(spec.window, cache_len) if spec.window else cache_len
            kvshape = (batch, sc, cfg.n_kv_heads, cfg.head_dim)
            kvaxes = ("batch", "kvseq", "kv_heads", "head_dim")
            per_cycle[f"s{i}"] = {
                "k": ParamSpec(kvshape, kvaxes, cfg.dtype, "zeros"),
                "v": ParamSpec(kvshape, kvaxes, cfg.dtype, "zeros"),
                "kpos": ParamSpec((batch, sc), ("batch", "kvseq"), "int32",
                                  "neg_ones")}
        return stack_cycle(per_cycle, cfg.n_cycles)

    def _new_cache(self, batch: int, cache_len: int) -> dict:
        def alloc(s: ParamSpec):
            return torch.full(s.shape, -1 if s.init == "neg_ones" else 0,
                              dtype=DTYPES[s.dtype], device=self.device)
        return tree_map(alloc, self.cache_template(batch, cache_len))

    # ------------------------------------------------------------- blocks
    def _project_qkv(self, h, p, positions):
        cfg = self.cfg
        q, k, v = _proj(h, p["wq"]), _proj(h, p["wk"]), _proj(h, p["wv"])
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

    def _mlp_part(self, x, p, spec: LayerSpec):
        cfg = self.cfg
        h = L.apply_norm(x, p["ln"], cfg)
        y = L.mlp(h, p, cfg)
        if cfg.post_block_norm:
            y = L.apply_norm(y, p["post_ln"], cfg)
        return x + y

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
                    pos=None):
        if spec.kind == "attn":
            x = self._attn_part(x, p["attn"], spec, mode=mode, cache=cache,
                                pos=pos)
        else:
            x = self._ssm_part(x, p["ssm"], mode=mode, cache=cache)
        if spec.mlp:
            x = self._mlp_part(x, p["mlp"], spec)
        return x

    # -------------------------------------------------------------- stacks
    def _run_blocks(self, x, blocks, *, mode, cache=None, pos=None):
        cfg = self.cfg
        for c in range(cfg.n_cycles):
            for i, spec in enumerate(cfg.cycle):
                key = f"s{i}"
                x = self.apply_block(
                    x, tree_map(lambda t: t[c], blocks[key]), spec, mode=mode,
                    cache=None if cache is None else
                    tree_map(lambda t: t[c], cache[key]),
                    pos=pos)
        return x

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
    @torch.inference_mode()
    def forward(self, params, tokens):
        """Teacher-forced pass -> (logits (b,s,V) fp32, aux loss)."""
        x = self._embed(params, tokens)
        x = self._run_blocks(x, params["blocks"], mode="train")
        return self._head(x, params), torch.zeros((), dtype=f32,
                                                  device=x.device)

    @torch.inference_mode()
    def prefill(self, params, tokens, cache_len: int | None = None):
        """Build the cache; returns (last-position logits (b,V), cache)."""
        cache_len = cache_len or tokens.shape[1]
        cache = self._new_cache(tokens.shape[0], cache_len)
        x = self._embed(params, tokens)
        x = self._run_blocks(x, params["blocks"], mode="prefill", cache=cache)
        return self._head(x[:, -1:], params)[:, 0], cache

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens, pos):
        """One token step. tokens: (b,), pos: (b,) -> (logits (b,V), cache).

        The cache is updated in place (and returned)."""
        x = self._embed(params, tokens[:, None])
        x = self._run_blocks(x, params["blocks"], mode="decode", cache=cache,
                             pos=pos)
        return self._head(x, params)[:, 0], cache
