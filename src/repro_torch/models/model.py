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

The last three run under ``torch.inference_mode`` (``no_grad`` for a
sharded model).  In the train pass
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
train goes through the CUDA SSD kernels (with a gradient,
``SSDChunkScanFn``: the hand-written backward kernels), on the CPU through
the chunked plain path with torch autograd; the single-token decode step
is plain PyTorch on both.  Their cache is the conv tail and the fp32
state, written in place.  With remat a train step launches the SSD
forward twice a layer and its backward once.

Sharding: ``Model(cfg, sharder)`` with a ``parallel.Sharder`` on a mesh
takes params (and caches, which it allocates) as DTensors and constrains
activations where the reference's ``self.sh`` does: q/k/v (heads), block
inputs (batch), MLP hiddens (mlp), the cycle boundary (``act_seq``), the
embedding, the head (vocab).  The kernels, and on the CPU their plain
versions, get each rank's shards through ``Sharder.local_call``; when the
kv heads stay whole while the query heads split (GQA on a wider
``model`` axis), ``_kv_for_heads`` gives each rank the kv heads of its
own query heads.  Projections are laid out before their views
(``_matmul_view``), and cache writes are local.  Without a sharder every
constraint is the identity and every path is the unsharded one.

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
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DTYPES, resolve_device
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.param import (ParamSpec, stack_cycle, tree_leaves,
                                      tree_map)
from repro_torch.parallel.sharding import Sharder, local_offset

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


def _local(t):
    """This rank's shard of a DTensor (the tensor itself otherwise)."""
    return t.to_local() if isinstance(t, DTensor) else t


def _kv_for_heads(k, v, h0: int, h_loc: int, g: int):
    """The k/v heads that the query heads h0 .. h0 + h_loc - 1 (global
    indices, g query heads per kv head) attend to, in a GQA layout for
    those heads alone.  ``k``/``v`` (b, s, kv, dh) hold either exactly the
    kv heads of the local query heads (sharded alike, or nothing sharded)
    or every kv head (replicated while the query heads are split)."""
    if k.shape[2] * g == h_loc:
        return k, v
    if g % h_loc == 0 or h_loc % g == 0:      # one group, or whole groups
        lo, n = h0 // g, max(1, h_loc // g)
        return (k[:, :, lo:lo + n].contiguous(),
                v[:, :, lo:lo + n].contiguous())
    idx = torch.arange(h0, h0 + h_loc, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def _on_kernels(x) -> bool:
    """The card's dispatch: the CUDA kernels on the card, and on ``meta``
    (the dry run) their operators, which ``launch.cost``'s counter
    intercepts and counts."""
    return x.device.type in ("cuda", "meta")


def _split_seq(cache) -> bool:
    """Whether a (b, S, ...) cache's sequence is split over more than one
    rank (the same answer on every rank)."""
    return isinstance(cache, DTensor) and any(
        p.is_shard(1) and cache.device_mesh.size(i) > 1
        for i, p in enumerate(cache.placements))


def _flat_placements(pl) -> list:
    """Placements of a (b, s, ...) layout for its (b*s, prod(...)) view:
    batch sharding stays on dim 0, the first trailing dim's on dim 1."""
    return [Shard({0: 0, 2: 1}[p.dim]) if p.is_shard() else p for p in pl]


class Model:
    def __init__(self, cfg: ModelConfig, sharder: Sharder | None = None, *,
                 device=None):
        self.cfg = cfg
        self.sh = sharder or Sharder.null()
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
            return self.sh.full(s.shape, s.axes,
                                -1 if s.init == "neg_ones" else 0,
                                DTYPES[s.dtype], self.device)
        return tree_map(alloc, self.cache_template(batch, cache_len))

    # ------------------------------------------------------------- blocks
    def _matmul_view(self, a, w, shape: tuple, axes: tuple):
        """a (m, k) @ w (k, n) viewed as ``shape`` (m = shape[0] * shape[1]).
        Sharded, the product is first laid out as ``axes`` (the logical
        axes of ``shape``) would be, flattened: DTensor may split n where
        the view cannot, and may hand the operands' flattened views a
        gradient layout their backward cannot unflatten, so each operand's
        gradient is pinned to its own layout (a redistribution to the same
        placements is the identity forward)."""
        if isinstance(w, DTensor):
            a = a.redistribute(a.device_mesh, a.placements)
            w = w.redistribute(w.device_mesh, w.placements)
        y = a @ w
        if isinstance(y, DTensor):
            y = y.redistribute(self.sh.mesh, _flat_placements(
                self.sh.placements(axes, shape)))
        return y.view(*shape)

    def _proj(self, x, w, axes: tuple):
        """x (b, s, d) @ w (d, ...) -> (b, s, ...), contiguous; ``axes``
        are the logical axes of w's trailing dims."""
        b, s, d = x.shape
        return self._matmul_view(x.reshape(b * s, d), w.reshape(d, -1),
                                 (b, s, *w.shape[1:]), ("batch", "seq") + axes)

    def _out_proj(self, o, w):
        """Attention output o (b, s, h, dh) @ w (h, dh, d) -> (b, s, d)."""
        b, s = o.shape[:2]
        d = self.cfg.d_model
        return self._matmul_view(o.reshape(b * s, -1), w.reshape(-1, d),
                                 (b, s, d), ("batch", "seq", None))

    def _project_qkv(self, h, p, positions, use_rope: bool = True):
        cfg = self.cfg
        q = self._proj(h, p["wq"], ("heads", None))
        k = self._proj(h, p["wk"], ("kv_heads", None))
        v = self._proj(h, p["wv"], ("kv_heads", None))
        if cfg.qk_norm:
            q = L.rms_norm(q, p["qn"]["scale"], cfg.norm_eps)
            k = L.rms_norm(k, p["kn"]["scale"], cfg.norm_eps)
        if use_rope:
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
        q = self.sh(q, "batch", "seq", "heads", None)
        k = self.sh(k, "batch", "seq", "kv_heads", None)
        v = self.sh(v, "batch", "seq", "kv_heads", None)
        return q, k, v

    def _attention(self, q, k, v, *, causal: bool = True, window: int = 0,
                   softcap: float = 0.0):
        """Attention of q (b, sq, h, dh) over k/v (b, sk, kv, dh), on each
        rank's heads (``Sharder.local_call``; GQA through ``_kv_for_heads``):
        the flash kernel on the card, ``blocked_attention`` on the CPU."""
        cfg = self.cfg
        q = self.sh(q, "batch", "seq", "heads", None)
        h0, g = local_offset(q, 2), q.shape[2] // k.shape[2]
        kernel = _on_kernels(q)

        def attend(ql, kl, vl):
            kl, vl = _kv_for_heads(kl, vl, h0, ql.shape[2], g)
            if kernel:
                return flash_attention(ql.contiguous(), kl.contiguous(),
                                       vl.contiguous(), causal=causal,
                                       window=window, softcap=softcap)
            return L.blocked_attention(ql, kl, vl, causal=causal,
                                       window=window, cap=softcap,
                                       q_blocks=cfg.attn_q_blocks)

        kv_axes = ("batch", "seq", "kv_heads", None)
        return self.sh.local_call(
            attend, [(q, ("batch", "seq", "heads", None)), (k, kv_axes),
                     (v, kv_axes)],
            [(("batch", "seq", "heads", None), q.shape)])

    def _decode_attention(self, q, kc, vc, kpos, pos, lengths, *,
                          window: int = 0, softcap: float = 0.0):
        """One query token q (b, 1, h, dh) against a cache (b, S, kv, dh) on
        each rank's heads: the decode kernel on the card (``lengths``
        valid rows), ``layers.decode_attention`` on the CPU (``kpos`` /
        ``pos``).  A cache whose sequence is split over ranks (long-context
        decode) is refused on the card: the kernel returns no softmax
        statistics to merge across the split.  On the CPU and on ``meta``
        (the dry run) it takes the plain version on DTensors."""
        q = self.sh(q, "batch", "seq", "heads", None)
        if _split_seq(kc):
            if kc.device.type == "cuda":
                raise NotImplementedError("decode against a cache whose "
                                          "sequence is split over ranks")
            return L.decode_attention(q, kc, vc, kpos, pos, window=window,
                                      cap=softcap)
        h0, g = local_offset(q, 2), q.shape[2] // kc.shape[2]
        kernel = _on_kernels(q)

        def attend(ql, kl, vl, kp, ps, ln):
            kl, vl = _kv_for_heads(kl, vl, h0, ql.shape[2], g)
            if kernel:
                return decode_attention(ql[:, 0].contiguous(),
                                        kl.contiguous(), vl.contiguous(), ln,
                                        window=window,
                                        softcap=softcap)[:, None]
            return L.decode_attention(ql, kl, vl, kp, ps, window=window,
                                      cap=softcap)

        kv_axes = ("batch", "kvseq", "kv_heads", None)
        return self.sh.local_call(
            attend, [(q, ("batch", "seq", "heads", None)), (kc, kv_axes),
                     (vc, kv_axes), (kpos, ("batch", "kvseq")),
                     (pos, ("batch",)), (lengths, ("batch",))],
            [(("batch", "seq", "heads", None), q.shape)])

    def _attn_part(self, x, p, spec: LayerSpec, *, mode, cache, pos):
        cfg = self.cfg
        sq = x.shape[1]
        h = self.sh(L.apply_norm(x, p["ln"], cfg), "batch", "seq", None)
        if mode == "decode":
            positions = pos[:, None]                      # (b,1)
        else:
            positions = torch.arange(sq, device=x.device)[None, :]
        q, k, v = self._project_qkv(h, p, positions)

        if mode == "decode":
            sc = cache["k"].shape[1]
            self._ring_write(cache, k, v, pos)
            lengths = torch.clamp(pos + 1, max=sc).to(torch.int32)
            o = self._decode_attention(q, cache["k"], cache["v"],
                                       cache["kpos"], pos, lengths,
                                       window=spec.window,
                                       softcap=cfg.attn_softcap)
        else:
            o = self._attention(q, k, v, causal=spec.causal,
                                window=spec.window, softcap=cfg.attn_softcap)
            if mode == "prefill":
                self._fill_cache(cache, k, v)
        out = self._out_proj(o, p["wo"])
        if cfg.post_block_norm:
            out = L.apply_norm(out, p["post_ln"], cfg)
        return x + out

    def _ring_write(self, cache, k, v, pos) -> None:
        """Write one step's k/v (b, 1, kv, dh) and positions into slot
        pos % sc of the cache views, in place: each rank its own rows.  A
        rank holding a slice of a split ring writes only the slots in it."""
        sc = cache["k"].shape[1]
        lo = local_offset(cache["k"], 1)
        kc, vc, kp = (_local(cache[n]) for n in ("k", "v", "kpos"))
        k = _local(self.sh(k[:, 0], "batch", "kv_heads", None))
        v = _local(self.sh(v[:, 0], "batch", "kv_heads", None))
        pos = _local(self.sh(pos, "batch"))
        rows = torch.arange(kc.shape[0], device=kc.device)
        slot = pos % sc
        kpos = pos.to(torch.int32)
        if kc.shape[1] < sc:                      # a slice of a split ring
            slot = slot - lo
            mine = (slot >= 0) & (slot < kc.shape[1])
            slot = slot.clamp(0, kc.shape[1] - 1)
            k = torch.where(mine[:, None, None], k, kc[rows, slot])
            v = torch.where(mine[:, None, None], v, vc[rows, slot])
            kpos = torch.where(mine, kpos, kp[rows, slot])
        kc[rows, slot] = k
        vc[rows, slot] = v
        kp[rows, slot] = kpos

    def _fill_cache(self, cache, k, v) -> None:
        """Write the last min(s, sc) prefill positions in ring order, in
        place: each rank its own rows and kv heads."""
        b, s = k.shape[:2]
        sc = cache["k"].shape[1]
        if _split_seq(cache["k"]):
            raise NotImplementedError("prefill into a cache whose sequence "
                                      "is split over ranks")
        take = min(s, sc)
        kc, vc, kp = (_local(cache[n]) for n in ("k", "v", "kpos"))
        k = _local(self.sh(k, "batch", "seq", "kv_heads", None))
        v = _local(self.sh(v, "batch", "seq", "kv_heads", None))
        positions = torch.arange(s - take, s, device=kc.device)
        slots = positions % sc
        kc[:, slots] = k[:, s - take:]
        vc[:, slots] = v[:, s - take:]
        kp[:, slots] = positions.to(torch.int32)

    def _cross_part(self, x, p, *, mode, cache, enc_out):
        """Cross-attention to the encoder output: no RoPE, qk-norm, window
        or softcap.  ``ck`` / ``cv`` are projected from ``enc_out`` (and
        written into the cache in prefill) or, in decode, read from the
        cache.  The template's ``post_ln`` (a config with post-block norms)
        is not applied, as in the reference."""
        cfg = self.cfg
        b, sq, _ = x.shape
        h = self.sh(L.apply_norm(x, p["ln"], cfg), "batch", "seq", None)
        q = self._proj(h, p["wq"], ("heads", None))
        if mode == "decode":
            ck, cv = cache["ck"], cache["cv"]
        else:
            enc_out = self.sh(enc_out, "batch", "frames", None)
            ck = self._proj(enc_out, p["wk"], ("kv_heads", None))
            cv = self._proj(enc_out, p["wv"], ("kv_heads", None))
            if mode == "prefill":
                axes = ("batch", "frames", "kv_heads", None)
                cache["ck"].copy_(self.sh(ck, *axes))
                cache["cv"].copy_(self.sh(cv, *axes))
        if mode == "decode" and _on_kernels(x):
            lengths = torch.full((b,), ck.shape[1], dtype=torch.int32,
                                 device=x.device)
            o = self._decode_attention(q, ck, cv, None, None, lengths)
        else:
            o = self._attention(q, ck, cv, causal=False)
        return x + self._out_proj(o, p["wo"])

    def _mlp_part(self, x, p, spec: LayerSpec):
        """-> (x + MLP(x), aux loss: 0 for a dense MLP)."""
        cfg = self.cfg
        h = self.sh(L.apply_norm(x, p["ln"], cfg), "batch", "seq", None)
        if spec.moe:
            y, aux = L.moe_mlp(h, p, cfg, sh=self.sh)
        else:
            y, aux = L.mlp(h, p, cfg, sh=self.sh), 0.0
        y = self.sh(y, "batch", "seq", None)
        if cfg.post_block_norm:
            y = L.apply_norm(y, p["post_ln"], cfg)
        return x + y, aux

    def _ssm_part(self, x, p, *, mode, cache):
        """SSD mixer; prefill and decode write the conv tail and the state
        into the cache views in place."""
        cfg = self.cfg
        h = self.sh(L.apply_norm(x, p["ln"], cfg), "batch", "seq", None)
        if mode == "train":
            return x + S.ssd_forward(h, p, cfg, sh=self.sh)
        if mode == "prefill":
            y, (conv, state) = S.ssd_forward(h, p, cfg, return_state=True,
                                             sh=self.sh)
        else:
            y, (conv, state) = S.ssd_decode(h, p, cfg, cache["conv"],
                                            cache["state"])
        cache["conv"].copy_(self.sh(conv, "batch", None, None))
        cache["state"].copy_(self.sh(state, "batch", "heads", None, None))
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
        return self.sh(x, "batch", "act_seq", None), aux

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
        x = self.sh(enc_embeds, "batch", "frames", None)
        x, _ = self._run_blocks(x, enc["blocks"], mode="encode",
                                cycle=ENCODER_CYCLE)
        return L.apply_norm(x, enc["final_norm"], self.cfg)

    def head_weights(self, params):
        """(d_model, vocab) output projection, constrained to (replicated,
        vocab-sharded), as the reference's."""
        w = params["embed"].T if self.cfg.tie_embeddings \
            else params["lm_head"]
        return self.sh(w, None, "vocab")

    def _head(self, x, params):
        cfg = self.cfg
        x = L.apply_norm(x, params["final_norm"], cfg)
        logits = x @ self.head_weights(params)
        logits = L.softcap(logits.to(f32), cfg.final_softcap)
        return self.sh(logits, "batch", "seq", "vocab")

    def _embed(self, params, tokens):
        cfg = self.cfg
        tokens = self.sh(tokens, "batch", "seq")
        # an embedding, not an index: DTensor (torch 2.11) has no working
        # rule for the index's backward (index_put) on a sharded table
        x = F.embedding(tokens, params["embed"]).to(DTYPES[cfg.dtype])
        if cfg.embed_scale:
            x = x * math.sqrt(cfg.d_model)
        return self.sh(x, "batch", "act_seq", None)

    # ------------------------------------------------------------ entries
    def _inference(self):
        """``inference_mode``, or ``no_grad`` for a sharded model: DTensor
        views cannot be made under ``inference_mode``."""
        return torch.inference_mode() if self.sh.mesh is None \
            else torch.no_grad()

    def forward_hidden(self, params, tokens, enc_embeds=None):
        """The train pass, with autograd: final-norm hidden states
        (b, s, d) and the aux loss (the MoE blocks' sum, 0 without MoE);
        no logits are formed.
        Reference: ``repro/models/model.py::Model.forward_hidden``."""
        cfg = self.cfg
        with self.sh.region():
            enc_out = self.encode(params, enc_embeds) if self.cfg.encoder \
                else None
            x = self._embed(params, tokens)
            x, aux = self._run_blocks(x, params["blocks"], mode="train",
                                      enc_out=enc_out)
            x = L.apply_norm(x, params["final_norm"], cfg)
            # regather the sequence for the (vocab-parallel) chunked loss
            return self.sh(x, "batch", "seq", None), aux

    def forward(self, params, tokens, enc_embeds=None):
        """Teacher-forced pass -> (logits (b,s,V) fp32, aux loss)."""
        with self._inference(), self.sh.region():
            enc_out = self.encode(params, enc_embeds) if self.cfg.encoder \
                else None
            x = self._embed(params, tokens)
            x, aux = self._run_blocks(x, params["blocks"], mode="train",
                                      enc_out=enc_out)
            return self._head(x, params), aux

    def prefill(self, params, tokens, cache_len: int | None = None,
                enc_embeds=None):
        """Build the cache; returns (last-position logits (b,V), cache)."""
        cache_len = cache_len or tokens.shape[1]
        with self._inference(), self.sh.region():
            cache = self._new_cache(tokens.shape[0], cache_len)
            enc_out = self.encode(params, enc_embeds) if self.cfg.encoder \
                else None
            x = self._embed(params, tokens)
            x, _ = self._run_blocks(x, params["blocks"], mode="prefill",
                                    cache=cache, enc_out=enc_out)
            return self._head(x[:, -1:], params)[:, 0], cache

    def decode_step(self, params, cache, tokens, pos):
        """One token step. tokens: (b,), pos: (b,) -> (logits (b,V), cache).

        The cache is updated in place (and returned)."""
        with self._inference(), self.sh.region():
            x = self._embed(params, tokens[:, None])
            x, _ = self._run_blocks(x, params["blocks"], mode="decode",
                                    cache=cache, pos=pos)
            return self._head(x, params)[:, 0], cache
