"""(architecture x input-shape) cells: step functions and their inputs, laid
out by the cell's ``Sharder``.

``build_cell`` returns the train, prefill or decode step of a cell and its
arguments as ``meta`` DTensors on the mesh — nothing is allocated; the dry
run calls the step on them once.  The arithmetic (``LONG_CONTEXT_ARCHS``,
``is_applicable``, ``attn_intermediate_bytes``, ``_counted_params``,
``make_cell_sharder``, ``_arch_cfg``) is the reference's
(``repro/launch/cells.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config
from repro_torch.device import DTYPES
from repro_torch.models.config import ShapeCell, get_shape_cell
from repro_torch.models.model import Model
from repro_torch.models.param import ParamSpec, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.parallel.sharding import Sharder
from repro_torch.train.loop import make_train_step, train_state_template

# long_500k needs sub-quadratic attention; these archs are pure full
# attention so the cell is skipped (the reference's DESIGN.md
# §Arch-applicability)
LONG_CONTEXT_ARCHS = ("gemma2-27b", "jamba-v0.1-52b", "mamba2-2.7b")


def is_applicable(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, ("pure full-attention architecture: 512k KV decode "
                       "requires sub-quadratic attention (see DESIGN.md)")
    return True, ""


def attn_intermediate_bytes(cfg, cell, sh: Sharder) -> float:
    """Per-device HBM bytes of materialized attention intermediates on the
    reference's XLA path (f32 scores write+read by softmax, bf16 probs
    write+read by the PV matmul = 12 B per visible (q,k) pair; x3 on the
    train path for recompute + backward).  The port's kernels form none;
    the record keeps it for comparison with the reference's roofline."""
    specs = cfg.layer_specs()
    attn_layers = [s for s in specs if s.kind == "attn"]
    if not attn_layers or cfg.n_heads == 0:
        return 0.0

    def _div(spec) -> int:
        d = 1
        for ax in list(spec):
            for a in (ax if isinstance(ax, tuple) else ((ax,) if ax else ())):
                d *= sh.mesh_axes.get(a, 1)
        return max(d, 1)

    h_loc = cfg.n_heads // _div(sh.resolve(("heads",), (cfg.n_heads,)))
    b_loc = max(1, cell.global_batch //
                _div(sh.resolve(("batch",), (cell.global_batch,))))

    total_pairs = 0.0
    s = cell.seq_len
    for spec in attn_layers:
        if cell.step == "decode":
            klen = min(spec.window, s) if spec.window else s
            pairs = float(klen)                     # one query token
        else:
            nq = max(1, min(cfg.attn_q_blocks, s))
            qb = s // nq
            pairs = 0.0
            for i in range(nq):
                q_lo = i * qb
                k_hi = min(q_lo + qb, s)
                k_lo = max(0, q_lo - spec.window) if spec.window else 0
                pairs += qb * (k_hi - k_lo)
        total_pairs += pairs * b_loc * h_loc
    mult = 3.0 if cell.step == "train" else 1.0
    return total_pairs * 12.0 * mult


@dataclass
class CellBuild:
    arch: str
    shape: str
    step_name: str
    fn: object
    args: tuple                 # meta DTensor trees
    in_specs: tuple             # PartitionSpec trees, one per argument
    model: Model
    cell: ShapeCell
    n_params: int
    n_active_params: int
    attn_hbm_bytes: float = 0.0   # XLA-path attention intermediates/device

    @property
    def argument_bytes(self) -> int:
        """Bytes of this device's shards of every argument."""
        return sum(_local(t).numel() * t.element_size()
                   for arg in self.args for t in tree_leaves(arg))


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path, tree


def _counted_params(model: Model) -> tuple[int, int]:
    """(total, active) parameter counts; active discounts unrouted experts."""
    cfg = model.cfg
    total = expert = 0
    for keys, leaf in _paths(model.param_template()):
        n = math.prod(leaf.shape)
        total += n
        if any(k in ("w_in", "w_gate", "w_out") for k in keys) and \
                cfg.n_experts:
            expert += n
    active = total - int(expert * (1 - cfg.top_k / max(cfg.n_experts, 1)))
    return total, active


# sub-1B models: TP over 16 ways is counterproductive — prefer widening data
# parallelism onto the model axis (params are small enough to replicate
# across it; activations shard fully).
_PURE_DP_ARCHS = ("whisper-small",)


def make_cell_sharder(mesh, arch: str, shape: str) -> Sharder:
    overrides = {}
    if shape == "long_500k":
        overrides["kvseq"] = (("data",),)   # sequence-parallel 512k KV
    if arch in _PURE_DP_ARCHS:
        overrides.update({
            "batch": (("pod", "data", "model"), ("pod", "data")),
            "embed": (),                     # replicate the small params
            "act_seq": (),
        })
    return Sharder.for_mesh(mesh, overrides)


def _arch_cfg(arch: str, shape: str):
    cfg = get_config(arch)
    if shape == "long_500k":
        cfg = cfg.with_updates(long_context_seq_shard=True)
    return cfg


def _meta(sh: Sharder, tpl):
    """``meta`` DTensors of a ``ParamSpec`` tree, laid out by ``sh``."""
    return tree_map(lambda s: sh.full(s.shape, s.axes, None, DTYPES[s.dtype],
                                      "meta"), tpl)


def build_cell(arch: str, shape: str, mesh, *,
               grad_accum: int = 1) -> CellBuild:
    ok, why = is_applicable(arch, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape} skipped: {why}")
    return build_step(_arch_cfg(arch, shape), get_shape_cell(shape),
                      make_cell_sharder(mesh, arch, shape),
                      grad_accum=grad_accum)


def build_step(cfg, cell: ShapeCell, sh: Sharder, *,
               grad_accum: int = 1) -> CellBuild:
    """The step of ``cell`` for the model ``cfg``, its arguments ``meta``
    tensors laid out by ``sh`` (``Sharder.null()``: one device)."""
    arch, shape = cfg.name, cell.name
    model = Model(cfg, sh, device="meta")
    n_params, n_active = _counted_params(model)
    attn_hbm = attn_intermediate_bytes(cfg, cell, sh)

    ptpl = model.param_template()
    params = _meta(sh, ptpl)
    params_pspecs = sh.template_pspecs(ptpl)
    b, s = cell.global_batch, cell.seq_len
    tok_tpl = ParamSpec((b, s), ("batch", "seq"), "int32")
    enc_tpl = ParamSpec((b, cfg.encoder.n_frames, cfg.d_model),
                        ("batch", "frames", None), cfg.dtype) \
        if cfg.encoder else None
    common = dict(model=model, cell=cell, n_params=n_params,
                  n_active_params=n_active, attn_hbm_bytes=attn_hbm)

    if cell.step == "train":
        _, otpl = train_state_template(model)
        btpl = {"inputs": tok_tpl, "targets": tok_tpl}
        if enc_tpl:
            btpl["enc_embeds"] = enc_tpl
        step = make_train_step(model, AdamWConfig(), grad_accum=grad_accum)
        return CellBuild(
            arch, shape, "train_step", step,
            (params, _meta(sh, otpl), _meta(sh, btpl)),
            (params_pspecs, sh.template_pspecs(otpl),
             sh.template_pspecs(btpl)), **common)

    if cell.step == "prefill":
        args = [params, _meta(sh, tok_tpl)]
        specs = [params_pspecs, sh.template_pspecs(tok_tpl)]
        if enc_tpl:
            args.append(_meta(sh, enc_tpl))
            specs.append(sh.template_pspecs(enc_tpl))

        def fn(params, tokens, enc=None):
            return model.prefill(params, tokens, cache_len=s, enc_embeds=enc)

        return CellBuild(arch, shape, "prefill_step", fn, tuple(args),
                         tuple(specs), **common)

    # decode: one new token against a cache of length seq_len
    cache_tpl = model.cache_template(b, s)
    vec_tpl = ParamSpec((b,), ("batch",), "int32")

    def fn(params, cache, tokens, posv):
        return model.decode_step(params, cache, tokens, posv)

    return CellBuild(
        arch, shape, "serve_step", fn,
        (params, _meta(sh, cache_tpl), _meta(sh, vec_tpl),
         _meta(sh, vec_tpl)),
        (params_pspecs, sh.template_pspecs(cache_tpl),
         sh.resolve(("batch",), (b,)), sh.resolve(("batch",), (b,))),
        **common)


def input_specs(arch: str, shape: str, mesh) -> dict:
    """Public helper: the meta inputs of the cell and their specs."""
    cb = build_cell(arch, shape, mesh)
    return {"step": cb.step_name, "args": cb.args, "in_specs": cb.in_specs}
