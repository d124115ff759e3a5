"""Logical-axis sharding on ``torch.distributed``: one rule table maps model
semantics to mesh axes.

Every parameter/activation dimension carries a logical name ("embed",
"heads", "mlp", ...).  A ``Sharder`` resolves names to mesh axes with
divisibility checking and per-tensor duplicate avoidance.  The rule table,
``_axes_in_mesh`` and ``Sharder.resolve`` are the reference's
(``repro/parallel/sharding.py``) as written; ``resolve`` returns a
``PartitionSpec``, a tuple standing in for JAX's, entry for entry.

Rules are *preference chains*: ``"experts": (("model",), ("data",))`` tries
expert-parallelism over ``model`` first, falls back to ``data``, then
replicates — so the same table serves dbrx (16 experts, EP=16) and granite
(40 experts, replicated expert axis but sharded d_ff) without per-arch code.

The torch half places tensors on a ``DeviceMesh`` with named dims as
DTensors: ``placements`` turns a spec into one placement per mesh dim,
``distribute`` places a param or state tree, ``constrain`` (``__call__``)
redistributes an activation (the reference's ``with_sharding_constraint``;
unchanged without a mesh), and ``local_call`` runs a function on each
rank's shards (the hand-written kernels take plain tensors).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models.param import tree_map


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (replicated), a mesh axis name, or a tuple of
    names (the dim split over those axes jointly, the first major).
    Trailing ``None``s are trimmed, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# logical axis -> chain of candidate mesh-axis groups (each group is used
# jointly, e.g. batch over pod AND data).
DEFAULT_RULES: dict = {
    # parameters
    "vocab": (("model",),),
    "embed": (("data",),),                  # FSDP axis
    "mlp": (("model",),),                   # TP axis
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (),
    "experts": (("model",), ("data",)),     # EP preference chain
    "layers": (),                           # scan dim never sharded
    # activations
    "batch": (("pod", "data"),),
    "seq": (),
    # cycle-boundary activations (= remat residuals): sequence dim sharded
    # over the TP axis so saved activations are 16x smaller (Megatron-SP)
    "act_seq": (("model",),),
    # score q-dim fallback sharding for archs whose head count does not
    # divide the TP axis (granite: 24 heads on model=16); the port's
    # kernels form no scores, so it constrains nothing here (ROADMAP C-l)
    "attn_q": (("model",),),
    "kvseq": (),                            # set to (("data",),) for 500k decode
    "frames": (),
    None: (),
}


def _axes_in_mesh(group, mesh_axes: dict) -> tuple:
    return tuple(a for a in group if a in mesh_axes)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> tuple:
    """One DTensor placement per dim of ``mesh``: ``Shard(d)`` where that
    mesh axis appears in entry ``d`` of ``spec``, else ``Replicate()``.  A
    dim over several axes takes ``Shard(d)`` on each, nested in mesh-dim
    order, so its axes must come in that order (major first)."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_offset(x, dim: int) -> int:
    """Global index of the first element of this rank's shard of ``x``
    along ``dim`` (0 for a plain tensor)."""
    if not isinstance(x, DTensor):
        return 0
    _, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return offset[dim]


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


@dataclass
class Sharder:
    mesh_axes: dict                       # name -> size, e.g. {"data":16,...}
    rules: dict = field(default_factory=lambda: dict(DEFAULT_RULES))
    mesh: object = None                   # DeviceMesh; None: resolve only

    @staticmethod
    def for_mesh(mesh, overrides: dict | None = None) -> "Sharder":
        rules = dict(DEFAULT_RULES)
        rules.update(overrides or {})
        return Sharder(dict(zip(mesh.mesh_dim_names, mesh.shape)), rules,
                       mesh)

    @staticmethod
    def null() -> "Sharder":
        """Single-device: everything replicated (smoke tests)."""
        return Sharder({})

    # ------------------------------------------------------------ resolution
    def resolve(self, axes: tuple, shape: tuple) -> PartitionSpec:
        """Logical axes tuple -> PartitionSpec, divisible + duplicate-free."""
        used: set = set()
        out = []
        for name, dim in zip(axes, shape):
            chain = self.rules.get(name, ())
            picked = None
            for group in chain:
                grp = tuple(a for a in _axes_in_mesh(group, self.mesh_axes)
                            if a not in used)
                if not grp:
                    continue
                total = math.prod(self.mesh_axes[a] for a in grp)
                if dim % total == 0:
                    picked = grp
                    used.update(grp)
                    break
            out.append(picked if picked is None or len(picked) > 1
                       else picked[0])
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(*out)

    def template_pspecs(self, tpl):
        """Param template -> tree of PartitionSpec."""
        return tree_map(lambda s: self.resolve(s.axes, s.shape), tpl)

    # ---------------------------------------------------------- placements
    def placements(self, axes: tuple, shape: tuple) -> tuple:
        return placements(self.resolve(axes, shape), self.mesh)

    def distribute(self, tree, tpl):
        """Place a tree of global tensors (every rank holds the same) as
        DTensors, each leaf by its ``ParamSpec``'s axes in ``tpl``; each
        rank keeps its shard, with no communication."""
        if self.mesh is None:
            return tree
        if isinstance(tree, dict):
            return {k: self.distribute(v, tpl[k]) for k, v in tree.items()}
        return distribute_tensor(
            tree, self.mesh, self.placements(tpl.axes, tpl.shape),
            src_data_rank=None)

    def full(self, shape: tuple, axes: tuple, fill, dtype, device):
        """A tensor of global ``shape`` filled with ``fill`` (``None``:
        uninitialised), laid out by ``axes``: each rank allocates only its
        own shard."""
        if self.mesh is None:
            local, pl = shape, None
        else:
            pl = self.placements(axes, shape)
            local, _ = compute_local_shape_and_global_offset(shape, self.mesh,
                                                             pl)
        t = torch.empty(local, dtype=dtype, device=device) if fill is None \
            else torch.full(local, fill, dtype=dtype, device=device)
        if pl is None:
            return t
        return DTensor.from_local(t, self.mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_strides(shape))

    def constrain(self, x, *axes):
        """Sharding constraint on an activation: ``x`` redistributed to the
        placements of ``axes`` (a plain tensor is taken as replicated).
        Unchanged without a mesh."""
        if self.mesh is None:
            return x
        want = self.placements(tuple(axes), tuple(x.shape))
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh,
                                   [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        if tuple(x.placements) != want:
            x = x.redistribute(self.mesh, want)
        return x

    def __call__(self, x, *axes):
        return self.constrain(x, *axes)

    def region(self):
        """Context of a sharded computation, its backward included: a plain
        tensor made inside it (positions, masks, zeros) takes part as
        replicated.  Nothing without a mesh, or inside another region
        (``implicit_replication`` does not nest: its exit turns it off)."""
        if self.mesh is None or \
                DTensor._op_dispatcher._allow_implicit_replication:
            return contextlib.nullcontext()
        return implicit_replication()

    def local_call(self, fn, args, outs):
        """``fn`` on each rank's shards.  ``args``: (tensor or None, logical
        axes) pairs; each tensor is constrained to its axes and passed as
        its local shard.  ``outs``: (logical axes, global shape) of each
        output of ``fn`` (a tensor or a tuple).  Without a mesh:
        ``fn(*tensors)``.

        Gradients: an input replicated over a mesh dim along which an
        output is sharded gets a partial (summed) gradient there, since
        each rank used it for its own part; otherwise the input's own
        placements."""
        if self.mesh is None:
            return fn(*(t for t, _ in args))
        out_pls = [self.placements(ax, shape) for ax, shape in outs]
        split = {i for pl in out_pls for i, p in enumerate(pl)
                 if p.is_shard()}
        locs = []
        for t, axes in args:
            if t is None:
                locs.append(None)
                continue
            t = self.constrain(t, *axes)
            grad_pl = [Partial() if p.is_replicate() and i in split else p
                       for i, p in enumerate(t.placements)]
            locs.append(t.to_local(grad_placements=grad_pl))
        res = fn(*locs)
        if not outs:
            return res
        single = isinstance(res, torch.Tensor)
        wrapped = tuple(
            DTensor.from_local(r, self.mesh, pl, run_check=False,
                               shape=torch.Size(shape),
                               stride=_contiguous_strides(shape))
            for r, pl, (_, shape) in zip((res,) if single else res, out_pls,
                                         outs))
        return wrapped[0] if single else wrapped
