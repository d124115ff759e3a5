"""Per-device cost of one step, counted on the meta device: the port's
counterpart of the reference's ``launch/hlo_analysis.py``.

There is no HLO to walk: the dry run runs a step once on ``meta`` DTensors
(no data, no device) under ``CostCounter``, a dispatch mode that sees every
op on each rank's *local* shards — it steps aside for DTensor (returns
``NotImplemented``) and counts the local ops DTensor emits, so the counts
are one device's, not the global ones.  Per op:

* dot FLOPs from ``torch.utils.flop_counter``'s formulas (matmuls, bmm,
  convolutions), elementwise FLOPs = output elements of a pointwise op or
  input elements of a reduction;
* HBM bytes = every tensor operand read once and every result written
  once (views and allocations move none): eager PyTorch fuses nothing, so
  this is the port's own traffic, not an idealised fused program's;
* collectives (the functional collectives DTensor emits) by kind, with
  ring-model bytes per device ((n-1)/n of the buffer; an all-reduce twice)
  and the group's reach: **NVLink** if every rank of the group sits in one
  node of ``NODE_GPUS`` consecutive ranks, else **network** (the port's
  ICI / DCN split);
* live bytes of the storages made during the step (freed when their last
  tensor goes), whose peak is the step's temporary memory.

The hand-written kernels are counted by formula, whatever device runs
them: each is an operator ``torch.ops.repro_torch.<name>``
(``kernels/*/ops.py``), which the counter intercepts before its
implementation runs; ``KERNELS`` gives, from the operator's arguments,
its outputs (empty, of the right shape) and its useful work.  The
formulas are the ones ``chip_smoke.py`` takes for each kernel's bound.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

NODE_GPUS = 8        # GPUs of one node, joined by NVLink (H100 HGX)


# --------------------------------------------------------- kernel formulas
def flash_visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the flash kernel computes: query i sees keys
    0..min(i, sk-1) (causal), or within ``window`` of it, or all keys."""
    qpos = np.arange(sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, qpos - window + 1) if (causal and window) \
        else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(b, sq, sk, h, kv, dh, causal, window, itemsize=2) -> tuple:
    """(FLOPs, bytes) of one flash forward: QKᵀ and PV over the visible
    pairs; q, k, v read and out written once."""
    flops = 4.0 * b * h * dh * flash_visible_pairs(sq, sk, causal, window)
    return flops, itemsize * (2 * b * sq * h * dh + 2 * b * sk * kv * dh)


def flash_bwd_work(b, sq, sk, h, kv, dh, causal, window,
                   itemsize=2) -> tuple:
    """(FLOPs, bytes) of one flash backward: its five products over the
    visible pairs (2.5x the forward's); q, k, v, out, dout and the fp32
    lse read, dq, dk, dv written, each once."""
    flops = 2.5 * 4.0 * b * h * dh * flash_visible_pairs(sq, sk, causal,
                                                         window)
    qb, kb = b * sq * h * dh, b * sk * kv * dh
    return flops, itemsize * (4 * qb + 4 * kb) + 4 * b * h * sq


def decode_work(rows: int, b, h, kv, dh, itemsize=2) -> tuple:
    """(FLOPs, bytes) of one decode call over ``rows`` cache rows in all
    (the sum of the sequences' visible lengths): k and v of those rows,
    q and out, and the int32 lengths, each once."""
    return (4.0 * h * dh * rows,
            2 * rows * kv * dh * itemsize + 2 * b * h * dh * itemsize + 4 * b)


def ssd_work(b, s, h, p, g, n, chunk, itemsize=2, init=False) -> tuple:
    """(FLOPs, bytes) of one SSD chunk scan: the intra-chunk and state
    products; x and y, dt and A (fp32), B and C, the final fp32 state (and
    the initial one, if given), each moved once."""
    q = min(chunk, s)
    nc = s // q
    flops = 2.0 * q * p * (q + 2 * n) * b * h * nc \
        + 2.0 * q * q * n * b * g * nc
    state = 4 * b * h * n * p
    nbytes = 2 * b * s * h * p * itemsize + 4 * b * s * h + 4 * h \
        + 2 * b * s * g * n * itemsize + state * (2 if init else 1)
    return flops, nbytes


def ssd_bwd_work(b, s, h, p, g, n, chunk, itemsize=2, init=False,
                 dstate=False) -> tuple:
    """(FLOPs, bytes) of one SSD chunk-scan backward.  FLOPs: per head and
    chunk, over the q(q+1)/2 (query, key) pairs of the causal chunk, dy x'^T,
    the dx' and dB and dC products (2 q(q+1) (p + p + n + n)), and the five
    n x p products over the chunk's rows (the states entering it, the state
    gradient of its outputs, and the state terms of dx', dB and dC: 10 q n
    p); per group C B^T over the pairs (q(q+1) n).  Bytes: x, dy and dx, B,
    C, dB and dC in ``itemsize``, dt and ddt, A and dA fp32 (and init,
    dstate, dinit if given), each moved once."""
    q = min(chunk, s)
    nc = s // q
    pairs = q * (q + 1) / 2
    flops = (2.0 * pairs * (2 * p + 2 * n) + 10.0 * q * n * p) * b * h * nc \
        + 2.0 * pairs * n * b * g * nc
    state = 4 * b * h * n * p
    nbytes = 3 * b * s * h * p * itemsize + 4 * b * s * g * n * itemsize \
        + 2 * 4 * b * s * h + 2 * 4 * h + state * (2 * int(init) + int(dstate))
    return flops, nbytes


def _flash(q, k, v, causal, window, softcap, with_lse):
    b, sq, h, dh = q.shape
    lse = q.new_empty((b, h, sq) if with_lse else (0,), dtype=torch.float32)
    return ((torch.empty_like(q), lse),
            flash_work(b, sq, k.shape[1], h, k.shape[2], dh, causal, window,
                       q.element_size()))


def _flash_bwd(q, k, v, o, dout, lse, causal, window, softcap):
    b, sq, h, dh = q.shape
    return ((torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)),
            flash_bwd_work(b, sq, k.shape[1], h, k.shape[2], dh, causal,
                           window, q.element_size()))


def _decode(q, k_cache, v_cache, lengths, window, softcap):
    """Counted over a full cache (every row within the window): a meta
    run has no lengths to read."""
    b, h, dh = q.shape
    S, kv = k_cache.shape[1], k_cache.shape[2]
    rows = b * (min(window, S) if window else S)
    return (torch.empty_like(q),
            decode_work(rows, b, h, kv, dh, q.element_size()))


def _ssd(x, dt, A, B, C, chunk, init):
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    return ((x.new_empty((b, s, h, p)),
             x.new_empty((b, h, n, p), dtype=torch.float32)),
            ssd_work(b, s, h, p, g, n, chunk, x.element_size(),
                     init is not None))


def _ssd_bwd(x, dt, A, B, C, dy, chunk, init, dstate):
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    f32 = torch.float32
    return ((torch.empty_like(x), dt.new_empty((b, s, h), dtype=f32),
             A.new_empty((h,), dtype=f32), torch.empty_like(B),
             torch.empty_like(C), x.new_empty((b, h, n, p), dtype=f32)),
            ssd_bwd_work(b, s, h, p, g, n, chunk, x.element_size(),
                         init is not None, dstate is not None))


# operator name in ``torch.ops.repro_torch`` -> its arguments -> (outputs,
# (FLOPs, bytes))
KERNELS = {"flash_attention": _flash, "flash_attention_bwd": _flash_bwd,
           "decode_attention": _decode, "ssd_chunk_scan": _ssd,
           "ssd_chunk_scan_bwd": _ssd_bwd}


# ------------------------------------------------------------- the counter
_FREE_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_local_scalar_dense", "wait_tensor"}
_SOFTMAX_OPS = {"_softmax", "_log_softmax", "_softmax_backward_data",
                "_log_softmax_backward_data", "cumsum", "logsumexp"}
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts one device's FLOPs, HBM bytes, collectives and temporary
    memory of the ops run inside it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.elem_flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives: dict = {}     # (kind, bytes, group, net) -> count
        self.kernels: dict = {}         # name -> [calls, flops, bytes]
        self.live = 0
        self.peak = 0
        self._tracked: dict = {}        # storage key -> bytes
        self._groups: dict = {}         # group name -> (size, crosses node)

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # count the local ops DTensor emits
        if func.namespace == "repro_torch":
            # a hand-written kernel: counted by formula, never run
            name = func._overloadpacket.__name__
            out, (flops, nbytes) = KERNELS[name](*args, **kwargs)
            self.add_kernel(name, flops, nbytes)
            self._track(_tensors(out))
            return out
        if func._overloadpacket not in flop_registry:
            # a composite op (``matmul`` under inference_mode reaches the
            # mode whole): count the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        # DTensor derives each result's global shape by running the op on
        # fake global-shape tensors: not work of this device
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is None:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            if name in _COLLECTIVES:
                self._collective(_COLLECTIVES[name], args, out)
            return
        outs = list(_tensors(out))
        ins = list(_tensors((args, kwargs)))
        if not func.is_view:
            # a view's or an in-place op's result is no new storage
            held = {t.untyped_storage()._cdata for t in ins}
            self._track(t for t in outs
                        if t.untyped_storage()._cdata not in held)
        if func.is_view or name in _FREE_OPS:
            return
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.dot_flops += float(fn(*args, **kwargs, out_val=out))
        elif torch.Tag.pointwise in func.tags:
            self.elem_flops += sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags or name in _SOFTMAX_OPS:
            self.elem_flops += sum(t.numel() for t in ins[:1])
        self.hbm_bytes += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        rec = self.kernels.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        self.dot_flops += flops
        self.hbm_bytes += nbytes

    # -------------------------------------------------------- collectives
    def _group(self, group_name) -> tuple:
        if group_name not in self._groups:
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(group_name))
            self._groups[group_name] = (
                len(ranks), len({r // NODE_GPUS for r in ranks}) > 1)
        return self._groups[group_name]

    def _collective(self, kind: str, args, out) -> None:
        n, net = self._group(args[-1])
        ring = (n - 1) / n if n > 1 else 0.0
        inb, outb = _nbytes(args[0]), _nbytes(out)
        moved = {"all-reduce": 2.0 * inb, "all-gather": float(outb)}.get(
            kind, float(inb)) * ring
        key = (kind, moved, n, net)
        self.collectives[key] = self.collectives.get(key, 0) + 1
        self._track([out])

    # ------------------------------------------------------------- memory
    def _track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._tracked:
                continue
            self._tracked[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._tracked.pop(key, 0)

    # ------------------------------------------------------------ summary
    def summary(self) -> dict:
        """Plain-dict summary (JSON-friendly): the reference's keys, with
        its ICI / DCN bytes as NVLink / network bytes."""
        by_kind: dict = {}
        nvlink = net = 0.0
        for (kind, moved, _, crosses), count in self.collectives.items():
            by_kind[kind] = by_kind.get(kind, 0.0) + moved * count
            if crosses:
                net += moved * count
            else:
                nvlink += moved * count
        top = sorted(self.collectives.items(),
                     key=lambda kv: -kv[0][1] * kv[1])
        return {
            "flops": self.dot_flops + self.elem_flops,
            "dot_flops": self.dot_flops,
            "elem_flops": self.elem_flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_nvlink_bytes": nvlink,
            "coll_net_bytes": net,
            "coll_by_kind": by_kind,
            "n_collectives": sum(self.collectives.values()),
            "top_collectives": [
                {"kind": kind, "bytes": moved, "mult": count, "group": n,
                 "net": crosses}
                for (kind, moved, n, crosses), count in top[:20]],
            "kernels": {name: {"calls": c, "flops": f, "bytes": b}
                        for name, (c, f, b) in self.kernels.items()},
            "temp_peak_bytes": self.peak,
        }


def analyze(fn, *args) -> tuple:
    """Run ``fn(*args)`` once under a ``CostCounter`` -> (its result, the
    counter's summary)."""
    counter = CostCounter()
    with counter:
        out = fn(*args)
    return out, counter.summary()
