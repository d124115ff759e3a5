"""Checkpoints as log-structured tables, for the port's tensors.

The reference's manager (``repro/checkpoint/manager.py``) ported to torch,
with the same on-disk format, so a checkpoint written by either package
restores in the other:

* save   = write chunks -> atomic commit -> (async) XTable incremental sync
* restore = pick a snapshot through ANY format's reader, reassemble
* crash-safety = a torn save never commits, so restart sees the previous
  snapshot
* GC     = replace-commit dropping old steps, but only steps already synced
  to every target (a target's snapshot still references their files)

Where it differs from the reference, and why:

* Leaf names come from :func:`leaf_paths`, a walker over nested dicts,
  lists and tuples that gives the names and order of the reference's
  ``jax.tree_util.tree_flatten_with_path`` (dict keys sorted, keys and
  indices joined by ``/``), without JAX.
* ``save`` takes tensors on any device and moves one leaf at a time to the
  host.  bfloat16 is written as its ``uint16`` view under the logical dtype
  ``"bfloat16"`` (the bytes and ``extra`` the reference writes through
  ``ml_dtypes``); ``restore`` reads it back as ``torch.bfloat16``.
* ``restore_pytree`` checks every leaf's shape against the template from
  the commit metadata before it reads a byte, then assembles one leaf at a
  time and places it on ``device``, so the host holds one leaf at a time.
"""

from __future__ import annotations

import json
import math
import threading
import uuid

import numpy as np
import torch

from repro_torch.core import SyncConfig, Telemetry, run_sync
from repro_torch.device import resolve_device
from repro_torch.lst import chunkfile
from repro_torch.lst.schema import Field, PartitionSpec, Schema
from repro_torch.lst.table import FORMATS

CKPT_SCHEMA = Schema([Field("tensor", "binary"), Field("step", "int64")])
MAX_CHUNK_BYTES = 64 * 2**20


def leaf_paths(tree, prefix: str = "") -> list:
    """``[(name, leaf)]`` of a nested dict / list / tuple, in the order and
    with the names of the reference's ``_leaf_paths``: dict keys sorted,
    list and tuple indices in order, ``None`` an empty subtree, anything
    else a leaf."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return []
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += leaf_paths(sub, f"{prefix}/{key}" if prefix else key)
    return out


def _unflatten(template, values: dict, prefix: str = ""):
    """Rebuild ``template``'s structure with ``values[name]`` at each leaf."""
    if isinstance(template, dict):
        return {k: _unflatten(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, values, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    if template is None:
        return None
    return values[prefix]


def _encode(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """One tensor -> (host array to write, logical dtype)."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != logical:
        arr = arr.astype(np.dtype(logical))
    return torch.from_numpy(arr)


class LSTCheckpointManager:
    def __init__(self, fs, base_path: str, *, fmt: str = "hudi",
                 sync_targets: tuple = ("iceberg", "delta"),
                 keep_last: int = 3, async_sync: bool = False,
                 telemetry: Telemetry | None = None):
        self.fs = fs
        self.base = base_path
        self.fmt = fmt
        self.sync_targets = tuple(t for t in sync_targets if t != fmt)
        self.keep_last = keep_last
        self.async_sync = async_sync
        self.telemetry = telemetry or Telemetry()
        self._sync_thread: threading.Thread | None = None
        cls = FORMATS[fmt]
        if cls.exists(fs, base_path):
            self.handle = cls.open(fs, base_path)
        else:
            self.handle = cls.create(fs, base_path, CKPT_SCHEMA,
                                     PartitionSpec(["step"]),
                                     {"table.kind": "checkpoint"})

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra_meta: dict | None = None) -> str:
        """Write one checkpoint commit of a nested dict (or list) of tensors
        on any device; returns the commit id.

        Re-saving an existing step is a replace-commit (old chunk files of
        that step are dropped from the live set atomically with the new
        adds — readers never see a mixed step).
        """
        tag = uuid.uuid4().hex[:8]
        adds = []
        for name, leaf in leaf_paths(tree):
            arr, logical = _encode(leaf)
            flat = arr.reshape(-1)
            n_shards = max(1, -(-flat.nbytes // MAX_CHUNK_BYTES))
            per = -(-flat.size // n_shards)
            for si in range(n_shards):
                part = flat[si * per:(si + 1) * per]
                rel = (f"step={step}/{name.replace('/', '.')}"
                       f"_{si:03d}_{tag}.chunk")
                meta = chunkfile.write_chunk(
                    self.fs, self.base, rel, {"tensor": part},
                    partition_values={"step": str(step)},
                    extra={"leaf": name, "global_shape": list(arr.shape),
                           "dtype": logical, "offset": si * per,
                           "nshards": n_shards})
                adds.append(meta)
            del arr, flat           # one leaf on the host at a time
        stale = [p for p, f in self.handle.snapshot().files.items()
                 if int(f.partition_values["step"]) == step]
        commit = self.handle.commit(
            adds, stale, operation="checkpoint",
            extra_meta={"step": str(step), **(extra_meta or {})})
        self.telemetry.record("ckpt", self.fmt, "save",
                              f"step {step}: {len(adds)} chunks")
        self._kick_sync()
        return commit

    # ------------------------------------------------------------------ sync
    def _sync_config(self) -> SyncConfig:
        return SyncConfig.from_dict({
            "sourceFormat": self.fmt.upper(),
            "targetFormats": [t.upper() for t in self.sync_targets],
            "datasets": [{"tableBasePath": self.base}]})

    def sync_now(self):
        """Run the XTable translation (the trainer never blocks on this)."""
        if not self.sync_targets:
            return []
        return run_sync(self._sync_config(), self.fs, self.telemetry)

    def _kick_sync(self) -> None:
        if not self.sync_targets:
            return
        if not self.async_sync:
            self.sync_now()
            return
        if self._sync_thread and self._sync_thread.is_alive():
            return          # a sync is already running; next save re-kicks
        self._sync_thread = threading.Thread(target=self.sync_now,
                                             daemon=True)
        self._sync_thread.start()

    def wait_for_sync(self) -> None:
        if self._sync_thread:
            self._sync_thread.join()

    # --------------------------------------------------------------- restore
    def steps(self, fmt: str | None = None) -> list[int]:
        handle = self._reader(fmt)
        st = handle.snapshot()
        return sorted({int(f.partition_values["step"])
                       for f in st.files.values()})

    def _reader(self, fmt: str | None):
        fmt = fmt or self.fmt
        if fmt == self.fmt:
            return self.handle
        return FORMATS[fmt].open(self.fs, self.base)

    def latest_meta(self, fmt: str | None = None) -> dict:
        """User metadata of the newest commit, via any format's reader
        (XTable carries source commit metadata through the IR)."""
        handle = self._reader(fmt)
        out = dict(handle.snapshot().properties)
        if hasattr(handle, "latest_extra_metadata"):
            out.update(handle.latest_extra_metadata())
        else:
            try:
                _, _, _, info = handle.changes(handle.current_version())
                out.update({k: v for k, v in info.items()
                            if isinstance(v, str)})
                if isinstance(info.get("xtable"), dict):
                    out.update(info["xtable"])
            except Exception:
                pass
        return out

    def _step_leaves(self, step, fmt, state) -> tuple[int, dict]:
        """(step, {leaf: chunk metas sorted by offset}) of one snapshot."""
        st = state if state is not None else self._reader(fmt).snapshot()
        steps = sorted({int(f.partition_values["step"])
                        for f in st.files.values()})
        if not steps:
            raise FileNotFoundError("no checkpoints")
        step = step if step is not None else steps[-1]
        by_leaf: dict[str, list] = {}
        for f in st.files.values():
            if int(f.partition_values["step"]) != step:
                continue
            by_leaf.setdefault(f.extra["leaf"], []).append(f)
        for metas in by_leaf.values():
            metas.sort(key=lambda m: m.extra["offset"])
        return step, by_leaf

    def _read_leaf(self, metas: list, validate: bool) -> torch.Tensor:
        """Assemble one leaf from its chunks into one host tensor."""
        extra = metas[0].extra
        shape = [int(x) for x in extra["global_shape"]]
        total = math.prod(shape)
        out = None
        pos = 0
        for m in metas:
            cols, _ = chunkfile.read_chunk(self.fs, self.base, m.path)
            arr = cols["tensor"]
            if validate:
                st_ = m.column_stats.get("tensor")
                if st_ is not None and st_.count != arr.shape[0]:
                    raise IOError(f"integrity: {m.path} count mismatch")
            if pos + arr.shape[0] > total:
                raise IOError(f"integrity: {extra['leaf']} has more than "
                              f"{total} elements")
            if out is None:
                out = np.empty(total, arr.dtype)
            out[pos:pos + arr.shape[0]] = arr
            pos += arr.shape[0]
        if pos != total:
            raise IOError(f"integrity: {extra['leaf']} has {pos} of {total} "
                          f"elements")
        return _decode(out, extra["dtype"]).reshape(shape)

    def restore(self, step: int | None = None, *, fmt: str | None = None,
                validate: bool = True, state=None) -> tuple[int, dict]:
        """Reassemble a checkpoint as a flat ``{leaf-path: tensor}`` on the
        host.

        ``fmt`` may be any synced format — restoring through a different
        format than was written is the XTable round-trip.  ``state``
        restores through a pre-resolved ``TableState`` (a read plane's
        pinned snapshot) instead of replaying the format's metadata here —
        the restore then spends storage requests only on the chunk bodies.
        """
        step, by_leaf = self._step_leaves(step, fmt, state)
        return step, {leaf: self._read_leaf(metas, validate)
                      for leaf, metas in by_leaf.items()}

    def restore_pytree(self, template, step: int | None = None,
                       fmt: str | None = None, state=None, *,
                       device=None) -> tuple[int, dict]:
        """Restore into the structure of ``template`` (a nested dict of
        ``ParamSpec``s, tensors or anything with ``.shape``), shape-checked
        against the commit metadata before any chunk is read; each leaf is
        placed on ``device`` (the card unless ``device="cpu"``) as soon as
        it is assembled."""
        dev = resolve_device(device)
        step, by_leaf = self._step_leaves(step, fmt, state)
        names = []
        for name, leaf in leaf_paths(template):
            if name not in by_leaf:
                raise KeyError(f"checkpoint missing leaf {name}")
            have = tuple(int(x) for x in by_leaf[name][0].extra["global_shape"])
            want = tuple(leaf.shape)
            if have != want:
                raise ValueError(f"{name}: shape {have} != {want}")
            names.append(name)
        values = {}
        for name in names:
            host = self._read_leaf(by_leaf[name], True)
            values[name] = host.to(dev)
            del host                # one leaf on the host at a time
        return step, _unflatten(template, values)

    # -------------------------------------------------------------------- gc
    def gc(self) -> list[int]:
        """Drop old steps (keep_last), but never steps the targets still
        reference (GC safety across translated metadata)."""
        steps = self.steps()
        if len(steps) <= self.keep_last:
            return []
        candidates = steps[:-self.keep_last]
        # SAFETY: only collect when every target has been translated up to
        # the CURRENT source head — a lagging target's snapshot still
        # references the candidate steps' files, and deleting them would
        # corrupt that format's view of the single data copy.
        head = self.handle.current_version()
        token_ok = True
        for t in self.sync_targets:
            try:
                reader = self._reader(t)
                props = reader.properties() if t != "hudi" else \
                    reader.latest_extra_metadata()
                tok = props.get("xtable.lastSyncedSourceCommit")
                if tok != head:
                    token_ok = False
            except FileNotFoundError:
                token_ok = False
        if not token_ok:
            self.telemetry.record("ckpt", self.fmt, "gc",
                                  "deferred: targets not fully synced")
            return []
        st = self.handle.snapshot()
        removes = [p for p, f in st.files.items()
                   if int(f.partition_values["step"]) in set(candidates)]
        if removes:
            self.handle.commit([], removes, operation="gc",
                               extra_meta={"gc.steps": json.dumps(candidates)})
            self._kick_sync()
        return candidates
