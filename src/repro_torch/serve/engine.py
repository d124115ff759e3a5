"""Batched serving engine restoring weights through an XTable-translated view.

Scenario 3 transplanted: the trainer commits checkpoints in one format's
metadata; the *server* opens the same directory through ANY translated
view (e.g. Iceberg).  No weight files are copied.
:meth:`ServeEngine.from_lake` restores three ways, as the reference engine
does: from a raw base path, through the read plane's pinned snapshots
(``read_plane=``), or by catalog NAME (``catalog=`` + ``table=``).  The
weights may also be given directly (``init_params`` or
``params_from_jax``).

The engine itself: synchronous batched prefill + decode with greedy or
temperature sampling, over the port's model.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.checkpoint import LSTCheckpointManager
from repro_torch.models.model import Model


@dataclass
class Request:
    prompt: list            # token ids
    max_new: int = 16


class ServeEngine:
    """Serves ``model`` on ``model.device`` (the card unless the model was
    built with ``device="cpu"``); ``params`` must live there too."""

    def __init__(self, model: Model, params, *, cache_len: int = 256):
        if params["embed"].device != model.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"model on {model.device}")
        self.model = model
        self.params = params
        self.cache_len = cache_len
        self.device = model.device

    @classmethod
    def from_lake(cls, model: Model, fs, ckpt_path: str | None = None, *,
                  fmt: str = "iceberg", cache_len: int = 256,
                  read_plane=None, catalog=None,
                  table: str | None = None) -> "ServeEngine":
        """Restore weights through the translated ``fmt`` view onto
        ``model.device``.

        With a ``read_plane`` (:class:`~repro_torch.serve.read_plane
        .SnapshotServer`) the checkpoint table resolves through a memoized
        head-keyed snapshot instead of a private metadata replay.

        With a ``catalog`` (:class:`~repro_torch.lst.catalog.Catalog`) the
        table is addressed by registered ``table`` *name*: the catalog
        pointer supplies the base path and the published ``(token,
        commit)`` pin for the requested view, so the restore observes
        exactly the atomically published head.  (The pin rides the read
        plane; a catalog without a ``read_plane`` still resolves the path
        by name but restores the live head.)
        """
        table_state = None
        if catalog is not None:
            if table is None:
                raise ValueError("catalog-based restore needs table=<name>")
            ptr = catalog.resolve(table)
            ckpt_path = ptr.base_path
            ref = ptr.view(fmt)
            if read_plane is not None:
                table_state = read_plane.read_at(ckpt_path, fmt,
                                                 ref.token, ref.commit).state
        elif ckpt_path is None:
            raise ValueError("need ckpt_path (or catalog= + table=)")
        elif read_plane is not None:
            table_state = read_plane.read(ckpt_path, fmt).snapshot.state
        mgr = LSTCheckpointManager(fs, ckpt_path, fmt=fmt, sync_targets=())
        _, state = mgr.restore_pytree({"params": model.param_template()},
                                      fmt=fmt, state=table_state,
                                      device=model.device)
        return cls(model, state["params"], cache_len=cache_len)

    def generate(self, requests: list, *, temperature: float = 0.0,
                 seed: int = 0) -> list:
        """Synchronous batched generation (greedy when temperature == 0).

        Prompts are left-padded with token ``vocab - 1``, and prefill attends
        to the pads, as in the reference engine."""
        b = len(requests)
        max_prompt = max(len(r.prompt) for r in requests)
        max_new = max(r.max_new for r in requests)
        pad = self.model.cfg.vocab_size - 1
        toks = np.full((b, max_prompt), pad, np.int64)
        for i, r in enumerate(requests):
            toks[i, -len(r.prompt):] = r.prompt      # left-pad
        tokens = torch.from_numpy(toks).to(self.device)
        logits, cache = self.model.prefill(self.params, tokens,
                                           cache_len=self.cache_len)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        outs = [[] for _ in range(b)]
        pos = torch.full((b,), max_prompt, dtype=torch.int64,
                         device=self.device)
        tok = self._sample(logits, temperature, gen)
        for step in range(max_new):
            host = tok.tolist()
            for i in range(b):
                if step < requests[i].max_new:
                    outs[i].append(host[i])
            if step + 1 >= max_new:
                # every request has its tokens; the trailing decode step
                # would be sampled and thrown away
                break
            logits, cache = self.model.decode_step(self.params, cache, tok,
                                                   pos)
            tok = self._sample(logits, temperature, gen)
            pos = pos + 1
        return outs

    @staticmethod
    def _sample(logits, temperature: float, gen: torch.Generator):
        if temperature == 0.0:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits / temperature, -1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
