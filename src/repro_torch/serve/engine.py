"""Batched serving engine: synchronous prefill + decode with greedy or
temperature sampling, over the port's model.

The reference engine also restores its weights through a lake view
(``from_lake``); that needs the lake layer, which the port has not copied
yet, so here the weights are given (``init_params`` or
``params_from_jax``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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
