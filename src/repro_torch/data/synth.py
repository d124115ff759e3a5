# Copy of repro/data/synth.py; the port imports nothing of repro.
"""Synthetic token corpus written into an LST table (Scenario-1 style import).

Rows are packed sequences of ``pack_len`` int32 tokens, partitioned by
``shard`` so multi-host loaders stripe cleanly. The generator is a small
in-vocab Markov chain so a model can actually *learn* structure (loss drops
measurably in the end-to-end example, unlike uniform noise).
"""

from __future__ import annotations

import numpy as np

from repro_torch.lst.schema import Field, PartitionSpec, Schema
from repro_torch.lst.table import LakeTable

CORPUS_SCHEMA = Schema([
    Field("tokens", "int32"), Field("doc_id", "int64"), Field("shard", "string"),
])


def _markov_tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    """Tokens with learnable bigram structure: t+1 ~ f(t) + noise."""
    base = rng.integers(0, vocab, size=n, dtype=np.int32)
    out = np.empty(n, np.int32)
    out[0] = base[0]
    # deterministic successor for 85% of steps
    succ = (np.arange(vocab, dtype=np.int64) * 31 + 7) % vocab
    use_succ = rng.random(n) < 0.85
    for i in range(1, n):
        out[i] = succ[out[i - 1]] if use_succ[i] else base[i]
    return out


def write_synth_corpus(fs, base_path: str, *, fmt: str = "delta",
                       n_docs: int = 64, pack_len: int = 129,
                       vocab: int = 256, n_shards: int = 4,
                       seed: int = 0) -> LakeTable:
    rng = np.random.default_rng(seed)
    table = LakeTable.create(fs, base_path, CORPUS_SCHEMA, fmt,
                             PartitionSpec(["shard"]))
    toks = np.stack([_markov_tokens(rng, pack_len, vocab)
                     for _ in range(n_docs)])
    table.append({
        "tokens": toks.astype(np.int32),
        "doc_id": np.arange(n_docs, dtype=np.int64),
        "shard": np.array([f"s{i % n_shards}" for i in range(n_docs)]),
    })
    return table
