# Copy of repro/data/pipeline.py; the port imports nothing of repro.
"""Deterministic, resumable data loader over LST tables.

* Reads through ANY format's connector (the engine-flexibility story: the
  same corpus written once is consumed by loaders opening it as Delta,
  Iceberg, or Hudi after an XTable sync).
* Deterministic order: files sorted by path, rows in file order; the loader
  state is a single global row cursor — committed alongside the model
  checkpoint for exact-resume after preemption.
* Straggler mitigation: a background prefetch thread keeps a bounded queue
  of ready batches per host; slow storage reads overlap compute.
* Multi-host striping: host h of H takes rows where (row_idx % H) == h.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.lst.table import LakeTable


class LakeDataLoader:
    def __init__(self, fs, base_path: str, fmt: str, *, batch_size: int,
                 seq_len: int, host_id: int = 0, n_hosts: int = 1,
                 start_row: int = 0, prefetch: int = 2, loop: bool = True):
        self.table = LakeTable.open(fs, base_path, fmt)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.row = start_row
        self.loop = loop
        self._files = sorted(self.table.state().files.values(),
                             key=lambda f: f.path)
        self._rows_per_file = [f.record_count for f in self._files]
        self.total_rows = sum(self._rows_per_file)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # --------------------------------------------------------------- cursor
    def state_dict(self) -> dict:
        return {"row": self.row}

    def load_state_dict(self, d: dict) -> None:
        self.row = int(d["row"])

    def _fetch_row(self, idx: int) -> np.ndarray:
        from repro_torch.lst.chunkfile import read_chunk
        idx %= self.total_rows
        for f, n in zip(self._files, self._rows_per_file):
            if idx < n:
                cols, _ = read_chunk(self.table.fs, self.table.base, f.path)
                return cols["tokens"][idx]
            idx -= n
        raise IndexError(idx)

    # ---------------------------------------------------------------- batch
    def next_batch(self) -> dict:
        """Synchronous batch (deterministic; used by tests)."""
        rows = []
        while len(rows) < self.batch_size:
            if not self.loop and self.row >= self.total_rows:
                raise StopIteration
            if self.row % self.n_hosts == self.host_id:
                rows.append(self._fetch_row(self.row))
            self.row += 1
        toks = np.stack(rows)[:, :self.seq_len + 1].astype(np.int32)
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}

    # ------------------------------------------------------------- prefetch
    def _producer(self) -> None:
        # file-level cache so the producer isn't re-reading chunks per row
        cache: dict[str, np.ndarray] = {}
        from repro_torch.lst.chunkfile import read_chunk
        while not self._stop.is_set():
            rows = []
            while len(rows) < self.batch_size:
                if not self.loop and self.row >= self.total_rows:
                    self._q.put(None)
                    return
                if self.row % self.n_hosts == self.host_id:
                    idx = self.row % self.total_rows
                    for f, n in zip(self._files, self._rows_per_file):
                        if idx < n:
                            if f.path not in cache:
                                cols, _ = read_chunk(self.table.fs,
                                                     self.table.base, f.path)
                                cache[f.path] = cols["tokens"]
                                if len(cache) > 8:
                                    cache.pop(next(iter(cache)))
                            rows.append(cache[f.path][idx])
                            break
                        idx -= n
                self.row += 1
            toks = np.stack(rows)[:, :self.seq_len + 1].astype(np.int32)
            batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:],
                     "cursor": self.row}
            self._q.put(batch)

    def start(self) -> "LakeDataLoader":
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        return self

    def get(self, timeout: float = 60.0) -> dict:
        b = self._q.get(timeout=timeout)
        if b is None:
            raise StopIteration
        return b

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
