"""Trainer: data-lake input + LST checkpoints + XTable sync + restart.

The reference's ``repro/train/trainer.py`` in torch; the loop it runs:

1. the loader reads token rows from an LST table (any format),
2. every ``save_every`` steps, and after the last, the full train state
   (params + optimizer + loader cursor) is committed as an LST checkpoint,
   which XTable translates to the other formats,
3. on (re)start the trainer restores the latest committed snapshot,
   through ANY format, and resumes exactly (loader cursor included).

State lives on ``model.device``: the card unless the model was built with
``device="cpu"``.  A fresh start draws the weights from a seeded
``torch.Generator`` on that device, so they differ from the reference's
``jax.random`` draws; a checkpoint written by either trainer restores in
the other (same leaf names, same on-disk format).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint import LSTCheckpointManager
from repro_torch.data import LakeDataLoader
from repro_torch.models.model import Model
from repro_torch.models.param import init_params
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.loop import _opt_template, make_train_step


@dataclass
class TrainerConfig:
    steps: int = 100
    save_every: int = 20
    log_every: int = 10
    ckpt_format: str = "hudi"
    sync_targets: tuple = ("iceberg", "delta")
    restore_format: str | None = None     # restore via a different connector
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    grad_accum: int = 1
    ce_chunk: int = 128


class Trainer:
    def __init__(self, model: Model, loader: LakeDataLoader, fs,
                 ckpt_path: str, cfg: TrainerConfig | None = None):
        cfg = cfg or TrainerConfig()
        self.model = model
        self.loader = loader
        self.cfg = cfg
        self.ckpt = LSTCheckpointManager(
            fs, ckpt_path, fmt=cfg.ckpt_format,
            sync_targets=cfg.sync_targets)
        self.step_fn = make_train_step(
            model, cfg.opt, grad_accum=cfg.grad_accum, ce_chunk=cfg.ce_chunk)
        self.params = None
        self.opt_state = None
        self.start_step = 0
        self.history: list = []

    # ------------------------------------------------------------ lifecycle
    def init_or_restore(self, seed: int = 0) -> int:
        tpl = self.model.param_template()
        dev = self.model.device
        try:
            fmt = self.cfg.restore_format or self.cfg.ckpt_format
            state_tpl = {"params": tpl, "opt": _opt_template(tpl)}
            step, state = self.ckpt.restore_pytree(state_tpl, fmt=fmt,
                                                   device=dev)
            self.params, self.opt_state = state["params"], state["opt"]
            cursor = int(self.ckpt.latest_meta(fmt).get("loader.row", 0))
            self.loader.load_state_dict({"row": cursor})
            self.start_step = step + 1
        except (FileNotFoundError, KeyError):
            gen = torch.Generator(device=dev).manual_seed(seed)
            self.params = init_params(tpl, gen, device=dev)
            self.opt_state = adamw_init(self.params)
            self.start_step = 0
        return self.start_step

    def save(self, step: int) -> None:
        self.ckpt.save(step, {"params": self.params, "opt": self.opt_state},
                       extra_meta={"loader.row": str(self.loader.row)})

    def next_batch(self) -> dict:
        """The loader's next batch as int32 tensors on the model's device."""
        return {k: torch.from_numpy(v).to(self.model.device)
                for k, v in self.loader.next_batch().items()}

    # ----------------------------------------------------------------- run
    def run(self) -> list:
        if self.params is None:
            self.init_or_restore()
        t0 = time.perf_counter()
        for step in range(self.start_step, self.cfg.steps):
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, self.next_batch())
            loss = float(metrics["loss"])
            self.history.append((step, loss))
            if step % self.cfg.log_every == 0:
                dt = time.perf_counter() - t0
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({dt:.1f}s)", flush=True)
            if self.cfg.save_every and step and \
                    step % self.cfg.save_every == 0:
                self.save(step)
                self.ckpt.gc()
        self.save(self.cfg.steps - 1)
        return self.history
