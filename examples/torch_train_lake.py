"""End-to-end driver of the PyTorch port: train a (reduced) LM on a data
lake, with LST checkpoints, XTable sync and a kill/restore through another
format (paper Scenario 2 inside the training framework: the trainer
writes Hudi, the restarted trainer reads Iceberg).  The port of
``examples/train_lake.py``.

Run: PYTHONPATH=src python examples/torch_train_lake.py [--steps 200]
     [--arch yi-9b] [--device cpu|cuda]

By default it runs on the card (and raises without one): attention runs
through the CUDA kernels, forward and backward (at head_dim 64, the
smallest the kernels take).  ``--device cpu`` runs the smoke config
through the plain PyTorch paths.
"""

import argparse
import shutil
import sys
import tempfile
from dataclasses import replace

sys.path.insert(0, "src")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data import LakeDataLoader, write_synth_corpus  # noqa: E402
from repro_torch.lst import LocalFS  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="default: the card")
    args = ap.parse_args()

    fs = LocalFS()
    root = tempfile.mkdtemp()
    print("world dir:", root)
    try:
        # the corpus lives in a Delta table (could be any format)
        write_synth_corpus(fs, f"{root}/corpus", fmt="delta", n_docs=128,
                           pack_len=65, vocab=256, n_shards=4)

        cfg = replace(smoke_config(args.arch), vocab_size=256)
        model = Model(cfg if args.device == "cpu"
                      else replace(cfg, head_dim=64), device=args.device)
        loader = LakeDataLoader(fs, f"{root}/corpus", "delta", batch_size=8,
                                seq_len=64)
        trainer = Trainer(model, loader, fs, f"{root}/ckpt", TrainerConfig(
            steps=args.steps, save_every=50, log_every=20, ce_chunk=64,
            ckpt_format="hudi", sync_targets=("iceberg", "delta")))
        trainer.init_or_restore()
        history = trainer.run()
        print(f"loss: {history[0][1]:.3f} -> {history[-1][1]:.3f}")

        # --- simulate preemption + restart reading the ICEBERG view -------
        loader2 = LakeDataLoader(fs, f"{root}/corpus", "delta", batch_size=8,
                                 seq_len=64)
        restarted = Trainer(model, loader2, fs, f"{root}/ckpt", TrainerConfig(
            steps=args.steps + 20, save_every=50, log_every=20, ce_chunk=64,
            restore_format="iceberg"))
        step = restarted.init_or_restore()
        print(f"restarted from step {step} (restored via ICEBERG metadata, "
              f"loader cursor {loader2.row})")
        restarted.run()
        print("done; checkpoints visible as:",
              restarted.ckpt.steps(), "(hudi) ==",
              restarted.ckpt.steps(fmt="delta"), "(delta)")
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
