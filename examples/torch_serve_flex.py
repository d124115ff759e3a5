"""Scenario 3 — engine flexibility, on the PyTorch port: the server restores
weights through the Iceberg view of checkpoints the trainer wrote as Hudi
(snapshot+manifest metadata with file statistics = the right shape for
serving-fleet scan planning), then serves batched requests.  The port of
``examples/serve_flex.py``.

Run: PYTHONPATH=src python examples/torch_serve_flex.py [--steps 60]
     [--device cpu|cuda]

By default it runs on the card (and raises without one): stablelm-3b's
smoke config at stablelm-3b's own head_dim 80, its attention through the
CUDA kernels (flash forward and backward while training, decode while
serving).  ``--device cpu`` runs the smoke config (head_dim 16) through
the plain PyTorch paths.
"""

import argparse
import shutil
import sys
import tempfile
from dataclasses import replace

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.data import LakeDataLoader, write_synth_corpus  # noqa: E402
from repro_torch.lst import LocalFS  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="default: the card")
    args = ap.parse_args()

    fs = LocalFS()
    root = tempfile.mkdtemp()
    try:
        # quick training run to produce checkpoints (trainer = Hudi engine)
        write_synth_corpus(fs, f"{root}/corpus", fmt="delta", n_docs=64,
                           pack_len=65, vocab=256)
        cfg = replace(smoke_config("stablelm-3b"), vocab_size=256)
        if args.device != "cpu":
            cfg = replace(cfg, head_dim=get_config("stablelm-3b").head_dim)
        model = Model(cfg, device=args.device)
        trainer = Trainer(
            model,
            LakeDataLoader(fs, f"{root}/corpus", "delta", batch_size=8,
                           seq_len=64),
            fs, f"{root}/ckpt",
            TrainerConfig(steps=args.steps, save_every=args.steps // 2,
                          log_every=20, ce_chunk=64, ckpt_format="hudi",
                          sync_targets=("iceberg",)))
        trainer.init_or_restore()
        trainer.run()

        # the serving engine opens the SAME checkpoint directory as ICEBERG
        engine = ServeEngine.from_lake(model, fs, f"{root}/ckpt",
                                       fmt="iceberg", cache_len=96)
        rng = np.random.default_rng(0)
        requests = [Request(prompt=rng.integers(0, 256, size=n).tolist(),
                            max_new=12) for n in (5, 3, 8, 2)]
        outs = engine.generate(requests, temperature=0.0)
        for i, (req, out) in enumerate(zip(requests, outs)):
            print(f"req{i} prompt={req.prompt} -> {out}")
        print("served from the Iceberg view of Hudi-written checkpoints — "
              "no weight files copied.")
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
