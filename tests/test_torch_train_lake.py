"""The port's Trainer on a lake corpus, checkpointed as Hudi and resumed
through the translated views, on the CPU; and checkpoints of the train
state crossing between the port's Trainer and the reference's.

The first part is the port's copy of ``tests/test_integration_e2e.py``
(the yi-9b smoke config, bf16, vocab 256).  The cross tests run the
smoke config in fp32, so that the steps after a resume can be compared:
the state restored by the other package must be bit-equal to the saved
one, the loader row the same, and the next losses within 2e-4 atol /
2e-3 rtol of the saving package's own continuation (the train-step
tolerance of ``tests/test_torch_train.py``).
"""

import os
import shutil
import subprocess
import sys
import tempfile
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.checkpoint.manager import _leaf_paths as jax_leaf_paths  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.data import LakeDataLoader as JaxLakeDataLoader  # noqa: E402
from repro.lst import LocalFS as JaxLocalFS  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch.checkpoint import LSTCheckpointManager, leaf_paths  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data import LakeDataLoader, write_synth_corpus  # noqa: E402
from repro_torch.lst import LocalFS  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

torch.set_num_threads(2)

FORMATS = ("hudi", "iceberg", "delta")
OPT = dict(peak_lr=3e-3, warmup_steps=2, total_steps=10)


# ------------------------------------------------ the port's e2e loop
@pytest.fixture(scope="module")
def world():
    fs = LocalFS()
    root = tempfile.mkdtemp()
    write_synth_corpus(fs, f"{root}/corpus", fmt="delta", n_docs=32,
                       pack_len=33, vocab=256)
    model = Model(replace(smoke_config("yi-9b"), vocab_size=256),
                  device="cpu")
    loader = LakeDataLoader(fs, f"{root}/corpus", "delta", batch_size=4,
                            seq_len=32)
    tr = Trainer(model, loader, fs, f"{root}/ckpt",
                 TrainerConfig(steps=7, save_every=3, log_every=100,
                               ce_chunk=32, opt=AdamWConfig(**OPT)))
    tr.init_or_restore()
    hist = tr.run()
    return {"fs": fs, "root": root, "model": model, "hist": hist, "tr": tr}


def test_training_learns(world):
    losses = [h[1] for h in world["hist"]]
    assert [h[0] for h in world["hist"]] == list(range(7))
    assert losses[-1] < losses[0]


def test_checkpoints_land_in_every_format(world):
    mgr = world["tr"].ckpt
    assert mgr.steps() == [3, 6]
    assert mgr.steps(fmt="iceberg") == mgr.steps(fmt="delta") == [3, 6]
    assert mgr.latest_meta("iceberg")["loader.row"] == \
        str(world["tr"].loader.row)


@pytest.mark.parametrize("fmt", FORMATS)
def test_restart_from_translated_format_resumes_exactly(world, fmt):
    fs, root, model = world["fs"], world["root"], world["model"]
    loader2 = LakeDataLoader(fs, f"{root}/corpus", "delta", batch_size=4,
                             seq_len=32)
    tr2 = Trainer(model, loader2, fs, f"{root}/ckpt",
                  TrainerConfig(steps=9, save_every=100, log_every=100,
                                ce_chunk=32, restore_format=fmt))
    assert tr2.init_or_restore() == 7          # resumes after the final save
    assert loader2.row == world["tr"].loader.row
    want = leaf_paths({"params": world["tr"].params,
                       "opt": world["tr"].opt_state})
    got = leaf_paths({"params": tr2.params, "opt": tr2.opt_state})
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert tr2.opt_state["step"].dtype == torch.int32
    assert int(tr2.opt_state["step"]) == 7


def test_fresh_start_without_a_checkpoint():
    fs, root = LocalFS(), tempfile.mkdtemp()
    write_synth_corpus(fs, f"{root}/corpus", n_docs=8, pack_len=17, vocab=64)
    model = Model(replace(smoke_config("yi-9b"), vocab_size=64),
                  device="cpu")
    loader = LakeDataLoader(fs, f"{root}/corpus", "delta", batch_size=2,
                            seq_len=16)
    tr = Trainer(model, loader, fs, f"{root}/ckpt",
                 TrainerConfig(steps=2, restore_format="iceberg"))
    assert tr.init_or_restore(seed=3) == 0
    assert int(tr.opt_state["step"]) == 0
    assert tr.params["embed"].device.type == "cpu"
    again = Trainer(model, loader, fs, f"{root}/ckpt2", TrainerConfig())
    again.init_or_restore(seed=3)
    for (name, a), (_, b) in zip(leaf_paths(tr.params),
                                 leaf_paths(again.params)):
        assert torch.equal(a, b), name      # the seed fixes the weights


def test_serve_from_iceberg_view(world):
    fs, root, model = world["fs"], world["root"], world["model"]
    eng = ServeEngine.from_lake(model, fs, f"{root}/ckpt", fmt="iceberg",
                                cache_len=48)
    outs = eng.generate([Request(prompt=[5, 6, 7], max_new=6),
                         Request(prompt=[1, 2], max_new=3)])
    assert len(outs[0]) == 6 and len(outs[1]) == 3
    assert all(0 <= t < model.cfg.vocab_size for t in outs[0])
    for (name, a), (_, b) in zip(leaf_paths(world["tr"].params),
                                 leaf_paths(eng.params)):
        assert torch.equal(a, b), name


# --------------------------------------------- across the two packages
def _cfgs():
    jcfg = replace(jax_smoke_config("yi-9b"), vocab_size=256, dtype="float32")
    tcfg = replace(smoke_config("yi-9b"), vocab_size=256, dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def corpus():
    root = tempfile.mkdtemp()
    write_synth_corpus(LocalFS(), f"{root}/corpus", fmt="delta", n_docs=32,
                       pack_len=33, vocab=256)
    return root


def _jax_trainer(root, ckpt, steps, restore_format=None):
    jcfg, _ = _cfgs()
    loader = JaxLakeDataLoader(JaxLocalFS(), f"{root}/corpus", "delta",
                               batch_size=4, seq_len=32)
    return JaxTrainer(JaxModel(jcfg), loader, JaxLocalFS(), ckpt,
                      JaxTrainerConfig(steps=steps, save_every=0,
                                       log_every=100, ce_chunk=32,
                                       restore_format=restore_format,
                                       opt=JaxAdamWConfig(**OPT)))


def _port_trainer(root, ckpt, steps, restore_format=None):
    _, tcfg = _cfgs()
    loader = LakeDataLoader(LocalFS(), f"{root}/corpus", "delta",
                            batch_size=4, seq_len=32)
    return Trainer(Model(tcfg, device="cpu"), loader, LocalFS(), ckpt,
                   TrainerConfig(steps=steps, save_every=0, log_every=100,
                                 ce_chunk=32, restore_format=restore_format,
                                 opt=AdamWConfig(**OPT)))


def _copy(src: str) -> str:
    dst = tempfile.mkdtemp() + "/ckpt"
    shutil.copytree(src, dst)
    return dst


def _bits(x) -> tuple:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return str(t.dtype).replace("torch.", ""), tuple(t.shape), \
            t.numpy().tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def _assert_state_bit_equal(port_tr, jax_tr):
    want = jax_leaf_paths({"params": jax_tr.params, "opt": jax_tr.opt_state})
    got = leaf_paths({"params": port_tr.params, "opt": port_tr.opt_state})
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(want, got):
        assert _bits(a) == _bits(b), name


@pytest.fixture(scope="module")
def jax_run(corpus):
    """The reference trains steps 0-3 (saved at 3, synced), then continues
    from its own Hudi checkpoint to step 5 on a copy."""
    ckpt = tempfile.mkdtemp() + "/ckpt"
    tr = _jax_trainer(corpus, ckpt, 4)
    tr.init_or_restore()
    tr.run()
    cont = _jax_trainer(corpus, _copy(ckpt), 6)
    assert cont.init_or_restore() == 4
    return dict(ckpt=ckpt, tr=tr, losses=[h[1] for h in cont.run()])


@pytest.fixture(scope="module")
def port_run(corpus):
    """The port trains steps 0-3 (saved at 3, synced), then continues from
    its own Hudi checkpoint to step 5 on a copy."""
    ckpt = tempfile.mkdtemp() + "/ckpt"
    tr = _port_trainer(corpus, ckpt, 4)
    tr.init_or_restore()
    tr.run()
    cont = _port_trainer(corpus, _copy(ckpt), 6)
    assert cont.init_or_restore() == 4
    return dict(ckpt=ckpt, tr=tr, losses=[h[1] for h in cont.run()])


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_trainer_resumes_a_reference_run(jax_run, corpus, fmt):
    tr = _port_trainer(corpus, _copy(jax_run["ckpt"]), 6, restore_format=fmt)
    assert tr.init_or_restore() == 4
    assert tr.loader.row == jax_run["tr"].loader.row
    _assert_state_bit_equal(tr, jax_run["tr"])
    losses = [h[1] for h in tr.run()]
    np.testing.assert_allclose(losses, jax_run["losses"], atol=2e-4,
                               rtol=2e-3)


@pytest.mark.parametrize("fmt", FORMATS)
def test_reference_trainer_resumes_a_port_run(port_run, corpus, fmt):
    tr = _jax_trainer(corpus, _copy(port_run["ckpt"]), 6, restore_format=fmt)
    assert tr.init_or_restore() == 4
    assert tr.loader.row == port_run["tr"].loader.row
    _assert_state_bit_equal(port_run["tr"], tr)
    assert int(tr.opt_state["step"]) == 4
    assert np.asarray(tr.opt_state["step"]).dtype == np.int32
    losses = [h[1] for h in tr.run()]
    np.testing.assert_allclose(losses, port_run["losses"], atol=2e-4,
                               rtol=2e-3)


def test_port_and_reference_runs_agree(jax_run, port_run):
    """Both packages from their own seeds: different weights, the same
    corpus rows and loader cursor, and losses that fall in both."""
    assert jax_run["tr"].loader.row == port_run["tr"].loader.row == 16
    for run in (jax_run, port_run):
        losses = [h[1] for h in run["tr"].history]
        assert losses[-1] < losses[0]
    names = [n for n, _ in leaf_paths({"params": port_run["tr"].params,
                                       "opt": port_run["tr"].opt_state})]
    assert names == [n for n, _ in jax_leaf_paths(
        {"params": jax_run["tr"].params, "opt": jax_run["tr"].opt_state})]


def test_checkpoint_holds_the_reference_leaf_names(port_run):
    mgr = LSTCheckpointManager(LocalFS(), port_run["ckpt"], fmt="iceberg",
                               sync_targets=())
    step, flat = mgr.restore()
    assert step == 3
    assert sorted(flat) == sorted(n for n, _ in jax_leaf_paths(
        {"params": port_run["tr"].params, "opt": port_run["tr"].opt_state}))
    assert flat["opt/step"].dtype == torch.int32 and flat["opt/step"].ndim == 0


def test_example_trains_and_restarts_through_iceberg():
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    r = subprocess.run(
        [sys.executable, os.path.join(root, "examples", "torch_train_lake.py"),
         "--steps", "6", "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300, cwd=root)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "restarted from step 6 (restored via ICEBERG" in r.stdout
    assert "checkpoints visible as: [5, 25] (hudi) == [5, 25] (delta)" \
        in r.stdout, r.stdout
