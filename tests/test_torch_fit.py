"""The port's checkpointed training loop, checkpoints, logs, panels,
serving from a checkpoint and CLI, on the CPU at synthetic_tiny size.

* Kill and resume (as tests/test_train_e2e.py does for the JAX Trainer):
  checkpoint_every=3, a crash after 4 steps, restore, resume at step 3.
  The restored parameters, BN buffers, momentum buffers and step equal
  the saved ones bit for bit, and the resumed losses equal the
  uninterrupted run's to rtol 1e-6; `fit` resumes inside the epoch.
* CheckpointManager: the steps it keeps against orbax's under the JAX
  package's manager, the best step kept, max_to_keep=1, best_step and
  latest_step, (None, None) on an empty directory, a save interrupted by
  a crash, a second save of one step refused.
* fit: the same files and CSV headers as the JAX package's fit on the
  same config; a second fit after the last epoch trains nothing; raised
  epochs resume at the next epoch; without PIL and tensorboard it still
  trains and writes its CSVs; a Trainer writes under its workdir only.
* The eval panel equals the JAX Trainer's, array and PNG bytes.
* DepthPredictor.from_checkpoint serves what the restored Trainer
  computes; the CLI lists configs, trains, resumes and evaluates.
* A 2-rank gloo mesh: rank 0 writes, both ranks restore identical states
  and replay the uninterrupted losses.

This module's top level imports no JAX: the mesh test's ranks import it
by name (the JAX references are imported inside the tests).
"""

import builtins
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cspn_monodepth_tpu_torch.configs import CONFIGS, TrainConfig, get_config
from cspn_monodepth_tpu_torch.main import main as cli_main
from cspn_monodepth_tpu_torch.parallel import spawn_ranks
from cspn_monodepth_tpu_torch.serving import DepthPredictor
from cspn_monodepth_tpu_torch.train import Trainer
from cspn_monodepth_tpu_torch.train.checkpoint import CheckpointManager
from cspn_monodepth_tpu_torch.train.loop import METRIC_FIELDS

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-6
DEADLINE_S = 300
TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Tiny shapes gain nothing from more torch threads, which only contend
    with the suite's other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(threads)


def quiet(*args):
    pass


def tiny(workdir, **overrides):
    """synthetic_tiny at 32x48, batch 4, 6 steps an epoch."""
    return get_config("synthetic_tiny").override(**{
        "train.checkpoint_dir": str(workdir), "train.steps_per_epoch": 6,
        "train.batch_size": 4, "train.log_every": 1, "data.height": 32,
        "data.width": 48, "data.num_samples": 30, "data.num_workers": 2,
        **overrides})


def snapshot(state) -> dict:
    """Copies of everything a checkpoint holds."""
    return {"step": state.step,
            "model": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "optimizer": [
                {k: v.clone() for k, v in state.optimizer.state[p].items()}
                for g in state.optimizer.param_groups for p in g["params"]]}


def assert_bitwise_equal(got: dict, want: dict):
    assert got["step"] == want["step"]
    assert got["model"].keys() == want["model"].keys()
    for k, v in want["model"].items():
        assert got["model"][k].dtype == v.dtype, k
        assert torch.equal(got["model"][k], v), k
    assert len(got["optimizer"]) == len(want["optimizer"])
    for g, w in zip(got["optimizer"], want["optimizer"]):
        assert g.keys() == w.keys() and g  # momentum buffers exist
        for k in w:
            assert torch.equal(g[k], w[k]), k


class RecordingManager(CheckpointManager):
    """Keeps a copy of the state of every save."""

    def save(self, step, state, extra=None, is_best=False):
        self.saved = getattr(self, "saved", {})
        self.saved[step] = snapshot(state)
        super().save(step, state, extra, is_best)


# ------------------------------------------------------------ kill/resume
@pytest.fixture(scope="module")
def crash(tmp_path_factory):
    """An uninterrupted epoch, and the same epoch crashed after 4 steps
    with checkpoint_every=3."""
    work = tmp_path_factory.mktemp("crash")
    cfg = tiny(work, **{"train.checkpoint_every": 3})
    trainer = Trainer(cfg, device="cpu")
    full_state, full = trainer.train_epoch(trainer.init_state(), 0,
                                           log=quiet)
    ckpt = RecordingManager(str(work / "ck"))
    _, part = trainer.train_epoch(trainer.init_state(), 0, log=quiet,
                                  ckpt=ckpt, ckpt_extra={"best_rmse": 9.0},
                                  max_steps=4)
    return dict(cfg=cfg, trainer=trainer, full=full, part=part, ckpt=ckpt,
                full_state=snapshot(full_state), work=work)


def test_crash_checkpoint_holds_the_saved_state_bit_for_bit(crash):
    trainer, ckpt = crash["trainer"], crash["ckpt"]
    assert len(crash["full"]["step_losses"]) == 6
    np.testing.assert_allclose(crash["part"]["step_losses"],
                               crash["full"]["step_losses"][:4],
                               rtol=LOSS_RTOL)
    assert ckpt.steps() == [3] and list(ckpt.saved) == [3]
    restored, extra = ckpt.restore(trainer.init_state())
    assert extra == {"best_rmse": 9.0, "epoch": 0, "epoch_step": 3}
    assert_bitwise_equal(snapshot(restored), ckpt.saved[3])


def test_resume_replays_the_uninterrupted_losses(crash):
    trainer, ckpt = crash["trainer"], crash["ckpt"]
    restored, extra = ckpt.restore(trainer.init_state())
    state, resumed = trainer.train_epoch(restored, 0, log=quiet,
                                         start_step=extra["epoch_step"])
    np.testing.assert_allclose(resumed["step_losses"],
                               crash["full"]["step_losses"][3:],
                               rtol=LOSS_RTOL)
    assert state.step == 6


def test_fit_resumes_inside_the_epoch(crash, tmp_path):
    """fit on the crash's workdir starts at epoch 0 step 3 and ends where
    the uninterrupted epoch ended."""
    shutil.copytree(crash["ckpt"].directory, tmp_path, dirs_exist_ok=True)
    trainer = Trainer(crash["cfg"], device="cpu", workdir=str(tmp_path))
    trainer.val_ds.length = 4
    logs = []
    state, _ = trainer.fit(log=logs.append)
    assert logs[0] == "resumed from step 3, epoch 0 step 3"
    assert [line.split()[:4] for line in logs[1:4]] == [
        ["epoch", "0", "step", f"{s}/6"] for s in (3, 4, 5)]
    got, want = snapshot(state), crash["full_state"]
    assert got["step"] == want["step"] == 6
    for k, v in want["model"].items():
        torch.testing.assert_close(got["model"][k], v, rtol=LOSS_RTOL,
                                   atol=0.0, msg=k)


# ------------------------------------------------------------ checkpoints
def small_state(seed: int):
    from cspn_monodepth_tpu_torch.train.train_state import TrainState

    model = torch.nn.Sequential(torch.nn.Linear(3, 2),
                                torch.nn.BatchNorm1d(2))
    torch.manual_seed(seed)
    for p in model.parameters():
        p.data.normal_()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.randn(4, 3)).square().sum().backward()
    opt.step()
    return TrainState(step=seed, model=model, optimizer=opt)


def test_empty_directory_restores_nothing(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "none"))
    assert ckpt.restore(small_state(0)) == (None, None)
    assert ckpt.best_step() is None and ckpt.latest_step() is None


def test_keeps_the_steps_orbax_keeps(tmp_path):
    """Five saves without a best step: the same steps remain as under the
    JAX package's (orbax) manager, the newest three."""
    import jax.numpy as jnp

    from cspn_monodepth_tpu.train.checkpoint import (
        CheckpointManager as JaxCheckpointManager,
    )

    port = CheckpointManager(str(tmp_path / "port"))
    jax_mgr = JaxCheckpointManager(str(tmp_path / "jax"))
    for step in range(1, 6):
        port.save(step, small_state(step), extra={"epoch": step})
        jax_mgr.save(step, {"w": jnp.full((2,), float(step))},
                     extra={"epoch": step})
        jax_mgr.wait()
        assert port.steps() == sorted(jax_mgr._mgr.all_steps())
        assert port.latest_step() == jax_mgr.latest_step() == step
    jax_mgr.close()
    assert port.steps() == [3, 4, 5]


def test_best_step_is_kept_and_restorable(tmp_path):
    """The best step stays while max_to_keep still bounds the directory
    (orbax would remove step 1 after the fourth save)."""
    ckpt = CheckpointManager(str(tmp_path))
    states = {step: snapshot(small_state(step)) for step in range(1, 6)}
    for step in range(1, 6):
        ckpt.save(step, small_state(step), extra={"epoch": step},
                  is_best=step == 1)
        assert len(ckpt.steps()) <= 3
    assert ckpt.steps() == [1, 4, 5]
    assert ckpt.best_step() == 1 and ckpt.latest_step() == 5
    restored, extra = ckpt.restore(small_state(9), step=ckpt.best_step())
    assert extra == {"epoch": 1}
    assert_bitwise_equal(snapshot(restored), states[1])
    restored, _ = ckpt.restore(small_state(9))
    assert_bitwise_equal(snapshot(restored), states[5])


def test_interrupted_save_leaves_the_previous_latest(tmp_path, monkeypatch):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, small_state(1), extra={"best_rmse": float("inf")})
    saved = snapshot(small_state(1))

    def torn_save(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise OSError("crash in the middle of a save")

    monkeypatch.setattr(torch, "save", torn_save)
    with pytest.raises(OSError):
        ckpt.save(2, small_state(2))
    monkeypatch.undo()
    assert ckpt.latest_step() == 1 and ckpt.steps() == [1]
    restored, extra = ckpt.restore(small_state(9))
    assert extra == {"best_rmse": float("inf")}
    assert_bitwise_equal(snapshot(restored), saved)
    # A new manager clears the torn directory and the step saves again; a
    # second save of one step is refused (as orbax refuses it) and leaves
    # the first as it was.
    assert any(n.startswith(".tmp-") for n in os.listdir(tmp_path))
    ckpt = CheckpointManager(str(tmp_path))
    assert not any(n.startswith(".tmp-") for n in os.listdir(tmp_path))
    ckpt.save(2, small_state(2))
    with pytest.raises(ValueError, match="already saved"):
        ckpt.save(2, small_state(7))
    assert ckpt.steps() == [1, 2]
    assert not any(n.startswith(".tmp-") for n in os.listdir(tmp_path))
    restored, _ = ckpt.restore(small_state(9))
    assert_bitwise_equal(snapshot(restored), snapshot(small_state(2)))


def test_max_to_keep_one_keeps_the_latest(tmp_path):
    """With room for one step the latest stays, even when an older step
    was the best, and best_step no longer names the removed step."""
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=1)
    ckpt.save(1, small_state(1), is_best=True)
    assert ckpt.steps() == [1] and ckpt.best_step() == 1
    for step in (2, 3):
        ckpt.save(step, small_state(step))
        assert ckpt.steps() == [step] and ckpt.latest_step() == step
    assert ckpt.best_step() is None
    restored, _ = ckpt.restore(small_state(9))
    assert_bitwise_equal(snapshot(restored), snapshot(small_state(3)))


# ------------------------------------------------------------ fit
FIT = {"train.steps_per_epoch": 2, "train.epochs": 1}


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The JAX package's fit and the port's on the same config (one epoch
    of one step for JAX, whose compiles dominate; two for the port)."""
    from cspn_monodepth_tpu.configs import get_config as jax_get_config
    from cspn_monodepth_tpu.train.loop import METRIC_FIELDS as JAX_FIELDS
    from cspn_monodepth_tpu.train.loop import Trainer as JaxTrainer

    jax_dir = tmp_path_factory.mktemp("jax_fit")
    port_dir = tmp_path_factory.mktemp("port_fit")
    jax_cfg = jax_get_config("synthetic_tiny").override(**{
        "train.checkpoint_dir": str(jax_dir), "train.steps_per_epoch": 1,
        "train.epochs": 1, "data.height": 32, "data.width": 48,
        "data.num_samples": 30, "data.num_workers": 2})
    jax_trainer = JaxTrainer(jax_cfg)
    jax_trainer.val_ds.length = 2
    jax_trainer.fit(log=quiet)

    cfg = tiny(port_dir, **FIT)
    trainer = Trainer(cfg, device="cpu")
    trainer.val_ds.length = 6
    logs = []
    state, best = trainer.fit(log=logs.append)
    return dict(jax_dir=jax_dir, jax_fields=JAX_FIELDS,
                jax_trainer=jax_trainer, port_dir=port_dir, cfg=cfg,
                state=snapshot(state), best=best, logs=logs)


def csv_rows(path) -> list[list[str]]:
    return [line.split(",") for line in Path(path).read_text().splitlines()]


def test_fit_writes_jax_files_and_headers(fits):
    port, jax_dir = fits["port_dir"], fits["jax_dir"]

    def names(d):   # a step's directory is named by its step
        return sorted("<step>" if n.isdigit() else n for n in os.listdir(d))

    assert names(port) == names(jax_dir) == [
        "<step>", "best.txt", "best_step.txt", "comparison_epoch000.png",
        "tb", "test.csv", "train.csv"]
    assert METRIC_FIELDS == fits["jax_fields"]
    for name in ("train.csv", "test.csv"):
        got, want = csv_rows(port / name), csv_rows(jax_dir / name)
        assert got[0] == want[0] == METRIC_FIELDS
        assert len(got) == len(want) == 2 and got[1][0] == "0"
    assert (port / "best_step.txt").read_text() == "2"
    assert (port / "best.txt").read_text().startswith("epoch 0 rmse=")
    assert os.listdir(port / "tb") and os.listdir(jax_dir / "tb")
    assert np.isfinite(fits["best"])


def test_second_fit_after_the_last_epoch_trains_nothing(fits, tmp_path):
    shutil.copytree(fits["port_dir"], tmp_path, dirs_exist_ok=True)
    trainer = Trainer(fits["cfg"], device="cpu", workdir=str(tmp_path))
    logs = []
    state, best = trainer.fit(log=logs.append)
    assert logs == ["resumed from step 2, epoch 1 step 0"]
    assert_bitwise_equal(snapshot(state), fits["state"])
    assert best == fits["best"]
    assert len(csv_rows(tmp_path / "train.csv")) == 2
    assert CheckpointManager(str(tmp_path)).steps() == [2]


def test_raised_epochs_resume_at_the_next_epoch(fits, tmp_path):
    shutil.copytree(fits["port_dir"], tmp_path, dirs_exist_ok=True)
    cfg = fits["cfg"].override(**{"train.epochs": 2})
    trainer = Trainer(cfg, device="cpu", workdir=str(tmp_path))
    trainer.val_ds.length = 6
    logs = []
    state, _ = trainer.fit(log=logs.append)
    assert logs[0] == "resumed from step 2, epoch 1 step 0"
    assert logs[1].startswith("epoch 1 step 0/2")
    assert state.step == 4
    assert [r[0] for r in csv_rows(tmp_path / "train.csv")[1:]] == ["0", "1"]
    assert [r[0] for r in csv_rows(tmp_path / "test.csv")[1:]] == ["0", "1"]
    assert CheckpointManager(str(tmp_path)).latest_step() == 4
    assert (tmp_path / "comparison_epoch001.png").exists()


def test_fit_without_pil_and_tensorboard(tmp_path, monkeypatch, capsys):
    for name in ("PIL", "PIL.Image", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, name, None)
    trainer = Trainer(tiny(tmp_path, **FIT), device="cpu")
    trainer.val_ds.length = 2
    trainer.fit(log=quiet)
    assert "panel save failed" in capsys.readouterr().out
    assert trainer.last_panel is None
    assert sorted(os.listdir(tmp_path)) == [
        "2", "best.txt", "best_step.txt", "test.csv", "train.csv"]


def test_trainer_writes_only_under_its_workdir(tmp_path, monkeypatch):
    """A Trainer built without a workdir writes under its config's
    checkpoint_dir only (fit, then evaluate with its default panel), never
    under the config's default directory, which is shared by every run."""
    default = os.path.abspath(TrainConfig().checkpoint_dir)
    work = os.path.abspath(tmp_path / "work")
    written = []
    real_open, real_makedirs, real_replace = (builtins.open, os.makedirs,
                                              os.replace)

    def record(path):
        written.append(os.path.abspath(os.fspath(path)))

    def open_(file, mode="r", *args, **kwargs):
        if isinstance(file, (str, os.PathLike)) and set(mode) & set("wax+"):
            record(file)
        return real_open(file, mode, *args, **kwargs)

    def makedirs(name, *args, **kwargs):
        record(name)
        return real_makedirs(name, *args, **kwargs)

    def replace(src, dst, *args, **kwargs):
        record(src)
        record(dst)
        return real_replace(src, dst, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", open_)
    monkeypatch.setattr(os, "makedirs", makedirs)
    monkeypatch.setattr(os, "replace", replace)
    trainer = Trainer(tiny(work, **FIT, **{"train.checkpoint_every": 1}),
                      device="cpu")
    trainer.val_ds.length = 2
    state, _ = trainer.fit(log=quiet)
    trainer.evaluate(state, log=quiet)
    monkeypatch.undo()
    assert trainer.workdir == work
    assert os.path.exists(os.path.join(work, "comparison_latest.png"))
    assert CheckpointManager(work).steps() == [1, 2]
    assert not [p for p in written
                if p == default or p.startswith(default + os.sep)]
    assert written and not [p for p in written if p != work
                            and not p.startswith(work + os.sep)]


def test_panel_equals_jax(fits, tmp_path):
    """The same packed eval batch (5 images: the panel takes 4) and
    prediction through both Trainers' _save_panel."""
    rng = np.random.default_rng(3)
    b, h, w = 5, 32, 48
    depth = rng.uniform(0.5, 9.5, (b, h, w))
    depth[:, :, :4] = 0.0
    batch = {"rgb": rng.integers(0, 256, (b, h, w, 3), np.uint8),
             "depth": (depth * 256 + 0.5).astype(np.uint16)}
    pred = rng.uniform(0.0, 10.0, (b, h, w, 1)).astype(np.float32)

    jax_trainer = fits["jax_trainer"]
    jax_trainer.workdir = str(tmp_path / "jax")
    jax_trainer._save_panel(batch, pred, 7)
    trainer = Trainer(tiny(tmp_path / "port"), device="cpu")
    trainer._save_panel({k: torch.from_numpy(v) for k, v in batch.items()},
                        torch.from_numpy(pred), 7)
    assert trainer.last_panel.dtype == np.uint8
    assert trainer.last_panel.shape == (4 * h, 3 * w, 3)
    np.testing.assert_array_equal(trainer.last_panel, jax_trainer.last_panel)
    name = "comparison_epoch007.png"
    assert ((tmp_path / "port" / name).read_bytes()
            == (tmp_path / "jax" / name).read_bytes())


# ------------------------------------------------------------ serving
def test_from_checkpoint_serves_the_restored_model(fits, tmp_path):
    cfg, work = fits["cfg"], str(fits["port_dir"])
    predictor = DepthPredictor.from_checkpoint(work, cfg, device="cpu")
    trainer = Trainer(cfg, device="cpu", workdir=work)
    state, _ = CheckpointManager(work).restore(trainer.init_state(), step=2)

    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (2, 32, 48, 3), np.uint8)
    sparse = np.where(rng.random((2, 32, 48)) < 0.02,
                      rng.uniform(0.5, 9.5, (2, 32, 48)), 0.0).astype(
                          np.float32)
    got = predictor.predict_batch(rgb, sparse)
    x = torch.cat([torch.from_numpy(rgb).float() / 255.0,
                   torch.from_numpy(sparse)[..., None]], dim=-1)
    with torch.no_grad():
        want = state.model.eval()(x)[..., 0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)
    anchors = sparse > 0
    assert anchors.any()
    np.testing.assert_array_equal(got[anchors], sparse[anchors])

    with pytest.raises(FileNotFoundError):
        DepthPredictor.from_checkpoint(str(tmp_path), cfg, device="cpu")


# ------------------------------------------------------------ CLI
def test_cli_lists_configs():
    proc = subprocess.run(
        [sys.executable, "-m", "cspn_monodepth_tpu_torch.main",
         "--list-configs"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert [line.split(":")[0] for line in proc.stdout.splitlines()] == list(
        CONFIGS)


def test_cli_trains_resumes_and_evaluates(tmp_path, capsys):
    args = ["--config", "synthetic_tiny", "--device", "cpu", "--workdir",
            str(tmp_path), "--set", "train.steps_per_epoch=2", "--set",
            "data.height=32", "--set", "data.width=48", "--set",
            "data.num_workers=2"]
    assert cli_main(args + ["--evaluate"]) == 0
    assert "no checkpoint found" in capsys.readouterr().out
    assert cli_main(args) == 0
    assert CheckpointManager(str(tmp_path)).steps() == [2]
    assert cli_main(args + ["--set", "train.epochs=2"]) == 0
    assert "resumed from step 2, epoch 1 step 0" in capsys.readouterr().out
    assert len(csv_rows(tmp_path / "train.csv")) == 3
    assert cli_main(args + ["--evaluate"]) == 0
    out = capsys.readouterr().out
    best = CheckpointManager(str(tmp_path)).best_step()
    assert f"evaluating checkpoint step {best}" in out and "eval rmse" in out


# ------------------------------------------------------------ mesh
def _rank_resume(rank: int, workdir: str) -> dict:
    """One rank of a 2x1 mesh: an uninterrupted epoch, the same epoch
    crashed after 2 steps with a checkpoint at 2, restore, resume."""
    cfg = tiny(workdir, **{"mesh.data": 2, "train.batch_size": 2,
                           "train.steps_per_epoch": 4,
                           "train.checkpoint_every": 2,
                           "data.num_workers": 1})
    trainer = Trainer(cfg, device="cpu")
    _, full = trainer.train_epoch(trainer.init_state(), 0, log=quiet)
    ckpt = CheckpointManager(os.path.join(workdir, "ck"),
                             group=trainer.group)
    dead, _ = trainer.train_epoch(trainer.init_state(), 0, log=quiet,
                                  ckpt=ckpt, max_steps=2)
    saved = snapshot(dead)
    restored, extra = ckpt.restore(trainer.init_state())
    got = snapshot(restored)
    assert_bitwise_equal(got, saved)
    _, resumed = trainer.train_epoch(restored, 0, log=quiet,
                                     start_step=extra["epoch_step"])
    return dict(writer=ckpt.writer, steps=ckpt.steps(), extra=extra,
                full=full["step_losses"], resumed=resumed["step_losses"],
                model={k: v.numpy() for k, v in got["model"].items()},
                momentum=[{k: v.numpy() for k, v in m.items()}
                          for m in got["optimizer"]])


def test_mesh_resume_rank_zero_writes_every_rank_restores(tmp_path):
    ranks = spawn_ranks(_rank_resume, 2, str(tmp_path), timeout=DEADLINE_S,
                        init_file=str(tmp_path / "rendezvous"))
    assert [r["writer"] for r in ranks] == [True, False]
    for r in ranks:
        assert r["steps"] == [2]
        assert r["extra"] == {"epoch": 0, "epoch_step": 2}
        np.testing.assert_allclose(r["resumed"], r["full"][2:],
                                   rtol=LOSS_RTOL)
    r0, r1 = ranks
    assert r0["full"] == r1["full"]
    for k, v in r0["model"].items():
        np.testing.assert_array_equal(r1["model"][k], v, err_msg=k)
    for m0, m1 in zip(r0["momentum"], r1["momentum"]):
        for k in m0:
            np.testing.assert_array_equal(m1[k], m0[k])
