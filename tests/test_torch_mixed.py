"""The port's mixed-dataset training (host8_dp's NYU + KITTI batches)
against the JAX package's, on the CPU.

* `_epoch_batches`: the shape and the record indices of every batch of an
  epoch against JAX's `Trainer._epoch_batches`, from step 0 and from a
  step inside the epoch, on 1 rank and on each of 2 ranks. Records encode
  their index in their depth, which the wire format carries exactly; the
  JAX side runs with its device copy replaced by the identity and its
  process index and count set for the rank (test-local monkeypatches).
* The sparse cap of a mixed job: max(max_depth, mix_max_depth), counted
  against JAX's `_sample_sparse` on the same depth.
* A mixed `train_epoch` alternates the two shapes, and a resume from a
  checkpoint inside the epoch restores the state bit for bit and replays
  the uninterrupted run's losses (rtol 1e-6, as tests/test_torch_fit.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cspn_monodepth_tpu.train.loop as jax_loop
from cspn_monodepth_tpu.configs import get_config as jax_get_config
from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.data import DEPTH_SCALE
from cspn_monodepth_tpu_torch.train import Trainer
from cspn_monodepth_tpu_torch.train.checkpoint import CheckpointManager

LOSS_RTOL = 1e-6
# synthetic_tiny mixed with a second synthetic set of another size.
MIX = {"data.mix_dataset": "synthetic", "data.mix_height": 24,
       "data.mix_width": 40, "data.mix_every": 2, "data.num_workers": 2,
       "data.height": 32, "data.width": 48, "train.batch_size": 4,
       "train.steps_per_epoch": 7}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class IndexDataset:
    """h x w records whose depth is their index + 1 m everywhere."""

    def __init__(self, n: int, h: int, w: int):
        self.n, self.h, self.w = n, h, w

    def __len__(self):
        return self.n

    def get(self, index: int, epoch: int = 0):
        return {"rgb": np.zeros((self.h, self.w, 3), np.float32),
                "depth": np.full((self.h, self.w), index + 1.0, np.float32)}


def batch_ids(batch) -> tuple:
    """(shape, record indices) of a packed batch, numpy or tensor."""
    depth = np.asarray(batch["depth"])
    return (depth.shape, [int(v) for v in
                          depth[:, 0, 0].astype(np.float64) / DEPTH_SCALE
                          - 1])


def with_index_sets(trainer):
    trainer.train_ds = IndexDataset(10, 8, 12)
    trainer.mix_ds = IndexDataset(6, 6, 20)
    return trainer


@pytest.mark.parametrize("start_step", [0, 3])
@pytest.mark.parametrize("ranks", [1, 2])
def test_epoch_batches_match_jax(ranks, start_step, tmp_path, monkeypatch):
    jt = with_index_sets(jax_loop.Trainer(jax_get_config(
        "synthetic_tiny").override(**MIX, **{
            "train.checkpoint_dir": str(tmp_path)})))
    pt = with_index_sets(Trainer(get_config("synthetic_tiny").override(
        **MIX), device="cpu"))
    monkeypatch.setattr(jax_loop, "device_prefetch", lambda it, sh: it)
    monkeypatch.setattr(jax, "process_count", lambda: ranks)
    for rank in range(ranks):
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        pt._shards = lambda: dict(process_index=rank, process_count=ranks)
        for epoch in (0, 1):
            want = [batch_ids(b) for b in jt._epoch_batches(epoch,
                                                            start_step)]
            got = [batch_ids(b) for b in pt._epoch_batches(epoch,
                                                           start_step)]
            assert got == want, (rank, epoch)
            assert len(got) == 7 - start_step
            # Every second step of the epoch is a mix batch.
            shapes = [s[1:] for s, _ in got]
            assert shapes == [(6, 20) if step % 2 else (8, 12)
                              for step in range(start_step, 7)]


@pytest.mark.parametrize("mixed", [False, True])
def test_sparse_cap_of_a_mixed_job_matches_jax(mixed, tmp_path):
    """15 pixels an image at 50 m: sampled under the 85 m cap of a mixed
    job, never under NYU's 10 m alone."""
    over = {**MIX, "data.mix_dataset": "synthetic" if mixed else ""}
    jt = jax_loop.Trainer(jax_get_config("synthetic_tiny").override(
        **over, **{"train.checkpoint_dir": str(tmp_path)}))
    pt = Trainer(get_config("synthetic_tiny").override(**over), device="cpu")
    depth = np.zeros((2, 12, 16), np.float32)
    depth[:, 2, :15] = 50.0
    depth[:, 5, :15] = 5.0
    want = np.asarray(jt._sample_sparse(jax.random.PRNGKey(0),
                                        jnp.asarray(depth), None))
    got = pt._sample_sparse(pt._rng(0, 0), torch.from_numpy(depth),
                            None).numpy()
    assert ((got > 0).sum((1, 2)) == (want > 0).sum((1, 2))).all()
    assert (got == 50.0).sum() == (30 if mixed else 0)


def test_mixed_epoch_alternates_shapes_and_resumes_inside_it(tmp_path):
    """6 steps with mix_every 2: main and mix batches in turn. A run that
    checkpoints at step 3 and stops there, restored into a fresh state and
    resumed at step 3, replays the uninterrupted run."""
    cfg = get_config("synthetic_tiny").override(**{
        **MIX, "train.steps_per_epoch": 6, "train.checkpoint_every": 3,
        "train.checkpoint_dir": str(tmp_path)})
    trainer = Trainer(cfg, device="cpu")
    shapes = []
    step = trainer.train_step

    def recording(state, batch, tag=0):
        shapes.append(tuple(batch["depth"].shape[1:]))
        return step(state, batch, tag)

    trainer.train_step = recording
    _, full = trainer.train_epoch(trainer.init_state(), 0,
                                  log=lambda *a: None)
    assert shapes == [(32, 48), (24, 40)] * 3
    assert np.isfinite(full["loss"])

    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    dead, _ = trainer.train_epoch(trainer.init_state(), 0,
                                  log=lambda *a: None, ckpt=ckpt,
                                  max_steps=3)
    saved = {k: v.clone() for k, v in dead.model.state_dict().items()}
    restored, extra = ckpt.restore(trainer.init_state())
    assert extra["epoch_step"] == 3 and restored.step == 3
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    shapes.clear()
    _, resumed = trainer.train_epoch(restored, 0, log=lambda *a: None,
                                     start_step=extra["epoch_step"])
    assert shapes == [(24, 40), (32, 48), (24, 40)]
    np.testing.assert_allclose(resumed["step_losses"],
                               full["step_losses"][3:], rtol=LOSS_RTOL)


def test_cli_trains_host8_dp_share_of_one_rank(tmp_path, capsys):
    """`--config host8_dp` with one rank's share (mesh.data 1, batch 2),
    both datasets synthetic at small sizes and synthetic_tiny's arch: the
    CLI trains an epoch of both shapes and evaluates on the main set."""
    from cspn_monodepth_tpu_torch.main import main as cli_main

    sets = {"mesh.data": 1, "train.batch_size": 2,
            "train.steps_per_epoch": 4, "data.dataset": "synthetic",
            "data.mix_dataset": "synthetic", "data.height": 32,
            "data.width": 48, "data.mix_height": 24, "data.mix_width": 40,
            "data.num_workers": 2, "train.epochs": 1, "train.log_every": 1,
            "model.arch": "", "model.encoder_stages": "1,1,1,1",
            "model.encoder_width": 16, "model.decoder_channels":
            "32,24,16,16", "model.decoder_out": 16, "model.num_iters": 4}
    args = ["--config", "host8_dp", "--device", "cpu", "--workdir",
            str(tmp_path)]
    for k, v in sets.items():
        args += ["--set", f"{k}={v}"]
    assert cli_main(args) == 0
    out = capsys.readouterr().out
    assert "epoch 0 step 3/4" in out and "eval rmse" in out
    assert CheckpointManager(str(tmp_path)).steps() == [4]
