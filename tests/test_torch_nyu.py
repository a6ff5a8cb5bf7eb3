"""The port's NYU-Depth-v2 readers and the resumable train iterator against
the JAX package's, on the CPU.

* A few raw 480x640 NYU frames in the h5 layout, written here with h5py,
  and their memmap shards from tools/prepare_nyu.py: the port's
  NYUDataset and PackedNYUDataset give the JAX readers' records bit for
  bit (train with its augmentation, and eval) at several (seed, epoch,
  index); `make_dataset` picks the same reader as JAX's.
* `make_train_iterator(start_step=s)` yields JAX's record indices from
  step s on, on 1, 2 and 4 ranks, and the tail of the run from step 0.
* A tiny Trainer trains and evaluates through the packed NYU reader.
"""

import numpy as np
import pytest
import torch

from cspn_monodepth_tpu.configs import DataConfig as JaxDataConfig
from cspn_monodepth_tpu.data import datasets as jax_datasets
from cspn_monodepth_tpu.data.pipeline import (
    make_train_iterator as jax_make_train_iterator,
)
from cspn_monodepth_tpu_torch.configs import DataConfig, get_config
from cspn_monodepth_tpu_torch.data import (
    NYUDataset,
    PackedNYUDataset,
    make_dataset,
    make_train_iterator,
)
from cspn_monodepth_tpu_torch.train import Trainer
from tools.prepare_nyu import main as prepare_nyu

FRAMES = {"train": 3, "val": 2}
TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Tiny shapes gain nothing from more torch threads, which only contend
    with the suite's other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nyu_roots(tmp_path_factory):
    """An h5 tree (train in a scene directory, val as files directly under
    the split) and its packed shards: uint8 rgb, depth in 0.5..9.5 m with
    a band of invalid (0) pixels."""
    import h5py

    root = tmp_path_factory.mktemp("nyu_h5")
    rng = np.random.default_rng(0)
    for split, n in FRAMES.items():
        d = root / split / "scene_a" if split == "train" else root / split
        d.mkdir(parents=True)
        for i in range(n):
            depth = rng.uniform(0.5, 9.5, (480, 640)).astype(np.float32)
            depth[:, :20] = 0.0
            with h5py.File(d / f"{i:05d}.h5", "w") as f:
                f["rgb"] = rng.integers(0, 256, (3, 480, 640), np.uint8)
                f["depth"] = depth
    packed = tmp_path_factory.mktemp("nyu_packed")
    prepare_nyu(["--src", str(root), "--out", str(packed)])
    return {"h5": str(root), "packed": str(packed)}


def configs(root: str):
    """The port's and JAX's data config of nyu_completion_500 on `root`
    (228x304, rotation, scale, flip and jitter)."""
    return (DataConfig(dataset="nyudepthv2", root=root),
            JaxDataConfig(dataset="nyudepthv2", root=root))


@pytest.mark.parametrize("layout,cls", [("h5", NYUDataset),
                                        ("packed", PackedNYUDataset)])
def test_make_dataset_picks_jax_reader(nyu_roots, layout, cls):
    port_cfg, jax_cfg = configs(nyu_roots[layout])
    for split in ("train", "val"):
        got = make_dataset(port_cfg, split)
        want = jax_datasets.make_dataset(jax_cfg, split)
        assert isinstance(got, cls)
        assert type(got).__name__ == type(want).__name__
        assert len(got) == len(want) == FRAMES[split]


@pytest.mark.parametrize("layout", ["h5", "packed"])
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("seed,epoch", [(0, 0), (3, 1), (7, 5)])
def test_records_equal_jax_bit_for_bit(nyu_roots, layout, split, seed,
                                       epoch):
    port_cfg, jax_cfg = configs(nyu_roots[layout])
    got_ds = make_dataset(port_cfg, split, seed=seed)
    want_ds = jax_datasets.make_dataset(jax_cfg, split, seed=seed)
    for index in range(len(want_ds)):
        got, want = got_ds.get(index, epoch), want_ds.get(index, epoch)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["rgb"].shape == (228, 304, 3)


def test_training_records_depend_on_epoch_and_eval_records_do_not(
        nyu_roots):
    port_cfg, _ = configs(nyu_roots["packed"])
    train = make_dataset(port_cfg, "train", seed=1)
    assert not np.array_equal(train.get(0, 0)["rgb"], train.get(0, 1)["rgb"])
    val = make_dataset(port_cfg, "val", seed=1)
    np.testing.assert_array_equal(val.get(1, 0)["depth"],
                                  val.get(1, 4)["depth"])


class _IndexRecords:
    """Records whose depth is their index."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def get(self, i: int, epoch: int = 0) -> dict[str, np.ndarray]:
        return {"rgb": np.full((1, 1, 3), i, np.uint8),
                "depth": np.full((1, 1), i, np.uint16)}


def _indices(make, n, rank, ranks, start_step, steps=5, epoch=2):
    it = make(_IndexRecords(n), global_batch=8, epoch=epoch, seed=4,
              num_workers=2, steps=steps, start_step=start_step,
              process_index=rank, process_count=ranks)
    try:
        return [b["depth"][:, 0, 0].tolist() for b in it]
    finally:
        it.close()


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("n", [6, 40])
def test_resumed_iterator_yields_jax_records(ranks, n):
    """From any start step each rank takes JAX's records, which are the
    uninterrupted run's from that step on; a start past the end yields
    nothing."""
    for rank in range(ranks):
        full = _indices(make_train_iterator, n, rank, ranks, 0)
        assert len(full) == 5
        for start in (0, 2, 4, 5):
            got = _indices(make_train_iterator, n, rank, ranks, start)
            assert got == _indices(jax_make_train_iterator, n, rank, ranks,
                                   start), (rank, start)
            assert got == full[start:], (rank, start)


def test_trainer_runs_through_the_packed_reader(nyu_roots):
    """A tiny model trains two steps and evaluates through PackedNYUDataset
    at 32x48 (nyu_completion_500's data settings otherwise)."""
    cfg = get_config("synthetic_tiny").override(**{
        "data.dataset": "nyudepthv2", "data.root": nyu_roots["packed"],
        "data.height": 32, "data.width": 48, "data.num_samples": 20,
        "data.num_workers": 2, "train.steps_per_epoch": 2})
    trainer = Trainer(cfg, device="cpu")
    assert isinstance(trainer.train_ds, PackedNYUDataset)
    state = trainer.init_state()
    state, metrics = trainer.train_epoch(state, 0, log=lambda *a: None)
    assert state.step == 2 and np.isfinite(metrics["loss"])
    ev = trainer.evaluate(state, log=lambda *a: None, save_panels=False)
    assert ev["n_images"] == FRAMES["val"] and np.isfinite(ev["rmse"])
