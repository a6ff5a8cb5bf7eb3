"""The port's KITTI slice (data/transforms.py, native/, KITTIDataset, the
H-tiled CSPN route in a train step, the mesh guard) against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both sides; KITTI
records are npz files written to a temporary directory.
* Augmentation: `compose_affine`, `train_transform` and `val_transform`
  with both packages' numpy executors (their `native.lib` patched to None):
  exactly equal. The bottom crop of a raw 375x1242 frame to 352x1216
  starts at row 23 and column 13, and float rgb in 0..255 (what
  KITTIDataset reads) folds the 1/255 into the gain (the `> 1.5` rule).
* The port's C++ executor against its numpy one: rgb within atol 1e-5
  (bilinear weights in another order), depth bit for bit (the same index
  selection), tests/test_native_augment.py's tolerances.
* `KITTIDataset.get` against JAX's on raw 375x1242 frames, train and val
  splits, epochs 0 and 1: exactly equal (both executors run the same C++
  source, or both numpy).
* One and two `Trainer.train_step`s of a tiny model (synthetic_tiny's
  arch, float32) at a KITTI-proportioned 32x112 crop, reading the npz
  records, against the JAX Trainer leaf by leaf, with the tolerances of
  tests/test_torch_train.py: the port on its H-tiled route
  (`cspn_impl="cuda_tiled"`, whose CPU wrappers take K5's and K6's plain
  versions), JAX on `"pallas_tiled"` in interpret mode with 16-row adjoint
  tiles and its plain stem; the sparse map passed in; one `eval_step`
  with kitti_1216's 85 m eval cap, some ground truth beyond it.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cspn_monodepth_tpu.native as jax_native
import cspn_monodepth_tpu.ops.cspn_pallas as jax_cp
from cspn_monodepth_tpu.configs import get_config as jax_get_config
from cspn_monodepth_tpu.data import transforms as jax_tf
from cspn_monodepth_tpu.data.datasets import KITTIDataset as JaxKITTI
from cspn_monodepth_tpu.train.loop import Trainer as JaxTrainer
from cspn_monodepth_tpu.train.train_state import create_train_state
from cspn_monodepth_tpu_torch import native
from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.data import (
    KITTIDataset,
    NYUDataset,
    make_dataset,
)
from cspn_monodepth_tpu_torch.data import transforms as tf
from cspn_monodepth_tpu_torch.models import jax_variables
from cspn_monodepth_tpu_torch.ops import cspn_cuda
from cspn_monodepth_tpu_torch.train import Trainer
from test_torch_model import randomize

STATE_TOL = 1e-4
LOSS_TOL = 1e-5
RAW_HW = (375, 1242)
# synthetic_tiny's arch in float32 at a 32x112 crop of 36x118 frames, T=6
# (the port's rounds 4 + 2), 2 workers.
TINY = {"model.dtype": "float32", "model.arch": "",
        "model.encoder_stages": (1, 1, 1, 1), "model.encoder_width": 16,
        "model.decoder_channels": (32, 24, 16, 16), "model.decoder_out": 16,
        "model.num_iters": 6, "data.height": 32, "data.width": 112,
        "data.num_workers": 2, "train.batch_size": 2,
        "mesh.data": 1, "mesh.spatial": 1}
TINY_RAW_HW = (36, 118)


def write_kitti(root: Path, split: str, n: int, hw, seed: int):
    """n raw frames: uint8 rgb, and lidar-like depth (~5% returns,
    U(1, 90) m, some beyond the 85 m cap), 0 = no return."""
    rng = np.random.default_rng(seed)
    (root / split).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        rgb = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        depth = np.where(rng.random(hw) < 0.05, rng.uniform(1.0, 90.0, hw),
                         0.0).astype(np.float32)
        np.savez(root / split / f"{i:04d}.npz", rgb=rgb, depth=depth)


@pytest.fixture
def numpy_executors(monkeypatch):
    """Both packages' augmentation on their numpy executor."""
    monkeypatch.setattr(jax_native, "lib", lambda: None)
    monkeypatch.setattr(native, "lib", lambda: None)


@pytest.fixture
def native_lib():
    lib = native.lib()
    if lib is None:
        pytest.skip("no C++ compiler: the native executor cannot be built")
    return lib


# ------------------------------------------------------------ transforms
@pytest.mark.parametrize("kw", [
    dict(in_hw=RAW_HW, resized_hw=RAW_HW, out_hw=(352, 1216), crop="bottom"),
    dict(in_hw=RAW_HW, resized_hw=RAW_HW, out_hw=(352, 1216), crop="bottom",
         hflip=True),
    dict(in_hw=(480, 640), resized_hw=(304, 405), out_hw=(228, 304),
         crop="center", deg=4.2),
    dict(in_hw=(100, 90), resized_hw=(130, 117), out_hw=(96, 112),
         crop="center", deg=-5.0, hflip=True),
])
def test_compose_affine_matches_jax(kw):
    kw = dict(kw)
    args = (kw.pop("in_hw"), kw.pop("resized_hw"), kw.pop("out_hw"))
    np.testing.assert_array_equal(tf.compose_affine(*args, **kw),
                                  jax_tf.compose_affine(*args, **kw))


@pytest.mark.parametrize("rgb_kind", ["uint8", "float255", "float01"])
def test_transforms_match_jax_numpy(numpy_executors, rgb_kind):
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (60, 90, 3), dtype=np.uint8)
    rgb = {"uint8": raw, "float255": raw.astype(np.float32),
           "float01": raw.astype(np.float32) / 255.0}[rgb_kind]
    depth = np.where(rng.random((60, 90)) < 0.2,
                     rng.uniform(1, 90, (60, 90)), 0).astype(np.float32)
    for seed in range(4):
        for crop in ("bottom", "center"):
            kw = dict(out_h=48, out_w=80, rotate_deg=5.0, scale_max=1.5,
                      hflip_prob=0.5, jitter=0.2, crop=crop)
            got = tf.train_transform(rgb, depth, np.random.default_rng(seed),
                                     **kw)
            want = jax_tf.train_transform(rgb, depth,
                                          np.random.default_rng(seed), **kw)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    for kw in (dict(crop="bottom"), dict(crop="center"),
               dict(crop="center", resized_hw=(50, 75))):
        got = tf.val_transform(rgb, depth, out_h=48, out_w=64, **kw)
        want = jax_tf.val_transform(rgb, depth, out_h=48, out_w=64, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("executor", ["numpy", "native"])
def test_kitti_bottom_crop_and_rgb_gain(monkeypatch, executor):
    """A raw 375x1242 frame, rgb as the float32 0..255 KITTIDataset reads:
    the val transform is the crop [23:375, 13:1229] scaled by 1/255."""
    if executor == "numpy":
        monkeypatch.setattr(native, "lib", lambda: None)
    elif native.lib() is None:
        pytest.skip("no C++ compiler: the native executor cannot be built")
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (*RAW_HW, 3), dtype=np.uint8)
    depth = rng.uniform(0, 90, RAW_HW).astype(np.float32)
    got_rgb, got_depth = tf.val_transform(rgb.astype(np.float32), depth,
                                          out_h=352, out_w=1216,
                                          crop="bottom")
    gain = np.ones(3, np.float32) / 255.0
    np.testing.assert_array_equal(
        got_rgb, np.clip(rgb[23:, 13:1229].astype(np.float32) * gain, 0, 1))
    np.testing.assert_array_equal(got_depth, depth[23:, 13:1229])


@pytest.mark.parametrize("case", [
    dict(in_hw=RAW_HW, resized_hw=RAW_HW, out_hw=(352, 1216), deg=0.0,
         crop="bottom", hflip=True),
    dict(in_hw=(120, 160), resized_hw=(80, 106), out_hw=(72, 96), deg=2.0,
         crop="center", hflip=False),
])
def test_native_executor_matches_numpy(monkeypatch, native_lib, case):
    rng = np.random.default_rng(2)
    h, w = case["in_hw"]
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    depth = (rng.uniform(0, 90, (h, w)) * (rng.random((h, w)) < 0.3)).astype(
        np.float32)
    coef = tf.compose_affine(case["in_hw"], case["resized_hw"],
                             case["out_hw"], deg=case["deg"],
                             crop=case["crop"], hflip=case["hflip"])
    oh, ow = case["out_hw"]
    gain = rng.uniform(0.8, 1.2, 3).astype(np.float32) / 255.0
    for src in (rgb, rgb.astype(np.float32)):       # u8 and f32 entries
        got = tf.resample_pair(src, depth, coef, oh, ow, gain=gain,
                               depth_scale=0.9)
        with monkeypatch.context() as m:
            m.setattr(native, "lib", lambda: None)
            assert native.executor() == "numpy"
            want = tf.resample_pair(src, depth, coef, oh, ow, gain=gain,
                                    depth_scale=0.9)
        np.testing.assert_allclose(got[0], want[0], atol=1e-5)
        np.testing.assert_array_equal(got[1], want[1])
    assert native.executor() == "native"
    assert native.library_path().parent.name == "_build"


# ------------------------------------------------------------ the reader
@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_raw")
    write_kitti(root, "train", 3, RAW_HW, seed=3)
    write_kitti(root, "val", 2, RAW_HW, seed=4)
    return root


@pytest.mark.parametrize("split,epoch", [("train", 0), ("train", 1),
                                         ("val", 0)])
def test_kitti_records_match_jax(raw_root, split, epoch):
    overrides = {"data.root": str(raw_root)}
    ours = KITTIDataset(get_config("kitti_1216").override(**overrides).data,
                        split, seed=5)
    theirs = JaxKITTI(jax_get_config("kitti_1216").override(**overrides)
                      .data, split, seed=5)
    assert len(ours) == len(theirs) == (3 if split == "train" else 2)
    for i in range(len(ours)):
        a, b = ours.get(i, epoch), theirs.get(i, epoch)
        assert a["rgb"].shape == (352, 1216, 3) and a["rgb"].dtype == np.float32
        assert a["depth"].shape == (352, 1216)
        np.testing.assert_array_equal(a["rgb"], b["rgb"])
        np.testing.assert_array_equal(a["depth"], b["depth"])
    if split == "train":     # epochs draw other flips and gains
        other = ours.get(0, epoch + 1)
        assert not np.array_equal(other["rgb"], ours.get(0, epoch)["rgb"])


def test_make_dataset_reads_kitti_and_refuses_nyu(raw_root):
    cfg = get_config("kitti_1216").override(**{"data.root": str(raw_root)})
    assert isinstance(make_dataset(cfg.data, "val"), KITTIDataset)
    # The NYU readers are ported (tests/test_torch_nyu.py): a root without
    # packed shards gets the h5 reader, which finds no .h5 among KITTI's
    # npz frames; a dataset the package does not know is refused.
    nyu = make_dataset(dataclasses.replace(cfg.data, dataset="nyudepthv2"),
                       "train")
    assert isinstance(nyu, NYUDataset) and len(nyu) == 0
    with pytest.raises(ValueError, match="nyu"):
        make_dataset(dataclasses.replace(cfg.data, dataset="nyu"), "train")


# ------------------------------------------------------------ mesh guard
def test_trainer_refuses_a_mesh_it_cannot_run():
    """kitti_1216 asks for a 2x4 mesh: in one process, with no ranks to
    build it from, the port's Trainer refuses as the JAX package's
    make_mesh does, where it used to train unsharded silently."""
    cfg = get_config("kitti_1216").override(**{"data.dataset": "synthetic"})
    assert (cfg.mesh.data, cfg.mesh.spatial) == (2, 4)
    with pytest.raises(ValueError, match=r"mesh 2x4 needs 8 ranks, have 1"):
        Trainer(cfg, device="cpu")
    trainer = Trainer(cfg.override(**{"mesh.data": 1, "mesh.spatial": 1}),
                      device="cpu")
    assert trainer.steps_per_epoch >= 1 and trainer.mesh is None


# ------------------------------------------------------------ train steps
@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_tiny")
    write_kitti(root, "train", 4, TINY_RAW_HW, seed=6)
    write_kitti(root, "val", 2, TINY_RAW_HW, seed=7)
    return root


@pytest.fixture(scope="module")
def jax_run(tiny_root, tmp_path_factory):
    """The JAX Trainer on the tiny KITTI setup, H-tiled route in interpret
    mode: the state after one and two train steps on the first training
    records with an injected sparse map, and one eval step after two."""
    work = str(tmp_path_factory.mktemp("jax_kitti"))
    cfg = jax_get_config("kitti_1216").override(**{
        **TINY, "data.root": str(tiny_root), "model.packed_stem": False,
        "model.cspn_impl": "pallas_tiled", "train.checkpoint_dir": work})
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_cp, "pick_tile_h_bwd", lambda h, w, k, **kw: 16)
        trainer = JaxTrainer(cfg)
        init = trainer.init_state()
        variables = randomize(jax.device_get(
            {"params": init.params, "batch_stats": init.batch_stats}), 0)
        recs = [trainer.train_ds.get(i) for i in range(cfg.train.batch_size)]
        batch = {k: np.stack([r[k] for r in recs]) for k in ("rgb", "depth")}
        rng = np.random.default_rng(0)
        sparse = np.where(rng.random(batch["depth"].shape) < 0.5,
                          batch["depth"], 0.0).astype(np.float32)
        trainer._sample_sparse = lambda key, depth, rgb: jnp.asarray(sparse)
        key = jax.random.PRNGKey(0)
        state = create_train_state(variables, trainer.tx)
        states, losses = [], []
        for _ in range(2):
            state, loss, _ = trainer.train_step(state, batch, key)
            states.append(jax.device_get(
                {"params": state.params, "batch_stats": state.batch_stats}))
            losses.append(float(loss))
        eval_batch = dict(batch, valid_image=np.ones(len(recs), np.float32))
        sums, pred = trainer.eval_step(state, eval_batch, key, 0)
    return dict(variables=variables, batch=batch, sparse=sparse,
                states=states, losses=losses, eval_batch=eval_batch,
                eval_sums=jax.device_get(sums), eval_pred=np.asarray(pred))


@pytest.fixture(scope="module")
def port_run(tiny_root, jax_run):
    """The port's Trainer on the H-tiled route: its own records, the same
    weights and sparse map."""
    cfg = get_config("kitti_1216").override(**{
        **TINY, "data.root": str(tiny_root),
        "model.cspn_impl": "cuda_tiled"})
    trainer = Trainer(cfg, device="cpu")
    recs = [trainer.train_ds.get(i) for i in range(cfg.train.batch_size)]
    batch = {k: np.stack([r[k] for r in recs]) for k in ("rgb", "depth")}
    sparse = torch.from_numpy(jax_run["sparse"])
    trainer._sample_sparse = lambda gen, depth, rgb: sparse
    state = trainer.init_state(jax_run["variables"])
    states, losses = [], []
    before = [w.launches for w in cspn_cuda.WRAPPERS]
    for _ in range(2):
        state, loss, _ = trainer.train_step(state, batch)
        states.append(jax_variables(state.model))
        losses.append(float(loss))
    eval_batch = dict(batch, valid_image=np.ones(len(recs), np.float32))
    sums, pred = trainer.eval_step(state, eval_batch, 0)
    return dict(batch=batch, states=states, losses=losses, eval_sums=sums,
                eval_pred=pred.numpy(), step=state.step,
                eval_max_depth=cfg.data.eval_max_depth,
                launches=[w.launches for w in cspn_cuda.WRAPPERS] == before)


def test_kitti_batches_are_the_same_records(jax_run, port_run):
    for k in ("rgb", "depth"):
        np.testing.assert_array_equal(port_run["batch"][k],
                                      jax_run["batch"][k])
    assert port_run["batch"]["rgb"].shape == (2, 32, 112, 3)
    assert port_run["launches"]     # CPU tensors: plain versions, no kernel


@pytest.mark.parametrize("steps", [1, 2])
def test_kitti_train_steps_match_jax_leaf_by_leaf(jax_run, port_run, steps):
    assert port_run["losses"][steps - 1] == pytest.approx(
        jax_run["losses"][steps - 1], rel=LOSS_TOL)
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax_run["states"][steps - 1]))
    got = dict(jax.tree_util.tree_leaves_with_path(
        port_run["states"][steps - 1]))
    assert got.keys() == want.keys()
    init = dict(jax.tree_util.tree_leaves_with_path(jax_run["variables"]))
    for path, leaf in want.items():
        a, w = np.asarray(got[path], np.float64), np.asarray(leaf, np.float64)
        assert np.abs(a - w).max() <= STATE_TOL * np.abs(w).max(), \
            jax.tree_util.keystr(path)
    head = [p for p in want if "head" in jax.tree_util.keystr(p)]
    assert head and all(np.abs(want[p] - init[p]).max() > 0 for p in head)
    assert port_run["step"] == 2


def test_kitti_eval_step_with_the_depth_cap_matches_jax(jax_run, port_run):
    assert port_run["eval_max_depth"] == 85.0
    depth = jax_run["eval_batch"]["depth"]
    assert (depth > 85.0).any()         # the cap excludes some ground truth
    got, want = port_run["eval_sums"], jax_run["eval_sums"]
    for f in dataclasses.fields(got):
        if f.name != "protocol":
            np.testing.assert_allclose(float(getattr(got, f.name)),
                                       float(getattr(want, f.name)),
                                       rtol=1e-4)
    pred, ref = port_run["eval_pred"], jax_run["eval_pred"]
    assert np.abs(pred - ref).max() <= 1e-4 * np.abs(ref).max()
