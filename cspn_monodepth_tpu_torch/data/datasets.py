"""Datasets of the port (its own copy of cspn_monodepth_tpu/data/datasets.py).

Records are channels-last float32 numpy arrays: rgb (H, W, 3) in [0, 1],
depth (H, W) in meters, 0 = invalid. Sparse sampling is not done here; it
runs on the device (ops/sparse.py). Records are random-access
(`__len__`/`get(index, epoch)`) and deterministic in (seed, index).

Ported: the synthetic set and the KITTI npz reader with its augmentation
(data/transforms.py). The NYU-Depth-v2 readers (h5, packed memmaps) come
with the loop and checkpoint slice, and raise until then.
"""

from __future__ import annotations

import os

import numpy as np

from cspn_monodepth_tpu_torch.configs import DataConfig
from cspn_monodepth_tpu_torch.data.transforms import (
    train_transform,
    val_transform,
)


class SyntheticDataset:
    """Procedural RGB-D for tests and benchmarks: random smooth depth
    surfaces plus a shaded rendering, so training has learnable signal.
    The same records as the JAX package's SyntheticDataset."""

    def __init__(self, cfg: DataConfig, split: str, seed: int = 0):
        self.cfg = cfg
        self.split = split
        self.seed = seed if split == "train" else seed + 10_000
        self.length = 64
        self._cache: dict[int, dict[str, np.ndarray]] = {}

    def __len__(self) -> int:
        return self.length

    def get(self, index: int, epoch: int = 0) -> dict[str, np.ndarray]:
        # Records are deterministic in (seed, index): cache them so that
        # synthetic runs are not bound by numpy generation.
        cached = self._cache.get(index)
        if cached is not None:
            return cached
        rec = self._generate(index)
        if len(self._cache) < 4096:
            self._cache[index] = rec
        return rec

    def _generate(self, index: int) -> dict[str, np.ndarray]:
        c = self.cfg
        h, w = c.height, c.width
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, index]))
        yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                             indexing="ij")
        depth = np.full((h, w), 2.0, np.float32)
        for _ in range(4):  # random slanted planes (depth discontinuities)
            cy, cx = rng.uniform(0.2, 0.8, 2)
            ry, rx = rng.uniform(0.1, 0.4, 2)
            plane = (rng.uniform(1, 8)
                     + rng.uniform(-2, 2) * yy + rng.uniform(-2, 2) * xx)
            box = (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
            depth = np.where(box, plane.astype(np.float32), depth)
        depth = np.clip(depth, 0.5, c.max_depth).astype(np.float32)
        # Shading: rgb encodes depth gradients + noise => learnable.
        gy, gx = np.gradient(depth)
        rgb = np.stack([
            0.5 + 0.5 * np.tanh(4 * gy),
            0.5 + 0.5 * np.tanh(4 * gx),
            depth / c.max_depth,
        ], axis=-1).astype(np.float32)
        rgb += rng.normal(0, 0.02, rgb.shape).astype(np.float32)
        return {"rgb": np.clip(rgb, 0, 1), "depth": depth}


class KITTIDataset:
    """KITTI depth completion: `<root>/{train,val}/*.npz`, each with `rgb`
    (H, W, 3) uint8 and `depth` (H, W) float meters (0 = no lidar return),
    exported from the raw KITTI distribution; bottom crop to (height,
    width), 352x1216 in `kitti_1216`. The same records as the JAX package's
    KITTIDataset: training draws hflip and color jitter (no rotation or
    scale) from (seed, epoch, index); validation is the plain bottom crop.
    """

    def __init__(self, cfg: DataConfig, split: str, seed: int = 0):
        self.cfg = cfg
        self.split = split
        self.seed = seed
        split_dir = os.path.join(cfg.root,
                                 "train" if split == "train" else "val")
        self.files = []
        if os.path.isdir(split_dir):
            self.files = [os.path.join(split_dir, f)
                          for f in sorted(os.listdir(split_dir))
                          if f.endswith(".npz")]

    def __len__(self) -> int:
        return len(self.files)

    def get(self, index: int, epoch: int = 0) -> dict[str, np.ndarray]:
        with np.load(self.files[index]) as data:
            # float32 0..255 rgb: transforms._rgb_gain folds the 1/255 in.
            rgb = np.asarray(data["rgb"], np.float32)
            depth = np.asarray(data["depth"], np.float32)
        c = self.cfg
        if self.split == "train":
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, index]))
            rgb, depth = train_transform(
                rgb, depth, rng, out_h=c.height, out_w=c.width,
                rotate_deg=0.0, scale_max=1.0, hflip_prob=c.hflip_prob,
                jitter=c.jitter, crop="bottom")
        else:
            rgb, depth = val_transform(rgb, depth, out_h=c.height,
                                       out_w=c.width, crop="bottom")
        return {"rgb": rgb.astype(np.float32),
                "depth": depth.astype(np.float32)}


def make_dataset(cfg: DataConfig, split: str, seed: int = 0):
    if cfg.dataset == "synthetic":
        return SyntheticDataset(cfg, split, seed)
    if cfg.dataset == "kitti":
        return KITTIDataset(cfg, split, seed)
    if cfg.dataset == "nyudepthv2":
        raise NotImplementedError(
            "the nyudepthv2 readers are not ported yet; use "
            "data.dataset=synthetic or kitti")
    raise ValueError(f"unknown dataset {cfg.dataset!r}")
