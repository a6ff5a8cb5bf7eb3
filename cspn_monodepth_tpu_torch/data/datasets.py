"""Datasets of the port (its own copy of cspn_monodepth_tpu/data/datasets.py).

Records are channels-last float32 numpy arrays: rgb (H, W, 3) in [0, 1],
depth (H, W) in meters, 0 = invalid. Sparse sampling is not done here; it
runs on the device (ops/sparse.py). Records are random-access
(`__len__`/`get(index, epoch)`) and deterministic in (seed, index).

Only the synthetic set is ported so far; NYU-Depth-v2 and KITTI readers
(h5, packed memmaps, npz) and their augmentation come with the loop and
checkpoint slice, and raise until then.
"""

from __future__ import annotations

import numpy as np

from cspn_monodepth_tpu_torch.configs import DataConfig


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


def make_dataset(cfg: DataConfig, split: str, seed: int = 0):
    if cfg.dataset == "synthetic":
        return SyntheticDataset(cfg, split, seed)
    if cfg.dataset in ("nyudepthv2", "kitti"):
        raise NotImplementedError(
            f"the {cfg.dataset} reader is not ported yet; use "
            "data.dataset=synthetic")
    raise ValueError(f"unknown dataset {cfg.dataset!r}")
