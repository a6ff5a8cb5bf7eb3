"""Datasets of the port (its own copy of cspn_monodepth_tpu/data/datasets.py).

Records are channels-last float32 numpy arrays: rgb (H, W, 3) in [0, 1],
depth (H, W) in meters, 0 = invalid. Sparse sampling is not done here; it
runs on the device (ops/sparse.py). Records are random-access
(`__len__`/`get(index, epoch)`) and deterministic in (seed, index).

Readers: NYU-Depth-v2 from the h5 distribution (`NYUDataset`, h5py
imported on first read) or from the memmap shards of tools/prepare_nyu.py
(`PackedNYUDataset`), KITTI npz frames, and the synthetic set. Training
records are augmented by data/transforms.py. `make_dataset` picks the
packed NYU reader where its index files exist, as the JAX package does.
"""

from __future__ import annotations

import json
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

    def __init__(self, cfg: DataConfig, split: str, seed: int = 0,
                 length: int = 64):
        self.cfg = cfg
        self.split = split
        self.seed = seed if split == "train" else seed + 10_000
        self.length = length
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


class NYUDataset:
    """NYU-Depth-v2 from the sparse-to-dense h5 distribution:
    `<root>/{train,val}/<scene>/*.h5` (or `.h5` files directly under the
    split), each with `rgb` (3, 480, 640) uint8 and `depth` (480, 640)
    float32 meters. Training draws rotation, scale, hflip and color jitter
    from (seed, epoch, index) and center-crops to (height, width);
    validation resamples to half scale (240x320) and center-crops. The
    same records as the JAX package's NYUDataset."""

    RAW_HW = (480, 640)
    HALF_HW = (240, 320)

    def __init__(self, cfg: DataConfig, split: str, seed: int = 0):
        self.cfg = cfg
        self.split = split
        self.seed = seed
        split_dir = os.path.join(cfg.root,
                                 "train" if split == "train" else "val")
        self.files: list[str] = []
        if os.path.isdir(split_dir):
            for scene in sorted(os.listdir(split_dir)):
                scene_dir = os.path.join(split_dir, scene)
                if os.path.isdir(scene_dir):
                    self.files += [os.path.join(scene_dir, f)
                                   for f in sorted(os.listdir(scene_dir))
                                   if f.endswith(".h5")]
                elif scene.endswith(".h5"):
                    self.files.append(scene_dir)

    def __len__(self) -> int:
        return len(self.files)

    def _read(self, path: str) -> tuple[np.ndarray, np.ndarray]:
        import h5py

        with h5py.File(path, "r") as f:
            rgb = np.asarray(f["rgb"])          # (3, H, W) uint8
            depth = np.asarray(f["depth"])      # (H, W) float
        if rgb.ndim == 3 and rgb.shape[0] == 3:
            rgb = np.transpose(rgb, (1, 2, 0))
        return rgb, depth

    def get(self, index: int, epoch: int = 0) -> dict[str, np.ndarray]:
        rgb, depth = self._read(self.files[index])
        c = self.cfg
        if self.split == "train":
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, index]))
            rgb, depth = train_transform(
                rgb, depth, rng, out_h=c.height, out_w=c.width,
                rotate_deg=c.rotate_deg, scale_max=c.scale_max,
                hflip_prob=c.hflip_prob, jitter=c.jitter, crop="center")
        else:
            rgb, depth = val_transform(rgb, depth, out_h=c.height,
                                       out_w=c.width,
                                       resized_hw=self.HALF_HW, crop="center")
        return {"rgb": rgb.astype(np.float32),
                "depth": depth.astype(np.float32)}


class PackedNYUDataset:
    """NYU from the memmap shards of tools/prepare_nyu.py under `root`:
    `{split}_rgb.u8.npy` (N, H, W, 3) uint8, `{split}_depth.u16.npy`
    (N, H, W) uint16 meters * depth_scale, and `{split}_index.json`
    ({"n", "height", "width", "depth_scale", "files"}). Records are sliced
    out of the memmaps with no decoding; the same augmentation as
    NYUDataset, evaluation at half the index's (height, width). The same
    records as the JAX package's PackedNYUDataset."""

    def __init__(self, cfg: DataConfig, split: str, seed: int = 0):
        self.cfg = cfg
        self.split = "train" if split == "train" else "val"
        self.seed = seed
        with open(os.path.join(cfg.root, f"{self.split}_index.json")) as f:
            idx = json.load(f)
        self.n = idx["n"]
        self.depth_scale = float(idx.get("depth_scale", 256.0))
        self.rgb = np.load(os.path.join(cfg.root, f"{self.split}_rgb.u8.npy"),
                           mmap_mode="r")
        self.depth = np.load(
            os.path.join(cfg.root, f"{self.split}_depth.u16.npy"),
            mmap_mode="r")
        self._half_hw = (idx["height"] // 2, idx["width"] // 2)

    def __len__(self) -> int:
        return self.n

    def get(self, index: int, epoch: int = 0) -> dict[str, np.ndarray]:
        rgb = np.ascontiguousarray(self.rgb[index])          # uint8 HWC
        depth = self.depth[index].astype(np.float32) / self.depth_scale
        c = self.cfg
        if self.split == "train":
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, index]))
            rgb, depth = train_transform(
                rgb, depth, rng, out_h=c.height, out_w=c.width,
                rotate_deg=c.rotate_deg, scale_max=c.scale_max,
                hflip_prob=c.hflip_prob, jitter=c.jitter, crop="center")
        else:
            rgb, depth = val_transform(rgb, depth, out_h=c.height,
                                       out_w=c.width,
                                       resized_hw=self._half_hw,
                                       crop="center")
        return {"rgb": rgb, "depth": depth}


def _is_packed_nyu(root: str) -> bool:
    return (os.path.isfile(os.path.join(root, "train_index.json"))
            or os.path.isfile(os.path.join(root, "val_index.json")))


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
    if cfg.dataset == "nyudepthv2":
        if _is_packed_nyu(cfg.root):
            return PackedNYUDataset(cfg, split, seed)
        return NYUDataset(cfg, split, seed)
    if cfg.dataset == "kitti":
        return KITTIDataset(cfg, split, seed)
    if cfg.dataset == "synthetic":
        return SyntheticDataset(cfg, split, seed)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")
