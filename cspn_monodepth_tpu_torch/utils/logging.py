"""Run logs and image panels (the port's own copy of
cspn_monodepth_tpu/utils/logging.py).

train.csv / test.csv get one row per epoch under a fixed header; the
comparison panel is a strip rgb | sparse | gt | pred with the depth maps
jet-colored on one scale. The colormap is numpy; PNGs are written with
PIL, imported when an image is saved (a host without PIL can still train:
the Trainer's panel save catches the failure).
"""

from __future__ import annotations

import csv
import os

import numpy as np


class CSVLogger:
    """Append-only CSV with a fixed header, written once when the file is
    new (a resumed run appends to the same file)."""

    def __init__(self, path: str, fieldnames: list[str]):
        self.path = path
        self.fieldnames = fieldnames
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=fieldnames).writeheader()

    def append(self, row: dict):
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self.fieldnames).writerow(
                {k: row.get(k, "") for k in self.fieldnames})


def _jet(x: np.ndarray) -> np.ndarray:
    """Matplotlib-'jet'-style colormap: x in [0, 1] -> float rgb in [0, 1]."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0.0, 1.0)
    return np.stack([r, g, b], axis=-1)


def colored_depthmap(depth: np.ndarray, d_min: float | None = None,
                     d_max: float | None = None) -> np.ndarray:
    """Depth (H, W) -> uint8 (H, W, 3) jet-colored; invalid (<= 0) black."""
    depth = np.asarray(depth, np.float32)
    valid = depth > 0
    if d_min is None:
        d_min = float(depth[valid].min()) if valid.any() else 0.0
    if d_max is None:
        d_max = float(depth[valid].max()) if valid.any() else 1.0
    rel = (depth - d_min) / max(d_max - d_min, 1e-6)
    rgb = _jet(rel)
    rgb[~valid] = 0.0
    return (rgb * 255).astype(np.uint8)


def merge_into_row(rgb: np.ndarray, sparse: np.ndarray | None,
                   target: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Horizontal strip [rgb | sparse | gt | pred] as uint8 (H, W k, 3);
    the depth panels share the ground truth's color scale."""
    rgb8 = np.asarray(np.clip(rgb, 0, 1) * 255, np.uint8)
    valid = target > 0
    d_min = float(target[valid].min()) if valid.any() else 0.0
    d_max = float(target[valid].max()) if valid.any() else 1.0
    panels = [rgb8]
    if sparse is not None:
        panels.append(colored_depthmap(sparse, d_min, d_max))
    panels += [colored_depthmap(target, d_min, d_max),
               colored_depthmap(pred, d_min, d_max)]
    return np.concatenate(panels, axis=1)


def save_image(img: np.ndarray, path: str):
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(img).save(path)
