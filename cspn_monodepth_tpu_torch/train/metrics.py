"""Depth metrics (PyTorch counterpart of cspn_monodepth_tpu/train/metrics.py).

Metric *sums* plus image and pixel counts are accumulated on the device,
one 0-d tensor each, and `finalize_metrics` turns them into the
reference's metric set: RMSE, MAE, REL, lg10, delta1/2/3, iRMSE, iMAE.

Two averaging protocols, as in the JAX package:
* "image" (default, the reference's `Result`/`AverageMeter`): each metric
  over one image's valid pixels, then averaged over images (RMSE is the
  mean of per-image RMSEs);
* "pixel": means over all valid pixels.
Both take an eval depth cap (`max_depth` > 0 excludes gt above it) and a
per-image `valid_image` weight that drops the padding of the last eval
batch. On the rows layout (parallel/rows.py) each rank holds some rows of
every image: each image's partial sums and pixel count are first summed
over the spatial group (`spatial_group`), then the image is finished, and
the finished sums are the same on every rank of the group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

FIELDS = ("n_images", "n_pixels", "rmse", "mae", "rel", "lg10", "delta1",
          "delta2", "delta3", "irmse", "imae")


@dataclasses.dataclass(frozen=True)
class MetricSums:
    """Running metric sums, each a 0-d float32 tensor.

    image protocol: each metric field is the sum over valid images of that
    image's metric; finalize divides by n_images. pixel protocol: rmse and
    irmse hold squared-error sums, the rest per-pixel sums; finalize
    divides by n_pixels and takes the square roots last.
    """

    n_images: torch.Tensor      # images with >= 1 valid pixel
    n_pixels: torch.Tensor      # valid pixels in those images
    rmse: torch.Tensor
    mae: torch.Tensor
    rel: torch.Tensor
    lg10: torch.Tensor
    delta1: torch.Tensor
    delta2: torch.Tensor
    delta3: torch.Tensor
    irmse: torch.Tensor
    imae: torch.Tensor
    protocol: str = "image"

    @classmethod
    def zeros(cls, protocol: str = "image",
              device: str | torch.device = "cpu") -> "MetricSums":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return cls(protocol=protocol, **{f: z for f in FIELDS})

    def __add__(self, other: "MetricSums") -> "MetricSums":
        if self.protocol != other.protocol:
            raise ValueError(
                f"cannot add MetricSums of protocol {self.protocol!r} "
                f"and {other.protocol!r}")
        return MetricSums(protocol=self.protocol, **{
            f: getattr(self, f) + getattr(other, f) for f in FIELDS})

    def all_reduce(self, group) -> "MetricSums":
        """The sums over every rank of the process group (each rank holding
        some of the batch's images)."""
        stacked = torch.stack([getattr(self, f) for f in FIELDS])
        dist.all_reduce(stacked, group=group)
        return MetricSums(protocol=self.protocol,
                          **dict(zip(FIELDS, stacked.unbind())))


def metric_sums_from_batch(
    pred: torch.Tensor,
    target: torch.Tensor,
    valid_image: torch.Tensor | None = None,
    max_depth: float = 0.0,
    protocol: str = "image",
    spatial_group=None,
) -> MetricSums:
    """Per-batch metric sums on the device.

    pred/target: (B, H, W) or (B, H, W, 1) depth in meters, or this rank's
    rows of them with the `spatial_group` that holds the others; target ==
    0 marks invalid pixels. Predictions are clamped to >= 1e-3 m before
    the ratio, inverse and log metrics, as in the JAX package.
    """
    if pred.dim() == 4:
        pred = pred[..., 0]
    if target.dim() == 4:
        target = target[..., 0]
    pred = pred.float()
    target = target.float()

    valid = target > 0
    if max_depth and max_depth > 0:
        valid &= target <= max_depth
    m = valid.float()
    if valid_image is not None:
        m = m * valid_image.float()[:, None, None]
    safe_t = torch.where(valid, target, torch.ones_like(target))
    safe_p = pred.clamp_min(1e-3)

    diff = safe_p - safe_t
    ratio = torch.maximum(safe_p / safe_t, safe_t / safe_p)
    inv_d = 1000.0 / safe_p     # 1/km, the reference's iRMSE/iMAE unit
    inv_g = 1000.0 / safe_t
    terms = {
        "rmse": diff ** 2,
        "mae": diff.abs(),
        "rel": diff.abs() / safe_t,
        "lg10": (torch.log10(safe_p) - torch.log10(safe_t)).abs(),
        "delta1": (ratio < 1.25).float(),
        "delta2": (ratio < 1.25 ** 2).float(),
        "delta3": (ratio < 1.25 ** 3).float(),
        "irmse": (inv_d - inv_g) ** 2,
        "imae": (inv_d - inv_g).abs(),
    }

    if protocol not in ("image", "pixel"):
        raise ValueError(f"unknown metrics protocol {protocol!r}")
    # (1 + terms, B): each image's pixel count and sums over its pixels.
    per_image = torch.stack([m.sum((1, 2))] + [(x * m).sum((1, 2))
                                               for x in terms.values()])
    if spatial_group is not None:
        dist.all_reduce(per_image, group=spatial_group)
    npix, per_image = per_image[0], dict(zip(terms, per_image[1:]))
    w = (npix > 0).float()                      # image weight
    if protocol == "pixel":
        return MetricSums(protocol="pixel", n_images=w.sum(),
                          n_pixels=npix.sum(),
                          **{k: x.sum() for k, x in per_image.items()})

    denom = npix.clamp_min(1.0)
    sums = {}
    for k, x in per_image.items():
        x = x / denom
        if k in ("rmse", "irmse"):
            x = x.sqrt()
        sums[k] = (x * w).sum()
    return MetricSums(protocol="image", n_images=w.sum(),
                      n_pixels=(npix * w).sum(), **sums)


def finalize_metrics(sums: MetricSums) -> dict[str, float]:
    """Reduce sums to the reference's metric dict (on the host)."""
    s = {f: float(getattr(sums, f)) for f in FIELDS}
    keys = FIELDS[2:]
    if sums.protocol == "image":
        n = max(s["n_images"], 1.0)
        out = {k: s[k] / n for k in keys}
    else:
        n = max(s["n_pixels"], 1.0)
        out = {k: s[k] / n for k in keys}
        out["rmse"] = float(np.sqrt(out["rmse"]))
        out["irmse"] = float(np.sqrt(out["irmse"]))
    out["n_valid_pixels"] = s["n_pixels"]
    out["n_images"] = s["n_images"]
    return out


class AverageMeter:
    """Host-side running averages for scalars (timings, loss)."""

    def __init__(self):
        self.sum: dict[str, float] = {}
        self.n: dict[str, int] = {}

    def update(self, **values: float):
        for k, v in values.items():
            self.sum[k] = self.sum.get(k, 0.0) + float(v)
            self.n[k] = self.n.get(k, 0) + 1

    def average(self) -> dict[str, float]:
        return {k: self.sum[k] / max(self.n[k], 1) for k in self.sum}
