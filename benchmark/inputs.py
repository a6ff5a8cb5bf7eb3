"""The traffic's inputs, made from the seed on the device in a few large
calls. A workload file gives the parameters; every seed gets the same
sizes and counts, only the values differ.

* `train_pool`: `pool` batches of `batch` images: rgb U[0, 1) float32
  (P, B, H, W, 3) and ground-truth depth U[lo, hi) float32 (P, B, H, W),
  valid (non-zero) on a `valid_share` of the pixels, zero elsewhere.
* `serve_pool`: `pool` requests of `batch` frames: rgb uint8 (P, B, H, W,
  3) and a sparse depth map float32 (P, B, H, W) with exactly
  `sparse_samples` non-zero pixels of depth U[lo, hi) per frame, as numpy
  arrays on the host (a client's request).
"""

from __future__ import annotations

import torch

from benchmark.weights import INPUTS, generator


def train_pool(traffic: dict, height: int, width: int, seed: int, device):
    g = generator(seed, INPUTS, device)
    shape = (traffic["pool"], traffic["batch"], height, width)
    lo, hi = traffic["depth_range"]
    rgb = torch.rand(shape + (3,), generator=g, device=device)
    depth = lo + (hi - lo) * torch.rand(shape, generator=g, device=device)
    share = traffic.get("valid_share", 1.0)
    if share < 1.0:
        valid = torch.rand(shape, generator=g, device=device) < share
        depth = torch.where(valid, depth, torch.zeros_like(depth))
    return rgb, depth


def serve_pool(traffic: dict, height: int, width: int, seed: int, device):
    g = generator(seed, INPUTS, device)
    p, b = traffic["pool"], traffic["batch"]
    n = traffic["sparse_samples"]
    lo, hi = traffic["depth_range"]
    rgb = torch.randint(0, 256, (p, b, height, width, 3), generator=g,
                        device=device, dtype=torch.uint8)
    scores = torch.rand((p * b, height * width), generator=g, device=device)
    where = torch.topk(scores, n, dim=1).indices
    values = lo + (hi - lo) * torch.rand((p * b, n), generator=g,
                                         device=device)
    sparse = torch.zeros((p * b, height * width), device=device)
    sparse.scatter_(1, where, values)
    return (rgb.cpu().numpy(),
            sparse.view(p, b, height, width).cpu().numpy())
