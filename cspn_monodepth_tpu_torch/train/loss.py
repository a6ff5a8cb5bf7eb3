"""Masked depth losses (PyTorch counterpart of cspn_monodepth_tpu/train/loss.py).

Both average over the valid ground-truth pixels (target > 0) of the whole
batch; the count is floored at 1, so an all-invalid batch gives 0.

With a process `group` (a mesh's world group, each rank holding some of the
batch's images) a rank's loss is its own sum over the global count, so that
the ranks' losses and their gradients sum to the global batch's. The count
is all-reduced without a gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _masked_mean(err: torch.Tensor, target: torch.Tensor,
                 group=None) -> torch.Tensor:
    mask = (target > 0).to(err.dtype)
    count = mask.sum()
    if group is not None:
        dist.all_reduce(count, group=group)
    return (err * mask).sum() / count.clamp_min(1.0)


def masked_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    group=None) -> torch.Tensor:
    """Mean squared error over valid-GT pixels (`MaskedMSELoss`)."""
    return _masked_mean((pred - target) ** 2, target, group)


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Mean absolute error over valid-GT pixels (`MaskedL1Loss`)."""
    return _masked_mean((pred - target).abs(), target, group)


def get_loss_fn(name: str):
    try:
        return {"masked_mse": masked_mse_loss, "masked_l1": masked_l1_loss}[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}") from None
