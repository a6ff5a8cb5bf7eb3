"""Masked depth losses (PyTorch counterpart of cspn_monodepth_tpu/train/loss.py).

Both average over the valid ground-truth pixels (target > 0) of the whole
batch; the count is floored at 1, so an all-invalid batch gives 0.
"""

from __future__ import annotations

import torch


def _masked_mean(err: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mask = (target > 0).to(err.dtype)
    return (err * mask).sum() / mask.sum().clamp_min(1.0)


def masked_mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over valid-GT pixels (`MaskedMSELoss`)."""
    return _masked_mean((pred - target) ** 2, target)


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over valid-GT pixels (`MaskedL1Loss`)."""
    return _masked_mean((pred - target).abs(), target)


def get_loss_fn(name: str):
    try:
        return {"masked_mse": masked_mse_loss, "masked_l1": masked_l1_loss}[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}") from None
