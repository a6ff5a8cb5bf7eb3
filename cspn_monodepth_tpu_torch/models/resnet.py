"""ResNet encoder for the depth network (PyTorch, NCHW).

Counterpart of cspn_monodepth_tpu/models/resnet.py: conv1 7x7/s2 (as many
input channels as the modality has), BN+ReLU, 3x3/s2 max pool, then
stages of bottleneck blocks (ResNet-50) or basic blocks (ResNet-18/34)
producing /4, /8, /16, /32 features. Module names follow the JAX parameter
tree (`layer{stage}_block{i}/conv1`, ...), so that models/convert.py maps
one onto the other by name, and models/torch_weights.py maps torchvision's
names onto them. The TPU's packed stem is not ported: the plain
convolution is the same math.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cspn_monodepth_tpu_torch.parallel.comm import all_reduce
from cspn_monodepth_tpu_torch.parallel.rows import (
    Rows,
    conv2d_rows,
    conv_on,
    max_pool_rows,
)

# arch name -> (stage_sizes, block kind), as in the JAX package.
ARCHS = {
    "resnet18": ((2, 2, 2, 2), "basic"),
    "resnet34": ((3, 4, 6, 3), "basic"),
    "resnet50": ((3, 4, 6, 3), "bottleneck"),
}


def conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    """Bias-free conv with symmetric k//2 zero padding (torch-style; the
    JAX package pads the same way so torchvision weights port exactly)."""
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose train-mode update of `running_var` folds in the
    biased batch variance, as flax's BatchNorm does; torch's own update
    uses the unbiased one, n/(n-1) larger. Normalization itself uses the
    biased variance in both. The statistics are reduced in float32 also
    for a bf16 input under autocast (torch's kernels accumulate in f32),
    as flax reduces them in f32.

    With a process `group` (set by CSPNDepthNet on a mesh) the train-mode
    statistics are those of the global batch, as flax computes them under
    pjit: each rank's per-channel f32 sum and sum of squares go through a
    differentiable all_reduce, and the biased variance E[x^2] - E[x]^2
    (flax's fast variance, floored at 0) feeds both the normalization and
    the running statistics. torch's SyncBatchNorm is CUDA-only and updates
    with the unbiased variance."""

    group = None

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if self.group is not None:
            return self._global_batch_norm(x)
        self.num_batches_tracked.add_(1)
        n = x.numel() // x.shape[1]
        m = self.momentum
        # torch's update goes into a copy (autograd keeps it, so the
        # statistic itself may then change in place): it folds in
        # m * v * n/(n-1); the statistic gets m * v in its place.
        folded = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, folded, self.weight,
                         self.bias, True, m, self.eps)
        with torch.no_grad():
            prev = (1 - m) * self.running_var
            self.running_var.copy_(prev + (folded - prev) * ((n - 1) / n))
        return y

    def _global_batch_norm(self, x):
        self.num_batches_tracked.add_(1)
        xf = x.float()
        count = xf.new_full((x.shape[1],), x.numel() // x.shape[1])
        sums = all_reduce(torch.stack([xf.sum((0, 2, 3)),
                                       (xf * xf).sum((0, 2, 3)), count]),
                          self.group)
        n = sums[2]
        mean = sums[0] / n
        var = (sums[1] / n - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (xf - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


def batch_norm(c: int) -> BatchNorm2d:
    # flax momentum 0.9 on the running average is torch momentum 0.1.
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


class _Residual(nn.Module):
    """The shortcut of both block kinds: a 1x1/s conv + BN projection
    where the block changes the shape (JAX's `residual.shape != y.shape`),
    the identity elsewhere."""

    def _shortcut(self, in_channels: int, out: int, strides: int):
        self.out_channels = out
        self.conv_proj = self.bn_proj = None
        if strides != 1 or in_channels != out:
            self.conv_proj = conv(in_channels, out, 1, strides)
            self.bn_proj = batch_norm(out)

    def _join(self, x, y, rows):
        residual = x
        if self.conv_proj is not None:
            residual = self.bn_proj(conv_on(self.conv_proj, x, rows))
        return F.relu(y + residual)


class Bottleneck(_Residual):
    """1x1 -> 3x3 -> 1x1 bottleneck with identity/projection shortcut."""

    expansion = 4

    def __init__(self, in_channels: int, channels: int, strides: int = 1):
        super().__init__()
        out = channels * self.expansion
        self.conv1 = conv(in_channels, channels, 1)
        self.bn1 = batch_norm(channels)
        self.conv2 = conv(channels, channels, 3, strides)
        self.bn2 = batch_norm(channels)
        self.conv3 = conv(channels, out, 1)
        self.bn3 = batch_norm(out)
        self._shortcut(in_channels, out, strides)

    def forward(self, x, rows: Rows | None = None):
        """x: whole images, or this rank's rows laid out as `rows`."""
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(conv_on(self.conv2, y, rows)))
        return self._join(x, self.bn3(self.conv3(y)), rows)


class BasicBlock(_Residual):
    """3x3/s -> 3x3 basic residual block (ResNet-18/34), expansion 1: the
    first block of layer1 (64 -> 64, stride 1) has no projection."""

    expansion = 1

    def __init__(self, in_channels: int, channels: int, strides: int = 1):
        super().__init__()
        self.conv1 = conv(in_channels, channels, 3, strides)
        self.bn1 = batch_norm(channels)
        self.conv2 = conv(channels, channels, 3)
        self.bn2 = batch_norm(channels)
        self._shortcut(in_channels, channels, strides)

    def forward(self, x, rows: Rows | None = None):
        """x: whole images, or this rank's rows laid out as `rows`."""
        y = F.relu(self.bn1(conv_on(self.conv1, x, rows)))
        out = rows and rows.down(self.conv1.stride[0])
        return self._join(x, self.bn2(conv_on(self.conv2, y, out)), rows)


BLOCKS = {"bottleneck": Bottleneck, "basic": BasicBlock}


class ResNetEncoder(nn.Module):
    """ResNet-v1 encoder returning the skip pyramid (stem, c1, c2, c3, c4):
    stem /2 with `width` channels (after conv1+BN+ReLU, before the pool),
    c1..c4 at /4../32 with e*width*(1, 2, 4, 8) channels, e the block's
    expansion (4 for bottleneck, 1 for basic blocks)."""

    def __init__(self, in_channels: int,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, block: str = "bottleneck"):
        super().__init__()
        if block not in BLOCKS:
            raise ValueError(f"unknown encoder block: {block!r}")
        block_cls = BLOCKS[block]
        self.conv1 = nn.Conv2d(in_channels, width, 7, 2, padding=3,
                               bias=False)
        self.bn1 = batch_norm(width)
        self.stages: list[list[str]] = []
        cin = width
        for stage, num_blocks in enumerate(stage_sizes):
            names = []
            for i in range(num_blocks):
                name = f"layer{stage + 1}_block{i}"
                strides = 2 if stage > 0 and i == 0 else 1
                self.add_module(
                    name, block_cls(cin, width * 2 ** stage, strides))
                cin = width * 2 ** stage * block_cls.expansion
                names.append(name)
            self.stages.append(names)

    @property
    def skip_channels(self) -> tuple[int, ...]:
        """Channels of (stem, c1, c2, c3, c4)."""
        return (self.conv1.out_channels,) + tuple(
            getattr(self, names[-1]).out_channels
            for names in self.stages)

    def levels(self, rows: Rows) -> list[Rows]:
        """The layouts of (stem, c1, c2, c3, c4) for an input laid out as
        `rows`: /2, /4, ..., each ceil(height / 2) of the one before."""
        out = [rows.down(2, "/2")]
        for stage in range(len(self.stages)):
            out.append(out[-1].down(2, f"/{2 ** (stage + 2)}"))
        return out

    def forward(self, x, rows: Rows | None = None):
        """x: whole images. With `rows` (the input's layout, x still whole)
        every feature map is this rank's rows: the stem reads its own rows
        and their halo from x, the rest exchange halos."""
        if rows is None:
            stem = F.relu(self.bn1(self.conv1(x)))
            # Pads with -inf, as the JAX package's max pool does.
            x = F.max_pool2d(stem, 3, 2, 1)
        else:
            levels = self.levels(rows)
            stem = F.relu(self.bn1(conv2d_rows(x, self.conv1, rows,
                                               whole=True)))
            x = max_pool_rows(stem, levels[0])
        skips = [stem]
        for stage, names in enumerate(self.stages):
            for i, name in enumerate(names):
                # The first block of stages 2-4 reads the level above.
                level = stage + 1 if i or stage == 0 else stage
                x = getattr(self, name)(x, rows and levels[level])
            skips.append(x)
        return tuple(skips)
