"""ResNet encoder for the depth network (PyTorch, NCHW).

Counterpart of cspn_monodepth_tpu/models/resnet.py: conv1 7x7/s2 (as many
input channels as the modality has), BN+ReLU, 3x3/s2 max pool, then
bottleneck stages producing /4, /8, /16, /32 features. Module names follow
the JAX parameter tree (`layer{stage}_block{i}/conv1`, ...), so that
models/convert.py maps one onto the other by name.

Only the bottleneck family (ResNet-50) is ported; the basic-block family
(ResNet-18/34) raises. The TPU's packed stem is not ported: the plain
convolution is the same math.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch.nn as nn
import torch.nn.functional as F

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


def batch_norm(c: int) -> nn.BatchNorm2d:
    # flax momentum 0.9 on the running average is torch momentum 0.1.
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
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
        self.conv_proj = self.bn_proj = None
        if strides != 1 or in_channels != out:
            self.conv_proj = conv(in_channels, out, 1, strides)
            self.bn_proj = batch_norm(out)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.bn_proj(self.conv_proj(x))
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    """ResNet-v1 encoder returning the skip pyramid (stem, c1, c2, c3, c4):
    stem /2 with `width` channels (after conv1+BN+ReLU, before the pool),
    c1..c4 at /4../32 with 4*width*(1, 2, 4, 8) channels."""

    def __init__(self, in_channels: int,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, block: str = "bottleneck"):
        super().__init__()
        if block == "basic":
            raise NotImplementedError(
                "the basic-block encoder (resnet18/34) is not ported yet")
        if block != "bottleneck":
            raise ValueError(f"unknown encoder block: {block!r}")
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
                    name, Bottleneck(cin, width * 2 ** stage, strides))
                cin = width * 2 ** stage * Bottleneck.expansion
                names.append(name)
            self.stages.append(names)

    @property
    def skip_channels(self) -> tuple[int, ...]:
        """Channels of (stem, c1, c2, c3, c4)."""
        return (self.conv1.out_channels,) + tuple(
            getattr(self, names[-1]).bn3.num_features
            for names in self.stages)

    def forward(self, x):
        stem = F.relu(self.bn1(self.conv1(x)))
        # Pads with -inf, as the JAX package's max pool does.
        x = F.max_pool2d(stem, 3, 2, 1)
        skips = [stem]
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            skips.append(x)
        return tuple(skips)
