"""UNet decoder with FCRN-style UpProj or UpConv blocks (PyTorch, NCHW).

Counterpart of cspn_monodepth_tpu/models/unet.py in plain math: nearest 2x
unpool, then two branches (5x5 -> BN/ReLU -> 3x3 -> BN, and 5x5 -> BN),
summed and ReLU'd. With a skip, the 5x5 convs read the channel concat of
the unpooled map and the skip (the reference's `Gudi_UpProj_Block_Cat`).
The `upconv` family (`Simple_Gudi_UpConv_Block`) has one branch: the 5x5
conv of the same concat, BN, ReLU.

Odd sizes (228x304 is not divisible by 32): the 5x5 convs run on the
whole unpooled map and their OUTPUTS are cropped to the skip's H x W, the
order the JAX decoder uses. The skip is zero-extended to the unpooled size
first, which is the SAME zero padding of the skip once the output is
cropped. Cropping the unpooled map before the convs would change the last
row and column.

On rows (parallel/rows.py) the 5x5 convs compute only this rank's output
rows inside the skip's height, from a window of the unpooled map and the
skip with a 2-row halo (`unpool_cat_rows`): they read unpooled rows past
that height, and skip rows there read as zero, as above.

The TPU's sub-pixel decomposition and packed blocks are not ported; they
compute this same function.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cspn_monodepth_tpu_torch.models.resnet import batch_norm, conv
from cspn_monodepth_tpu_torch.parallel.rows import (
    Rows,
    conv2d_window,
    conv_on,
    unpool_cat_rows,
)


def _unpool_cat(x, skip):
    """Nearest 2x unpool of x, with the skip zero-extended to its size and
    concatenated along the channels."""
    x = F.interpolate(x, scale_factor=2, mode="nearest")
    if skip is None:
        return x
    sh, sw = skip.shape[-2:]
    skip = F.pad(skip, (0, x.shape[-1] - sw, 0, x.shape[-2] - sh))
    return torch.cat([x, skip.to(x.dtype)], dim=1)


def _up_convs(convs, x, out_hw, skip, rows):
    """The 5x5 convs of the unpooled concat, cropped to out_hw: on whole
    images, or (rows = (x's layout, the output's)) on this rank's rows."""
    oh, ow = out_hw
    if rows is None:
        x = _unpool_cat(x, skip)
        return [c(x)[:, :, :oh, :ow] for c in convs]
    x = unpool_cat_rows(x, *rows, convs[0].padding[0], skip)
    return [conv2d_window(x, c)[..., :ow] for c in convs]


class UpProjBlock(nn.Module):
    """FCRN up-projection with optional skip concatenation; the outputs of
    the 5x5 convs are cropped to `out_hw`."""

    def __init__(self, in_channels: int, channels: int,
                 skip_channels: int = 0):
        super().__init__()
        self.in_channels = in_channels
        self.skip_channels = skip_channels
        cin = in_channels + skip_channels
        self.conv1a = conv(cin, channels, 5)
        self.bn1a = batch_norm(channels)
        self.conv1b = conv(channels, channels, 3)
        self.bn1b = batch_norm(channels)
        self.conv2 = conv(cin, channels, 5)
        self.bn2 = batch_norm(channels)
        if skip_channels:
            for c in (self.conv1a, self.conv2):
                c.input_parts = (in_channels, skip_channels)

    def forward(self, x, out_hw: tuple[int, int], skip=None,
                rows: tuple[Rows, Rows] | None = None):
        """rows: None (whole images) or the layouts of x and of the output
        (whose height is out_hw's), x and skip this rank's rows."""
        a, c = _up_convs((self.conv1a, self.conv2), x, out_hw, skip, rows)
        a = F.relu(self.bn1a(a))
        a = self.bn1b(conv_on(self.conv1b, a, rows and rows[1]))
        c = self.bn2(c)
        return F.relu(a + c)


class UpConvBlock(nn.Module):
    """Single-branch up-convolution with optional skip concatenation:
    unpool 2x, one 5x5 conv cropped to `out_hw`, BN, ReLU. JAX keeps the
    kernel of the unpooled map (`conv_up`) apart from the skip's
    (`conv_skip`), a SAME conv added after the crop; the concat conv is
    their sum once the skip is zero-extended (module docstring)."""

    def __init__(self, in_channels: int, channels: int,
                 skip_channels: int = 0):
        super().__init__()
        self.in_channels = in_channels
        self.skip_channels = skip_channels
        self.conv = conv(in_channels + skip_channels, channels, 5)
        if skip_channels:
            self.conv.input_parts = (in_channels, skip_channels)
        self.bn = batch_norm(channels)

    def forward(self, x, out_hw: tuple[int, int], skip=None,
                rows: tuple[Rows, Rows] | None = None):
        """rows: as UpProjBlock's."""
        y, = _up_convs((self.conv,), x, out_hw, skip, rows)
        return F.relu(self.bn(y))


BLOCKS = {"upproj": UpProjBlock, "upconv": UpConvBlock}


class UpProjDecoder(nn.Module):
    """Bottleneck conv (halving the deepest width), four up blocks with
    skips /32 -> /2, then a final up block to full resolution, no skip.
    `block` picks the family: "upproj" (UpProjBlock) or "upconv"
    (UpConvBlock); the blocks are named upproj1..5 in both, as in JAX.

    skip_channels: channels of the encoder's (stem, c1, c2, c3, c4).
    """

    def __init__(self, skip_channels: tuple[int, ...],
                 channels: tuple[int, ...] = (512, 256, 128, 64),
                 channels_out: int = 64, block: str = "upproj"):
        super().__init__()
        if block not in BLOCKS:
            raise ValueError(f"unknown decoder block: {block!r}")
        block_cls = BLOCKS[block]
        stem_c, c1, c2, c3, c4 = skip_channels
        self.bottleneck = conv(c4, c4 // 2, 3)
        self.bottleneck_bn = batch_norm(c4 // 2)
        cin = c4 // 2
        for i, (ch, cs) in enumerate(zip(channels, (c3, c2, c1, stem_c))):
            self.add_module(f"upproj{i + 1}", block_cls(cin, ch, cs))
            cin = ch
        self.upproj5 = block_cls(cin, channels_out)

    def forward(self, skips, out_hw: tuple[int, int],
                rows: list[Rows] | None = None):
        """rows: None (whole images) or the layouts of the output and of
        (stem, c1, c2, c3, c4), the skips this rank's rows."""
        stem, c1, c2, c3, c4 = skips
        x = F.relu(self.bottleneck_bn(conv_on(self.bottleneck, c4,
                                              rows and rows[5])))
        for i, skip in enumerate((c3, c2, c1, stem)):
            hw = (skip.shape[-2] if rows is None else rows[4 - i].height,
                  skip.shape[-1])
            x = getattr(self, f"upproj{i + 1}")(
                x, hw, skip, rows and (rows[5 - i], rows[4 - i]))
        return self.upproj5(x, out_hw, rows=rows and (rows[1], rows[0]))
