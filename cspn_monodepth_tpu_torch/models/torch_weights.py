"""torchvision ResNet weights into the port's encoder (the reference's
`pretrained=True` workflow).

The port's own copy of the semantics of cspn_monodepth_tpu/models/
torch_weights.py (`convert_torch_resnet`, `load_pretrained_encoder`): a
torchvision ResNet `state_dict` (or a `.pth` file holding one) fills
`CSPNDepthNet.encoder`; the decoder and the head keep their weights.

Names: torchvision's `conv1`, `bn1`, `layerL.B.convN` / `bnN` and
`layerL.B.downsample.{0,1}` are the encoder's `conv1`, `bn1`,
`layer{L}_block{B}.convN` / `bnN` and `conv_proj` / `bn_proj`. Both are
torch layouts (OIHW kernels; BN weight, bias, running_mean, running_var),
so tensors are copied as they are, except conv1 for a modality other than
rgb: with 4 input channels (rgbd) the 4th is the mean of the RGB filters,
with 1 (d) that mean alone.

Strict, unlike the JAX package's converter: `fc.*` is ignored, every other
key must fill an encoder tensor of the same shape, and every encoder
tensor must be filled. `num_batches_tracked` is copied where the file has
it (files saved before torch 0.4.1 do not).
"""

from __future__ import annotations

import re

import torch
import torch.nn as nn

_BLOCK = re.compile(r"layer(\d+)\.(\d+)\.(.+)")
_DOWNSAMPLE = {"downsample.0": "conv_proj", "downsample.1": "bn_proj"}


def encoder_key(key: str) -> str:
    """The port encoder's state_dict key for a torchvision ResNet key."""
    m = _BLOCK.fullmatch(key)
    if m is None:
        return key
    layer, block, rest = m.groups()
    for src, dst in _DOWNSAMPLE.items():
        if rest.startswith(src + "."):
            rest = dst + rest[len(src):]
    return f"layer{layer}_block{block}.{rest}"


def convert_torch_resnet(state_dict, in_channels: int = 3
                         ) -> dict[str, torch.Tensor]:
    """A torchvision ResNet state_dict (name -> tensor or array) as the
    port encoder's {state_dict key: float32 CPU tensor}, conv1 widened or
    narrowed to `in_channels` (1, 3 or 4). `fc.*` is left out."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("fc."):
            continue
        t = torch.as_tensor(value).detach().cpu()
        if not key.endswith("num_batches_tracked"):
            t = t.float()
        out[encoder_key(key)] = t
    w1 = out["conv1.weight"]                      # (64, 3, 7, 7)
    if in_channels == 4:
        w1 = torch.cat([w1, w1.mean(dim=1, keepdim=True)], dim=1)
    elif in_channels == 1:
        w1 = w1.mean(dim=1, keepdim=True)
    elif in_channels != 3:
        raise ValueError(f"unsupported in_channels {in_channels}")
    out["conv1.weight"] = w1
    return out


@torch.no_grad()
def load_pretrained_encoder(encoder: nn.Module, path_or_state_dict,
                            in_channels: int | None = None) -> nn.Module:
    """Fill `encoder` (a models.ResNetEncoder) in place from a torchvision
    ResNet state_dict or the path of a .pth holding one (read with
    `torch.load(weights_only=True)`). `in_channels` defaults to the
    encoder's conv1. Raises on an unknown, missing or misshapen tensor.
    Returns the encoder."""
    sd = path_or_state_dict
    if isinstance(sd, (str, bytes)) or hasattr(sd, "__fspath__"):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if in_channels is None:
        in_channels = encoder.conv1.in_channels
    tensors = convert_torch_resnet(sd, in_channels)
    state = encoder.state_dict()
    unknown = sorted(k for k in tensors if k not in state)
    missing = sorted(k for k in state if k not in tensors
                     and not k.endswith("num_batches_tracked"))
    if unknown or missing:
        raise ValueError(f"torchvision weights vs the encoder: unknown "
                         f"{unknown}; missing {missing}")
    for key, t in tensors.items():
        dst = state[key]
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: torchvision shape {tuple(t.shape)} vs "
                             f"the encoder's {tuple(dst.shape)}")
        dst.copy_(t)
    return encoder
