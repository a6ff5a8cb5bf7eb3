"""The full depth network: ResNet UNet + heads + CSPN refinement (PyTorch).

Counterpart of cspn_monodepth_tpu/models/cspn_net.py:

  input (B, H, W, 3|4|1)  [rgb | rgb+sparse-depth | sparse-depth]
    -> ResNet encoder -> UpProj or UpConv decoder (skip concat)
    -> one 9-channel f32 3x3 head (channel 0 blur depth, 1..8 guidance)
    -> CSPN propagation (num_iters, anchored on the input's sparse channel)
    -> refined depth (B, H, W, 1)

Dtypes as in the JAX package: the encoder and decoder run under bf16
autocast when `dtype` is bfloat16; the head and CSPN run in float32, the
head conv with TF32 off (cuDNN would otherwise use TF32 for f32 convs).

On a mesh (parallel/mesh.py) each rank runs the network on its own images
with BatchNorm over the global batch (`bn_group`), and with `spatial_mesh`
(a mesh whose "spatial" axis is > 1) the CSPN runs on H slabs of the data
group's images with a halo exchange (parallel/halo.py), as the JAX model
does with its `spatial_mesh`.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from cspn_monodepth_tpu_torch.models.resnet import (
    ARCHS,
    BatchNorm2d,
    ResNetEncoder,
)
from cspn_monodepth_tpu_torch.models.unet import UpProjDecoder
from cspn_monodepth_tpu_torch.ops.cspn import cspn_propagate
from cspn_monodepth_tpu_torch.ops.library import no_tf32
from cspn_monodepth_tpu_torch.parallel.halo import (
    cspn_propagate_spatial,
    gather_rows,
    scatter_rows,
)

# modality -> (input channels, index of the sparse-depth channel or None)
MODALITIES = {"rgbd": (4, 3), "rgb": (3, None), "d": (1, 0)}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class CSPNDepthNet(nn.Module):
    """ResNet UNet with CSPN refinement head.

    Parameters are initialized from `generator` (seed 0 when None): conv
    kernels lecun-normal, BN at identity, the head at zero, so that with
    "8sum_clamp" the CSPN starts as the identity map, as in the JAX package.

    bn_group: a process group over which train-mode BatchNorm takes its
    statistics (the mesh's world group), or None for this rank's batch.
    spatial_mesh: a parallel.Mesh whose spatial axis shards the CSPN, or
    None.
    """

    def __init__(self, modality: str = "rgbd", num_iters: int = 24,
                 norm_type: str = "8sum_clamp", cspn_impl: str = "auto",
                 dtype: str = "bfloat16", arch: str | None = "resnet50",
                 encoder_stages: tuple = (3, 4, 6, 3),
                 encoder_block: str = "bottleneck", encoder_width: int = 64,
                 decoder_channels: tuple = (512, 256, 128, 64),
                 decoder_out: int = 64, decoder_block: str = "upproj",
                 generator: torch.Generator | None = None,
                 bn_group=None, spatial_mesh=None):
        super().__init__()
        if modality not in MODALITIES:
            raise ValueError(f"unknown modality: {modality!r}")
        self.modality = modality
        self.num_iters = num_iters
        self.norm_type = norm_type
        self.cspn_impl = cspn_impl
        self.dtype = DTYPES[dtype]
        if arch:
            encoder_stages, encoder_block = ARCHS[arch]
        in_channels = MODALITIES[modality][0]
        self.encoder = ResNetEncoder(in_channels, tuple(encoder_stages),
                                     encoder_width, encoder_block)
        self.decoder = UpProjDecoder(self.encoder.skip_channels,
                                     tuple(decoder_channels), decoder_out,
                                     decoder_block)
        self.head = nn.Conv2d(decoder_out, 9, 3, padding=1, bias=True)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.reset_parameters(generator)
        self.spatial_mesh = spatial_mesh
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                m.group = bn_group

    @classmethod
    def from_config(cls, model_cfg, generator: torch.Generator | None = None,
                    mesh=None) -> "CSPNDepthNet":
        """Build from a configs.ModelConfig (packed_tail/packed_stem are TPU
        layout flags and are ignored), on `mesh` (a parallel.Mesh) when
        given: BatchNorm over its world group, the CSPN over its spatial
        axis when that is > 1."""
        c = model_cfg
        return cls(modality=c.modality, num_iters=c.num_iters,
                   norm_type=c.norm_type, cspn_impl=c.cspn_impl,
                   dtype=c.dtype, arch=c.arch or None,
                   encoder_stages=tuple(c.encoder_stages),
                   encoder_block=c.encoder_block,
                   encoder_width=c.encoder_width,
                   decoder_channels=tuple(c.decoder_channels),
                   decoder_out=c.decoder_out,
                   decoder_block=c.decoder_block, generator=generator,
                   bn_group=None if mesh is None else mesh.world_group,
                   spatial_mesh=(mesh if mesh is not None and mesh.spatial > 1
                                 else None))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and m is not self.head:
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(
                    m.weight.shape, generator=generator) / math.sqrt(fan_in))
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) float -> refined depth (B, H, W, 1) float32."""
        in_channels, sparse_ch = MODALITIES[self.modality]
        if x.dim() != 4 or x.shape[-1] != in_channels:
            raise ValueError(f"{self.modality} expects (B, H, W, "
                             f"{in_channels}), got {tuple(x.shape)}")
        h, w = x.shape[1:3]
        x = x.permute(0, 3, 1, 2).float().contiguous()
        # A channel of a contiguous NCHW tensor: contiguous planes with a
        # batch stride, which the kernel takes without a copy.
        sparse = None if sparse_ch is None else x[:, sparse_ch]

        dev = x.device.type
        with torch.autocast(dev, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            feat = self.decoder(self.encoder(x), (h, w))
        with torch.autocast(dev, enabled=False), no_tf32():
            heads = self.head(feat.float())           # (B, 9, H, W) f32
        if self.spatial_mesh is not None:
            return self._propagate_spatial(heads, sparse)[..., None]
        refined = cspn_propagate(
            heads[:, 1:], heads[:, 0], sparse,
            num_iters=self.num_iters, norm_type=self.norm_type,
            impl=self.cspn_impl, guidance_layout="NCHW")
        return refined[..., None]

    def _propagate_spatial(self, heads, sparse):
        """The CSPN on H slabs: the heads (and sparse plane) of this rank's
        images go to the spatial group as row shards, the refined rows come
        back (B, H, W)."""
        planes = heads if sparse is None else torch.cat(
            [heads, sparse[:, None]], dim=1)
        shards = scatter_rows(planes, self.spatial_mesh)
        refined = cspn_propagate_spatial(
            shards[:, 1:9], shards[:, 0],
            None if sparse is None else shards[:, 9],
            mesh=self.spatial_mesh, num_iters=self.num_iters,
            norm_type=self.norm_type,
            # "torch" keeps the plain slab body; any kernel route takes the
            # slab kernels K7-K9.
            impl="torch" if self.cspn_impl == "torch" else "auto")
        return gather_rows(refined[:, None], self.spatial_mesh,
                           heads.shape[2])[:, 0]
