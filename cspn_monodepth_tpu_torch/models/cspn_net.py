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

On a mesh (parallel/mesh.py) BatchNorm takes the global batch's
statistics (`bn_group`). With `spatial_mesh` (a mesh whose "spatial" axis
is > 1) the network runs in one of two layouts, which the Trainer picks
(parallel/mesh.py `choose_layout`):
* "images": each rank runs the network on its own whole images, and the
  CSPN runs on H slabs of the data group's images behind two all_to_alls
  (parallel/halo.py `scatter_rows`/`gather_rows`);
* "rows": each rank is given the data group's whole images and computes,
  at every level, only its rows of them (parallel/rows.py), as the JAX
  model shards every feature map over "spatial": the stem reads its rows
  and their halo from the input, every later conv, pool and unpool
  exchanges halos in the spatial group, the f32 head runs on the rows,
  and the CSPN runs on them with its halo exchange and no reshard. The
  output is this rank's rows of the refined depth.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

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
from cspn_monodepth_tpu_torch.parallel.rows import Rows, conv2d_rows

# modality -> (input channels, index of the sparse-depth channel or None)
MODALITIES = {"rgbd": (4, 3), "rgb": (3, None), "d": (1, 0)}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# flax's lecun_normal: the standard deviation of a unit normal truncated at
# +-2, by which the drawn std is divided so that the variance is 1/fan_in.
TRUNC_STD = 0.87962566103423978


class CSPNDepthNet(nn.Module):
    """ResNet UNet with CSPN refinement head.

    Parameters are initialized from `generator` (seed 0 when None) as the
    JAX package's flax modules initialize theirs: conv kernels lecun-normal
    (a normal truncated at two standard deviations, scaled to variance
    1/fan_in, fan_in = k*k*cin), each input part of a decoder conv that
    reads a concat (the unpooled map and the skip, JAX's `*_up` and
    `*_skip` kernels) with its own fan-in; BN at identity; the head at
    zero, so that with "8sum_clamp" the CSPN starts as the identity map.

    bn_group: a process group over which train-mode BatchNorm takes its
    statistics (the mesh's world group), or None for this rank's batch.
    spatial_mesh: a parallel.Mesh whose spatial axis shards the CSPN (the
    "images" layout) or every feature map ("rows"), or None.
    layout: "images" or "rows" (which needs `spatial_mesh`).
    """

    def __init__(self, modality: str = "rgbd", num_iters: int = 24,
                 norm_type: str = "8sum_clamp", cspn_impl: str = "auto",
                 dtype: str = "bfloat16", arch: str | None = "resnet50",
                 encoder_stages: tuple = (3, 4, 6, 3),
                 encoder_block: str = "bottleneck", encoder_width: int = 64,
                 decoder_channels: tuple = (512, 256, 128, 64),
                 decoder_out: int = 64, decoder_block: str = "upproj",
                 generator: torch.Generator | None = None,
                 bn_group=None, spatial_mesh=None, layout: str = "images"):
        super().__init__()
        if modality not in MODALITIES:
            raise ValueError(f"unknown modality: {modality!r}")
        self.modality = modality
        self.num_iters = num_iters
        self.norm_type = norm_type
        self.cspn_impl = cspn_impl
        if dtype not in DTYPES:
            # float16 would need loss scaling (a GradScaler), which the JAX
            # package's train step does not have either.
            raise ValueError(f"model.dtype {dtype!r} is not supported: "
                             f"use one of {sorted(DTYPES)}")
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
        if layout not in ("images", "rows"):
            raise ValueError(f"unknown layout {layout!r}: images or rows")
        if layout == "rows" and spatial_mesh is None:
            raise ValueError("the rows layout needs a spatial axis > 1")
        self.layout = layout
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                m.group = bn_group

    @classmethod
    def from_config(cls, model_cfg, generator: torch.Generator | None = None,
                    mesh=None, layout: str = "images") -> "CSPNDepthNet":
        """Build from a configs.ModelConfig (packed_tail/packed_stem are TPU
        layout flags and are ignored), on `mesh` (a parallel.Mesh) when
        given: BatchNorm over its world group, its spatial axis (when > 1)
        sharding the CSPN (`layout` "images") or every feature map
        ("rows")."""
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
                                 else None),
                   layout=layout)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and m is not self.head:
                k = m.weight[0, 0].numel()
                parts = getattr(m, "input_parts", (m.in_channels,))
                for w in m.weight.split(parts, dim=1):
                    std = 1.0 / (TRUNC_STD * math.sqrt(k * w.shape[1]))
                    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                          generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) float -> refined depth (B, H, W, 1) float32; on
        rows, x holds the data group's whole images and the result is this
        rank's rows of them, (B, h_s, W, 1)."""
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
        if self.layout == "rows":
            return self._forward_rows(x, sparse)[..., None]
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

    def _forward_rows(self, x, sparse):
        """The network on this rank's rows of x's whole images (B, C, H, W)
        -> the refined depth of those rows (B, h_s, W). Where H does not
        split evenly, the last shard's heads and sparse plane are
        zero-padded to ceil(H / S) rows for the CSPN, as scatter_rows pads
        the images layout's shards."""
        mesh = self.spatial_mesh
        height, w = x.shape[-2:]
        full = Rows(mesh, height, "full resolution")
        levels = [full] + self.encoder.levels(full)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            feat = self.decoder(self.encoder(x, full), (height, w), levels)
        with torch.autocast(x.device.type, enabled=False), no_tf32():
            heads = conv2d_rows(feat.float(), self.head, full)
        lo, hi = full.range
        pad = -(-height // mesh.spatial) - (hi - lo)
        heads = F.pad(heads, (0, 0, 0, pad))
        if sparse is not None:
            sparse = F.pad(sparse[:, lo:hi], (0, 0, 0, pad))
        refined = cspn_propagate_spatial(
            heads[:, 1:], heads[:, 0], sparse, mesh=mesh,
            num_iters=self.num_iters, norm_type=self.norm_type,
            impl="torch" if self.cspn_impl == "torch" else "auto")
        return refined[:, :hi - lo]
