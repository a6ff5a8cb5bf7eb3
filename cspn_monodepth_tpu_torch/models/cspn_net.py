"""The full depth network: ResNet UNet + heads + CSPN refinement (PyTorch).

Counterpart of cspn_monodepth_tpu/models/cspn_net.py:

  input (B, H, W, 3|4|1)  [rgb | rgb+sparse-depth | sparse-depth]
    -> ResNet encoder -> UpProj or UpConv decoder (skip concat)
    -> one 9-channel f32 3x3 head (channel 0 blur depth, 1..8 guidance)
    -> CSPN propagation (num_iters, anchored on the input's sparse channel)
    -> refined depth (B, H, W, 1)

With `cspn_kernel_sizes` or `cspn_checkpoints` set (the port only), the
refinement is CSPN++'s context-aware CSPN (Cheng, Wang, Guan, Yang, AAAI
2020, arXiv:1911.05377): one branch per stencil size k, each with its own
k^2 - 1 affinities, its iterate kept at every checkpoint t_j, and the
output mixed per pixel, D = sum_k s_k sum_j l_kj d_k^{t_j}, with s_k =
sigmoid(s^_k) / sum_k' sigmoid(s^_k') and l_kj = sigmoid(l^_kj) / sum_j'
sigmoid(l^_kj'). The head is then 1 + sum_k (k^2 - 1) + n_k + n_k n_c
channels, [blur, the affinities by k, s^ (n_k), l^ (n_k x n_c,
kernel-major)]: 96 for (3, 5, 7) and four checkpoints.

Dtypes as in the JAX package: the encoder and decoder run under bf16
autocast when `dtype` is bfloat16; the head and CSPN run in float32. The
head (`Head`) is ops/head_conv.py's `head_conv`: the 3 x 3 CSPN's 9-plane
head on the port's own f32 kernels, which read the decoder's map as it is
(bf16 or f32); CSPN++'s wider head cuDNN's float32 conv with TF32 off.

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
from cspn_monodepth_tpu_torch.ops.cspn_ref import KERNEL_SIZES
from cspn_monodepth_tpu_torch.ops.head_conv import head_conv
from cspn_monodepth_tpu_torch.parallel.halo import (
    cspn_propagate_spatial,
    gather_rows,
    scatter_rows,
)
from cspn_monodepth_tpu_torch.parallel.rows import Rows, conv2d_rows
from cspn_monodepth_tpu_torch.utils import profiling

# modality -> (input channels, index of the sparse-depth channel or None)
MODALITIES = {"rgbd": (4, 3), "rgb": (3, None), "d": (1, 0)}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# flax's lecun_normal: the standard deviation of a unit normal truncated at
# +-2, by which the drawn std is divided so that the variance is 1/fan_in.
TRUNC_STD = 0.87962566103423978


def cspnpp_plan(kernel_sizes: tuple, checkpoints: tuple,
                num_iters: int) -> tuple[tuple, tuple] | None:
    """The context-aware CSPN's (kernel sizes, checkpoints), or None for the
    plain CSPN ((3,) and ()). Sizes are distinct, increasing, of
    KERNEL_SIZES; checkpoints strictly increasing, positive and ending at
    num_iters; none given means the final iterate alone."""
    sizes, marks = tuple(kernel_sizes), tuple(checkpoints)
    if sizes == (3,) and not marks:
        return None
    if not sizes or any(k not in KERNEL_SIZES for k in sizes) or list(
            sizes) != sorted(set(sizes)):
        raise ValueError(f"cspn_kernel_sizes {sizes}: distinct, increasing, "
                         f"each of {KERNEL_SIZES}")
    marks = marks or (num_iters,)
    if (marks[0] < 1 or marks[-1] != num_iters
            or any(a >= b for a, b in zip(marks, marks[1:]))):
        raise ValueError(f"cspn_checkpoints {marks}: strictly increasing, "
                         f"positive, the last num_iters ({num_iters})")
    return sizes, marks


def head_channels(plan: tuple[tuple, tuple] | None) -> int:
    """1 blur + the affinities of each stencil, + for CSPN++ one size
    weight per stencil and one checkpoint weight per stencil and
    checkpoint."""
    if plan is None:
        return 9
    sizes, marks = plan
    return (1 + sum(k * k - 1 for k in sizes) + len(sizes)
            + len(sizes) * len(marks))


class Head(nn.Conv2d):
    """The head: a 3 x 3 conv with a bias (nn.Conv2d's parameters and
    state_dict keys) whose forward is ops/head_conv.py's head_conv, H padded
    by pad_h (1, or 0 on the rows layout's window), float32 out."""

    def forward(self, x: torch.Tensor, pad_h: int = 1) -> torch.Tensor:
        return head_conv(x, self, pad_h=pad_h)


def _head_window(x: torch.Tensor, head: Head) -> torch.Tensor:
    """The head on the rows layout's window, which holds its rows' halo."""
    return head(x, pad_h=0)


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
                 bn_group=None, spatial_mesh=None, layout: str = "images",
                 cspn_kernel_sizes: tuple = (3,),
                 cspn_checkpoints: tuple = ()):
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
        self.cspnpp = cspnpp_plan(cspn_kernel_sizes, cspn_checkpoints,
                                  num_iters)
        if self.cspnpp is not None and spatial_mesh is not None:
            raise ValueError(
                "a spatial mesh runs the 3x3 CSPN alone: its slab route "
                "(parallel/halo.py) exchanges a one-pixel halo and has no "
                "mix; cspn_kernel_sizes above 3 and cspn_checkpoints need "
                "mesh.spatial = 1")
        self.head = Head(decoder_out, head_channels(self.cspnpp), 3,
                         padding=1, bias=True)
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
                   cspn_kernel_sizes=tuple(c.cspn_kernel_sizes),
                   cspn_checkpoints=tuple(c.cspn_checkpoints),
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
        with torch.autocast(dev, enabled=False):
            heads = self.head(feat)                   # (B, 9, H, W) f32
        if self.cspnpp is not None:
            with torch.autocast(dev, enabled=False):
                return self._cspnpp(heads, sparse)[..., None]
        if self.spatial_mesh is not None:
            return self._propagate_spatial(heads, sparse)[..., None]
        refined = cspn_propagate(
            heads[:, 1:], heads[:, 0], sparse,
            num_iters=self.num_iters, norm_type=self.norm_type,
            impl=self.cspn_impl, guidance_layout="NCHW")
        return refined[..., None]

    def _cspnpp(self, heads, sparse):
        """CSPN++'s context-aware CSPN on the head's planes (B, C, H, W)
        float32 -> (B, H, W). Each stencil's branch runs in segments
        between checkpoints, d^{t_j} from d^{t_{j-1}}: the segment anchors
        an anchored plane (the identity) and renormalizes the same raw
        affinities, so the segments are one run of num_iters."""
        sizes, marks = self.cspnpp
        b, _, h, w = heads.shape
        with profiling.span("cspnpp.forward"):
            first = 1
            iterates = []
            for k in sizes:
                guidance = heads[:, first:first + k * k - 1]
                first += k * k - 1
                d, done = heads[:, 0], 0
                for t in marks:
                    d = cspn_propagate(
                        guidance, d, sparse, num_iters=t - done,
                        norm_type=self.norm_type, impl=self.cspn_impl,
                        guidance_layout="NCHW")
                    iterates.append(d)
                    done = t
            n_k, n_c = len(sizes), len(marks)
            with profiling.span("cspnpp.mix"):
                size_w = torch.sigmoid(heads[:, first:first + n_k])
                size_w = size_w / size_w.sum(1, keepdim=True)
                mark_w = torch.sigmoid(
                    heads[:, first + n_k:first + n_k + n_k * n_c]
                ).view(b, n_k, n_c, h, w)
                mark_w = mark_w / mark_w.sum(2, keepdim=True)
                stacked = torch.stack(iterates, 1).view(b, n_k, n_c, h, w)
                return (size_w * (mark_w * stacked).sum(2)).sum(1)

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
            norm_type=self.norm_type, impl=self.cspn_impl)
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
        with torch.autocast(x.device.type, enabled=False):
            heads = conv2d_rows(feat, self.head, full,
                                window_op=_head_window)
        lo, hi = full.range
        pad = -(-height // mesh.spatial) - (hi - lo)
        heads = F.pad(heads, (0, 0, 0, pad))
        if sparse is not None:
            sparse = F.pad(sparse[:, lo:hi], (0, 0, 0, pad))
        refined = cspn_propagate_spatial(
            heads[:, 1:], heads[:, 0], sparse, mesh=mesh,
            num_iters=self.num_iters, norm_type=self.norm_type,
            impl=self.cspn_impl)
        return refined[:, :hi - lo]
