"""Typed dataclass configs + named configs for every BASELINE.json entry.

The port's own copy of cspn_monodepth_tpu/configs.py (the port imports
nothing of the JAX package): the same fields, names and values, so that
`get_config(name)` describes the same model and data in both packages.
Differences: `model.cspn_impl` takes the port's values (auto | torch),
and `synthetic_tiny` uses "auto" where the JAX package forces its plain
"jnp" loop (on the CPU "auto" runs the kernels' plain versions here).
Port only: `model.cspn_kernel_sizes` and `model.cspn_checkpoints` (CSPN++'s
context-aware propagation; their defaults are the plain CSPN, which is
all the JAX package has) and the named config `kitti_1216_cspnpp`, which
the JAX package does not have.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    modality: str = "rgbd"          # rgb | rgbd | d
    num_iters: int = 24             # CSPN prop_time (12 or 24 headline)
    norm_type: str = "8sum_clamp"   # 8sum | 8sum_abs | 8sum_clamp
    # CSPN (ops/cspn.py): "auto" the hand-written kernels at every image
    # size (JAX's "auto", which picks "pallas" or "pallas_tiled" by size),
    # "torch" the plain loop under autograd (JAX's "jnp").
    cspn_impl: str = "auto"
    dtype: str = "bfloat16"         # encoder/decoder compute dtype
    # Architecture (defaults = ResNet-50 UNet, the reference headline).
    # arch: resnet18 | resnet34 | resnet50 preset, or "" to use the
    # explicit stage/block fields below (tiny test archs).
    arch: str = "resnet50"
    encoder_stages: tuple = (3, 4, 6, 3)
    encoder_block: str = "bottleneck"
    encoder_width: int = 64
    decoder_channels: tuple = (512, 256, 128, 64)
    decoder_out: int = 64
    decoder_block: str = "upproj"   # upproj (Gudi_UpProj_Block_Cat) |
                                    # upconv (Simple_Gudi_UpConv_Block)
    # TPU layout flags of the JAX package (space-to-depth packed decoder
    # tail and encoder stem). Accepted so that configs stay identical, and
    # ignored: the port computes the plain math, which the JAX package's
    # tests show equal to the packed forms.
    packed_tail: bool = True
    packed_stem: bool = True
    # Path to a torchvision ResNet checkpoint (.pth) to graft into the
    # encoder at init — the reference's `pretrained=True` workflow (4th
    # input channel = mean of RGB filters); Trainer.init_state grafts it
    # (models/torch_weights.py). "" = random init.
    pretrained: str = ""
    # Refuse to train without a pretrained encoder (the paper-exact
    # "8sum" recipe is unstable from scratch — ops/cspn_ref.py norm note).
    require_pretrained: bool = False
    # CSPN++'s context-aware CSPN (Cheng et al., AAAI 2020): one branch per
    # stencil size (3, 5, 7, each with its own affinities), each branch's
    # iterate kept at these iterations (increasing, the last num_iters),
    # and the output mixed per pixel over sizes and checkpoints with
    # weights the head predicts (models/cspn_net.py). (3,) and () are the
    # plain CSPN: one 3x3 stencil, its final iterate, a 9-channel head.
    cspn_kernel_sizes: tuple = (3,)
    cspn_checkpoints: tuple = ()


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "nyudepthv2"     # nyudepthv2 | kitti | synthetic
    root: str = "/data/nyudepthv2"
    height: int = 228
    width: int = 304
    num_samples: int = 500          # sparse samples (0 = none)
    sampler: str = "uniform"        # uniform | stereo (SimulatedStereo)
    max_depth: float = 10.0         # meters (NYU); 85.0 for KITTI
    # Eval-only gt depth cap (SURVEY.md section 4.4: KITTI eval capped
    # 0-80/85 m). Pixels with gt > cap are excluded from eval metrics.
    # 0 = no cap (NYU).
    eval_max_depth: float = 0.0
    # Augmentation (SURVEY.md section 4.4 / R10)
    rotate_deg: float = 5.0
    scale_max: float = 1.5
    hflip_prob: float = 0.5
    jitter: float = 0.2
    num_workers: int = 8
    # Mixed training (BASELINE config 4, "NYU+KITTI mixed"): every
    # mix_every-th step draws a batch from a secondary dataset. Shapes may
    # differ (fully-convolutional model); jit caches one executable per
    # shape. Sparse sampling uses max(max_depth, mix_max_depth).
    mix_dataset: str = ""           # "" = no mixing
    mix_root: str = ""
    mix_height: int = 352
    mix_width: int = 1216
    mix_max_depth: float = 85.0
    mix_every: int = 2


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8             # global batch
    epochs: int = 40
    steps_per_epoch: int = 0        # 0 = derive from dataset size
    optimizer: str = "sgd"          # sgd | adam
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    clip_norm: float = 1.0          # global-norm grad clip (0 = off);
                                    # framework addition, reference has none
    lr_decay_every: int = 5         # epochs
    lr_decay_rate: float = 0.2
    loss: str = "masked_mse"        # masked_mse | masked_l1
    # Metric averaging protocol (train/metrics.py): "image" = reference
    # Result/AverageMeter per-image averaging (paper-comparable numbers);
    # "pixel" = global-pixel means.
    metrics_protocol: str = "image"
    # LR multiplier for the (pretrained) encoder subtree — the reference
    # recipe sometimes runs pretrained layers at 0.1x lr (SURVEY.md 4.6).
    encoder_lr_mult: float = 1.0
    seed: int = 0
    checkpoint_dir: str = "/tmp/cspn_ckpt"
    checkpoint_every: int = 1000    # steps
    log_every: int = 50


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh: data-parallel x spatial-parallel (SURVEY.md N1/N2)."""
    data: int = 1                   # batch-sharding axis size
    spatial: int = 1                # H-sharding axis size (halo exchange)


def _coerce(value, current, key: str):
    """Coerce a CLI string override to the type of the field's current
    value. `type(current)(value)` is wrong for bools ("False" is truthy)
    and tuples (tuple("1,2") iterates characters), which made some fields
    unsweepable from the command line (SURVEY.md section 4.6 requires the
    recipe to be trivially sweepable)."""
    if current is None or isinstance(value, type(current)):
        return value
    if not isinstance(value, str):
        return type(current)(value)
    if isinstance(current, bool):
        low = value.strip().lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"{key}: cannot parse {value!r} as bool")
    if isinstance(current, tuple):
        body = value.strip().strip("()[]")
        elem = type(current[0]) if current else int
        return tuple(elem(v.strip()) for v in body.split(",") if v.strip())
    return type(current)(value)


@dataclass(frozen=True)
class Config:
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def override(self, **dotted) -> "Config":
        """Apply {'train.lr': 0.005}-style overrides, returning a new Config."""
        cfg = self
        for key, value in dotted.items():
            parts = key.split(".")
            if len(parts) == 1:
                cfg = dataclasses.replace(cfg, **{parts[0]: value})
                continue
            section = getattr(cfg, parts[0])
            current = getattr(section, parts[1])
            value = _coerce(value, current, key)
            cfg = dataclasses.replace(
                cfg, **{parts[0]: dataclasses.replace(section, **{parts[1]: value})})
        return cfg


def _cfg(name: str, **kw) -> Config:
    return Config(name=name).override(**kw)


# One named config per BASELINE.json "configs" entry.
CONFIGS: dict[str, Config] = {
    # 1. NYU single-image inference, 12 iters, 304x228
    "nyu_infer_304": _cfg(
        "nyu_infer_304",
        **{"model.num_iters": 12, "data.num_samples": 500,
           "train.batch_size": 1}),
    # 2. NYU depth completion, 500 samples, batch training on 1 chip
    "nyu_completion_500": _cfg(
        "nyu_completion_500",
        **{"model.num_iters": 24, "data.num_samples": 500,
           "train.batch_size": 8}),
    # 2b. Paper-exact NYU completion recipe (VERDICT round-1 item 7):
    # the published norm ("8sum"), ImageNet-pretrained encoder REQUIRED
    # (set model.pretrained=/path/to/resnet50.pth via --set), encoder at
    # 0.1x lr. This is the config whose trained metrics are compared to
    # the paper table (BASELINE.md).
    "nyu_completion_500_ref": _cfg(
        "nyu_completion_500_ref",
        **{"model.num_iters": 24, "data.num_samples": 500,
           "train.batch_size": 8, "model.norm_type": "8sum",
           "model.require_pretrained": True,
           "train.encoder_lr_mult": 0.1}),
    # 3. KITTI 1216x352 with spatially-sharded CSPN + halo exchange, 1 host
    "kitti_1216": _cfg(
        "kitti_1216",
        **{"data.dataset": "kitti", "data.root": "/data/kitti",
           "data.height": 352, "data.width": 1216, "data.max_depth": 85.0,
           "data.eval_max_depth": 85.0,
           "data.rotate_deg": 0.0, "data.scale_max": 1.0,
           "model.num_iters": 24, "train.batch_size": 8,
           "mesh.data": 2, "mesh.spatial": 4}),
    # 4. NYU+KITTI mixed, 24-iter CSPN, DP across a full host (8 chips)
    "host8_dp": _cfg(
        "host8_dp",
        **{"model.num_iters": 24, "train.batch_size": 64, "mesh.data": 8,
           "data.mix_dataset": "kitti", "data.mix_root": "/data/kitti",
           "data.mix_every": 2}),
    # 5. Multi-host large-batch training with sharded feature maps
    "multihost": _cfg(
        "multihost",
        **{"model.num_iters": 24, "train.batch_size": 256,
           "mesh.data": 16, "mesh.spatial": 2}),
    # 6. CSPN++ on KITTI (port only; Cheng, Wang, Guan, Yang, AAAI 2020,
    # arXiv:1911.05377): kitti_1216's data, a ResNet-34 UpProj UNet, the
    # context-aware CSPN with 3x3, 5x5 and 7x7 stencils mixed per pixel
    # over the iterates at 6, 12, 18 and 24 iterations (a 96-channel
    # head), batch 8 on one card. "arch" sets the encoder's blocks; the
    # block fields say the same, since the benchmark holds them to its
    # configuration file.
    "kitti_1216_cspnpp": _cfg(
        "kitti_1216_cspnpp",
        **{"data.dataset": "kitti", "data.root": "/data/kitti",
           "data.height": 352, "data.width": 1216, "data.max_depth": 85.0,
           "data.eval_max_depth": 85.0,
           "data.rotate_deg": 0.0, "data.scale_max": 1.0,
           "model.arch": "resnet34", "model.encoder_block": "basic",
           "model.encoder_stages": (3, 4, 6, 3),
           "model.num_iters": 24, "model.norm_type": "8sum_clamp",
           "model.cspn_kernel_sizes": (3, 5, 7),
           "model.cspn_checkpoints": (6, 12, 18, 24),
           "train.batch_size": 8, "mesh.data": 1, "mesh.spatial": 1}),
    # Test/dev config: tiny synthetic data + tiny encoder, CPU-runnable
    # (XLA-CPU compile of the full 115M-param model takes minutes; the
    # tiny arch keeps the test suite fast while exercising every code path)
    "synthetic_tiny": _cfg(
        "synthetic_tiny",
        **{"data.dataset": "synthetic", "data.height": 64, "data.width": 96,
           "data.num_samples": 50, "model.num_iters": 4,
           "train.batch_size": 2, "train.epochs": 1,
           "train.steps_per_epoch": 4, "model.cspn_impl": "auto",
           "model.arch": "",
           "model.encoder_stages": (1, 1, 1, 1), "model.encoder_width": 16,
           "model.decoder_channels": (32, 24, 16, 16),
           "model.decoder_out": 16}),
}


def get_config(name: str) -> Config:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]
