"""The plain reference of the depth network: ResNet UNet, 9-channel head and
CSPN refinement, written from the published description in plain PyTorch.

Cheng, Wang, Yang, "Learning Depth with Convolutional Spatial Propagation
Network", TPAMI 2019 (arXiv:1810.02695): a ResNet encoder (conv1 7x7/2,
BN, ReLU, 3x3/2 max pool, bottleneck stages), an UpProj decoder whose
blocks read the concat of the 2x nearest-unpooled map and the encoder's
skip (5x5 -> BN/ReLU -> 3x3 -> BN, plus 5x5 -> BN, summed and ReLU'd; the
5x5 outputs cropped to the skip's size), one 3x3 head of 9 channels
(channel 0 the blurred depth, 1..8 the affinities) and T iterations of
the CSPN on the affinities normalized by max(sum |g|, 1) ("8sum_clamp"),
d^0 and every iterate anchored to the sparse samples.

The network is functional: `forward(params, x, spec, precision)` reads
every tensor from `params` by the names the benchmark's weight maker
gives (benchmark/weights.py), so it takes the same seeded tensors as the
program and nothing the program made. It imports nothing of the program.

`Precision` names the arithmetic of the three parts: the encoder and
decoder under bf16 autocast ("bfloat16") or with each convolution's input
and weight rounded to fp8 e4m3 by a per-tensor scale first ("fp8"); the
head convolution and the CSPN in "float32" (TF32 off) or "bfloat16". The
configuration states bf16 / float32 / float32; the control one step below
each is fp8 / bfloat16 / bfloat16; "network" lowers the encoder and
decoder alone (fp8 / float32 / float32), the part of the answer that the
control's bf16 CSPN would otherwise hide.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

# (dy, dx) of the 8 neighbours, row-major with the centre left out: channel
# k of the affinities weights the neighbour at (i + dy, j + dx).
NEIGHBOURS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
              (1, 1))
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
FP8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Precision:
    network: str = "bfloat16"
    head: str = "float32"
    cspn: str = "float32"


STATED = Precision()
CONTROL = Precision("fp8", "bfloat16", "bfloat16")
# The lower precisions a control may put in the program's place, by name.
LOWER = {"precision": CONTROL, "network": Precision("fp8")}


@dataclasses.dataclass(frozen=True)
class Spec:
    """The sizes of one configuration (benchmark/configs/<name>.json)."""

    in_channels: int = 4
    stages: tuple = (3, 4, 6, 3)
    width: int = 64
    decoder_channels: tuple = (512, 256, 128, 64)
    decoder_out: int = 64
    num_iters: int = 24

    @classmethod
    def from_config(cls, conf: dict) -> "Spec":
        m = conf["model"]
        return cls(in_channels=m["in_channels"], stages=tuple(m["stages"]),
                   width=m["width"],
                   decoder_channels=tuple(m["decoder_channels"]),
                   decoder_out=m["decoder_out"], num_iters=m["num_iters"])


# ------------------------------------------------------------- shapes

def _conv_shape(cout, cin, k):
    return (cout, cin, k, k)


def _bn(shapes: dict, name: str, c: int):
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        shapes[f"{name}.{leaf}"] = (c,)


def shapes(spec: Spec) -> dict[str, tuple]:
    """Every float tensor of the network by name, in a fixed order: conv
    weights (cout, cin, k, k), BatchNorm's weight, bias and running
    statistics (c,), the head's weight and bias."""
    s: dict[str, tuple] = {}
    w = spec.width
    s["encoder.conv1.weight"] = _conv_shape(w, spec.in_channels, 7)
    _bn(s, "encoder.bn1", w)
    cin = w
    skips = [w]
    for stage, blocks in enumerate(spec.stages):
        mid = w * 2 ** stage
        out = 4 * mid
        for i in range(blocks):
            p = f"encoder.layer{stage + 1}_block{i}"
            stride = 2 if stage > 0 and i == 0 else 1
            s[f"{p}.conv1.weight"] = _conv_shape(mid, cin, 1)
            _bn(s, f"{p}.bn1", mid)
            s[f"{p}.conv2.weight"] = _conv_shape(mid, mid, 3)
            _bn(s, f"{p}.bn2", mid)
            s[f"{p}.conv3.weight"] = _conv_shape(out, mid, 1)
            _bn(s, f"{p}.bn3", out)
            if stride != 1 or cin != out:
                s[f"{p}.conv_proj.weight"] = _conv_shape(out, cin, 1)
                _bn(s, f"{p}.bn_proj", out)
            cin = out
        skips.append(cin)
    c4 = skips[-1]
    s["decoder.bottleneck.weight"] = _conv_shape(c4 // 2, c4, 3)
    _bn(s, "decoder.bottleneck_bn", c4 // 2)
    cin = c4 // 2
    outs = list(spec.decoder_channels) + [spec.decoder_out]
    skip_c = [skips[3], skips[2], skips[1], skips[0], 0]
    for i, (ch, cs) in enumerate(zip(outs, skip_c)):
        p = f"decoder.upproj{i + 1}"
        s[f"{p}.conv1a.weight"] = _conv_shape(ch, cin + cs, 5)
        _bn(s, f"{p}.bn1a", ch)
        s[f"{p}.conv1b.weight"] = _conv_shape(ch, ch, 3)
        _bn(s, f"{p}.bn1b", ch)
        s[f"{p}.conv2.weight"] = _conv_shape(ch, cin + cs, 5)
        _bn(s, f"{p}.bn2", ch)
        cin = ch
    s["head.weight"] = _conv_shape(9, spec.decoder_out, 3)
    s["head.bias"] = (9,)
    return s


# ------------------------------------------------------------- network

def _fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to fp8 e4m3 under a per-tensor scale (amax -> 448), back
    in t's dtype; the gradient passes straight through."""
    scale = FP8_MAX / t.detach().abs().amax().float().clamp_min(1e-12)
    q = ((t.detach().float() * scale).to(torch.float8_e4m3fn).float()
         / scale).to(t.dtype)
    return t + (q - t).detach()


class _Net:
    """One forward pass over `params` in train (batch statistics) or eval
    (running statistics) mode."""

    def __init__(self, params: dict, train: bool, precision: Precision):
        self.p = params
        self.train = train
        self.fp8 = precision.network == "fp8"

    def conv(self, name: str, x, stride: int = 1):
        w = self.p[f"{name}.weight"]
        k = w.shape[-1]
        if self.fp8:
            dt = torch.get_autocast_dtype(x.device.type)
            x, w = _fake_fp8(x.to(dt)), _fake_fp8(w.to(dt))
        return F.conv2d(x, w, None, stride, k // 2)

    def bn(self, name: str, x):
        p = self.p
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        if self.train:
            # Batch statistics; the running ones are read, not kept.
            mean, var = mean.detach().clone(), var.detach().clone()
        return F.batch_norm(x, mean, var, p[f"{name}.weight"],
                            p[f"{name}.bias"], self.train, BN_MOMENTUM,
                            BN_EPS)

    def bottleneck(self, prefix: str, x, stride: int):
        y = F.relu(self.bn(f"{prefix}.bn1", self.conv(f"{prefix}.conv1", x)))
        y = F.relu(self.bn(f"{prefix}.bn2",
                           self.conv(f"{prefix}.conv2", y, stride)))
        y = self.bn(f"{prefix}.bn3", self.conv(f"{prefix}.conv3", y))
        if f"{prefix}.conv_proj.weight" in self.p:
            x = self.bn(f"{prefix}.bn_proj",
                        self.conv(f"{prefix}.conv_proj", x, stride))
        return F.relu(y + x)

    def encoder(self, x, spec: Spec):
        stem = F.relu(self.bn("encoder.bn1",
                              self.conv("encoder.conv1", x, 2)))
        x = F.max_pool2d(stem, 3, 2, 1)
        skips = [stem]
        for stage, blocks in enumerate(spec.stages):
            for i in range(blocks):
                x = self.bottleneck(f"encoder.layer{stage + 1}_block{i}", x,
                                    2 if stage > 0 and i == 0 else 1)
            skips.append(x)
        return skips

    def upproj(self, prefix: str, x, out_hw, skip):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            sh, sw = skip.shape[-2:]
            skip = F.pad(skip, (0, x.shape[-1] - sw, 0, x.shape[-2] - sh))
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        oh, ow = out_hw
        a = self.conv(f"{prefix}.conv1a", x)[:, :, :oh, :ow]
        c = self.conv(f"{prefix}.conv2", x)[:, :, :oh, :ow]
        a = F.relu(self.bn(f"{prefix}.bn1a", a))
        a = self.bn(f"{prefix}.bn1b", self.conv(f"{prefix}.conv1b", a))
        return F.relu(a + self.bn(f"{prefix}.bn2", c))

    def decoder(self, skips, out_hw):
        stem, c1, c2, c3, c4 = skips
        x = F.relu(self.bn("decoder.bottleneck_bn",
                           self.conv("decoder.bottleneck", c4)))
        for i, skip in enumerate((c3, c2, c1, stem)):
            x = self.upproj(f"decoder.upproj{i + 1}", x, skip.shape[-2:],
                            skip)
        return self.upproj("decoder.upproj5", x, out_hw, None)


@contextlib.contextmanager
def _fp32_convs():
    """cuDNN convolutions in full float32 (its default is TF32)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def cspn(guidance, blur, sparse, num_iters: int):
    """T iterations of d <- g0 d + sum_k g_k d(i + dy_k, j + dx_k) on
    (B, 8, H, W) affinities normalized by max(sum_k |g_k|, 1), g0 = 1 -
    sum_k g_k, d zero outside the image; d^0 = blur and each iterate
    anchored: d <- (1 - m) d + m sparse, m = [sparse > 0]."""
    gates = guidance / guidance.abs().sum(1, keepdim=True).clamp_min(1.0)
    g0 = 1.0 - gates.sum(1)
    m = (sparse > 0).to(blur.dtype)
    d = (1.0 - m) * blur + m * sparse
    h, w = d.shape[-2:]
    for _ in range(num_iters):
        pad = F.pad(d, (1, 1, 1, 1))
        new = g0 * d
        for k, (dy, dx) in enumerate(NEIGHBOURS):
            new = new + gates[:, k] * pad[:, 1 + dy:1 + dy + h,
                                          1 + dx:1 + dx + w]
        d = (1.0 - m) * new + m * sparse
    return d


def forward(params: dict, x: torch.Tensor, spec: Spec, train: bool,
            precision: Precision = STATED) -> torch.Tensor:
    """x (B, H, W, C) float32, the sparse depth in its last channel ->
    refined depth (B, H, W) float32."""
    net = _Net(params, train, precision)
    h, w = x.shape[1:3]
    x = x.permute(0, 3, 1, 2).float().contiguous()
    sparse = x[:, -1]
    dev = x.device.type
    # The meta device (count.py) has no autocast; the FLOPs are the same.
    with (contextlib.nullcontext() if dev == "meta" else
          torch.autocast(dev, dtype=torch.bfloat16)):
        feat = net.decoder(net.encoder(x, spec), (h, w))
    head_dt = torch.bfloat16 if precision.head == "bfloat16" else torch.float32
    with _fp32_convs():
        heads = F.conv2d(feat.to(head_dt), params["head.weight"].to(head_dt),
                         params["head.bias"].to(head_dt), 1, 1)
    cspn_dt = torch.bfloat16 if precision.cspn == "bfloat16" else torch.float32
    heads = heads.to(cspn_dt)
    return cspn(heads[:, 1:], heads[:, 0], sparse.to(cspn_dt),
                spec.num_iters).float()
