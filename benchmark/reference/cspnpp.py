"""The plain reference of CSPN++'s context-aware CSPN (CA-CSPN) on a ResNet
UNet, written from the published description in plain PyTorch.

Cheng, Wang, Guan, Yang, "CSPN++: Learning Context and Resource Aware
Convolutional Spatial Propagation Networks for Depth Completion", AAAI 2020
(arXiv:1911.05377): the propagation runs with several kernel sizes side by
side (3x3, 5x5, 7x7: 8, 24 and 48 neighbours, each size with its own
affinities), each size's iterate is kept at several iterations, and the
output is assembled per pixel with predicted weights:

    g_k   = g^_k / max(sum_n |g^_k,n|, 1),   g_k0 = 1 - sum_n g_k,n
    m     = [s > 0],  d_k^0 = (1 - m) b + m s
    d_k^{t+1} = (1 - m) (g_k0 d_k^t + sum_n g_k,n d_k^t(. + off_n)) + m s
    s_k   = sigmoid(s^_k) / sum_k' sigmoid(s^_k')
    l_kj  = sigmoid(l^_kj) / sum_j' sigmoid(l^_kj')
    D     = sum_k s_k sum_j l_kj d_k^{t_j}

with d zero outside the image and off_n the k x k offsets row-major with
the centre left out. The network is the benchmark's ResNet UNet
(reference/model.py) with basic blocks (ResNet-34: 3x3/s -> BN/ReLU ->
3x3 -> BN, a 1x1/s projection where the shape changes), the UpProj
decoder, and one 3x3 head of 1 + sum_k (k^2 - 1) + n_k + n_k n_c channels,
[b, g^_3, g^_5, g^_7, s^ (n_k), l^ (n_k x n_c, kernel-major)]: 96 for
sizes (3, 5, 7) and checkpoints (6, 12, 18, 24). Tensors are named as the
program names them; the weights come from benchmark/weights.py.

Each kernel size runs one uninterrupted propagation of T iterations, a
shifted-add loop, keeping the iterates at the checkpoints. `Precision` is
reference/model.py's switch: the network under bf16 autocast, in fp8, or
(here also) in "float32"; the head in "float32" or "bfloat16"; the
propagation and the mix in the CSPN's. TF32 is off for the whole forward
(`no_tf32`): a float32 part is float32.

It imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.model import (
    STATED,
    Precision,
    _bn,
    _conv_shape,
    _fp32_convs,
    _Net,
)
from benchmark.reference.steps import (
    _is_param,
    leaf_norms,
    masked_mse,
    sparse_draw,
)


@dataclasses.dataclass(frozen=True)
class Spec:
    """The sizes of a CSPN++ configuration (benchmark/configs/<name>.json)."""

    in_channels: int = 4
    stages: tuple = (3, 4, 6, 3)
    block: str = "basic"
    width: int = 64
    decoder_channels: tuple = (512, 256, 128, 64)
    decoder_out: int = 64
    num_iters: int = 24
    kernel_sizes: tuple = (3, 5, 7)
    checkpoints: tuple = (6, 12, 18, 24)

    @classmethod
    def from_config(cls, conf: dict) -> "Spec":
        m = conf["model"]
        return cls(in_channels=m["in_channels"], stages=tuple(m["stages"]),
                   block=m["encoder_block"], width=m["width"],
                   decoder_channels=tuple(m["decoder_channels"]),
                   decoder_out=m["decoder_out"], num_iters=m["num_iters"],
                   kernel_sizes=tuple(m["kernel_sizes"]),
                   checkpoints=tuple(m["checkpoints"]))

    @property
    def head_channels(self) -> int:
        n = len(self.kernel_sizes)
        return (1 + sum(k * k - 1 for k in self.kernel_sizes) + n
                + n * len(self.checkpoints))


def offsets(k: int) -> list[tuple[int, int]]:
    """(dy, dx) of the k x k neighbours, row-major, the centre left out."""
    r = k // 2
    return [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)
            if dy or dx]


# ------------------------------------------------------------- shapes

def shapes(spec: Spec) -> dict[str, tuple]:
    """Every float tensor of the network by name, in a fixed order."""
    if spec.block != "basic":
        raise ValueError(f"CSPN++'s reference runs basic blocks, not "
                         f"{spec.block!r}")
    s: dict[str, tuple] = {}
    w = spec.width
    s["encoder.conv1.weight"] = _conv_shape(w, spec.in_channels, 7)
    _bn(s, "encoder.bn1", w)
    cin = w
    skips = [w]
    for stage, blocks in enumerate(spec.stages):
        out = w * 2 ** stage
        for i in range(blocks):
            p = f"encoder.layer{stage + 1}_block{i}"
            stride = 2 if stage > 0 and i == 0 else 1
            s[f"{p}.conv1.weight"] = _conv_shape(out, cin, 3)
            _bn(s, f"{p}.bn1", out)
            s[f"{p}.conv2.weight"] = _conv_shape(out, out, 3)
            _bn(s, f"{p}.bn2", out)
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
    s["head.weight"] = _conv_shape(spec.head_channels, spec.decoder_out, 3)
    s["head.bias"] = (spec.head_channels,)
    return s


# ------------------------------------------------------------- network

class _BasicNet(_Net):
    """reference/model.py's network with basic residual blocks."""

    def basic(self, prefix: str, x, stride: int):
        y = F.relu(self.bn(f"{prefix}.bn1",
                           self.conv(f"{prefix}.conv1", x, stride)))
        y = self.bn(f"{prefix}.bn2", self.conv(f"{prefix}.conv2", y))
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
                x = self.basic(f"encoder.layer{stage + 1}_block{i}", x,
                               2 if stage > 0 and i == 0 else 1)
            skips.append(x)
        return skips


def propagate(guidance, blur, sparse, k: int, num_iters: int,
              checkpoints: tuple) -> list[torch.Tensor]:
    """T iterations of the k x k CSPN on guidance (B, k^2 - 1, H, W)
    normalized by max(sum_n |g_n|, 1), d^0 = blur anchored and each
    iterate anchored; the iterates at `checkpoints`."""
    gates = guidance / guidance.abs().sum(1, keepdim=True).clamp_min(1.0)
    g0 = 1.0 - gates.sum(1)
    m = (sparse > 0).to(blur.dtype)
    d = (1.0 - m) * blur + m * sparse
    h, w = d.shape[-2:]
    r = k // 2
    kept = []
    for t in range(1, num_iters + 1):
        pad = F.pad(d, (r, r, r, r))
        new = g0 * d
        for n, (dy, dx) in enumerate(offsets(k)):
            new = new + gates[:, n] * pad[:, r + dy:r + dy + h,
                                          r + dx:r + dx + w]
        d = (1.0 - m) * new + m * sparse
        if t in checkpoints:
            kept.append(d)
    return kept


def mix(heads, branches: list, spec: Spec):
    """D = sum_k s_k sum_j l_kj d_k^{t_j} from the head's weight channels
    and each size's kept iterates."""
    n_k, n_c = len(spec.kernel_sizes), len(spec.checkpoints)
    first = 1 + sum(k * k - 1 for k in spec.kernel_sizes)
    size_w = torch.sigmoid(heads[:, first:first + n_k])
    size_total = size_w.sum(1)
    out = torch.zeros_like(heads[:, 0])
    for i, kept in enumerate(branches):
        lo = first + n_k + i * n_c
        mark_w = torch.sigmoid(heads[:, lo:lo + n_c])
        branch = sum(mark_w[:, j] * kept[j] for j in range(n_c))
        out = out + size_w[:, i] / size_total * branch / mark_w.sum(1)
    return out


@contextlib.contextmanager
def no_tf32():
    """cuBLAS and cuDNN in full float32 (cuDNN's default is TF32)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with _fp32_convs():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]


def forward(params: dict, x: torch.Tensor, spec: Spec, train: bool,
            precision: Precision = STATED) -> torch.Tensor:
    """x (B, H, W, C) float32, the sparse depth in its last channel ->
    refined depth (B, H, W) float32."""
    with no_tf32():
        return _forward(params, x, spec, train, precision)


def _forward(params, x, spec, train, precision):
    net = _BasicNet(params, train, precision)
    h, w = x.shape[1:3]
    x = x.permute(0, 3, 1, 2).float().contiguous()
    sparse = x[:, -1]
    dev = x.device.type
    # The meta device (count.py) has no autocast; the FLOPs are the same.
    with (contextlib.nullcontext() if dev == "meta" else
          torch.autocast(dev, dtype=torch.bfloat16,
                         enabled=precision.network != "float32")):
        feat = net.decoder(net.encoder(x, spec), (h, w))
    head_dt = torch.bfloat16 if precision.head == "bfloat16" else torch.float32
    heads = F.conv2d(feat.to(head_dt), params["head.weight"].to(head_dt),
                     params["head.bias"].to(head_dt), 1, 1)
    cspn_dt = torch.bfloat16 if precision.cspn == "bfloat16" else torch.float32
    heads, sparse = heads.to(cspn_dt), sparse.to(cspn_dt)
    branches, first = [], 1
    for k in spec.kernel_sizes:
        guidance = heads[:, first:first + k * k - 1]
        first += k * k - 1
        branches.append(propagate(guidance, heads[:, 0], sparse, k,
                                  spec.num_iters, spec.checkpoints))
    return mix(heads, branches, spec).float()


# ------------------------------------------------------------- steps

def train_steps(weights: dict, batches: list, conf: dict, seed: int,
                precision, tag: int = 0) -> dict:
    """reference/steps.py's train steps on this network: the sparse draw,
    masked MSE, clip by the global norm, weight decay and SGD with
    momentum; the losses, the per-leaf norms of the first step's clipped
    gradient and of each parameter's change over all steps."""
    spec = Spec.from_config(conf)
    t, d = conf["train"], conf["data"]
    params = {k: v.detach().clone().requires_grad_(_is_param(k))
              for k, v in weights.items()}
    leaves = [k for k in params if _is_param(k)]
    start = {k: params[k].detach().clone() for k in leaves}
    momentum: dict = {}
    losses, first_grad = [], None
    for step, (rgb, depth) in enumerate(batches):
        sparse = sparse_draw(depth, d["num_samples"], d["max_depth"], seed,
                             tag, step)
        x = torch.cat([rgb, sparse[..., None]], dim=-1)
        pred = forward(params, x, spec, train=True, precision=precision)
        loss = masked_mse(pred, depth)
        grads = torch.autograd.grad(loss, [params[k] for k in leaves])
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            if norm >= t["clip_norm"]:
                grads = [g / norm * t["clip_norm"] for g in grads]
            if step == 0:
                first_grad = leaf_norms(dict(zip(leaves, grads)))
            for k, g in zip(leaves, grads):
                g = g + t["weight_decay"] * params[k]
                buf = momentum.get(k)
                momentum[k] = g if buf is None else t["momentum"] * buf + g
                params[k] -= t["lr"] * momentum[k]
        losses.append(float(loss.detach()))
    change = leaf_norms({k: params[k].detach() - start[k] for k in leaves})
    return {"losses": losses, "first_grad": first_grad, "change": change}


# ------------------------------------------------------------- counts

def counts(conf: dict) -> dict:
    """The work of one image: `flops_per_image` as benchmark/count.py
    counts it (FlopCounterMode on the meta device: the convolutions, the
    head's included; the propagation's elementwise iterations count
    none), and `cspn_kxk_bytes_per_image`, the 5x5 and 7x7 stencils'
    contract in float32, each operand once a step: forward the guidance's
    k^2 - 1 planes, blur and sparse read and the four kept iterates
    written (k^2 + 5 planes); backward the four iterates' cotangents, the
    guidance, blur and sparse read and d_guidance and d_blur written
    (2 k^2 + 5). `cspn_bytes_per_image` is the same contract over every
    kernel size, the 3x3 branch's included: the whole op that the
    program's spans cspn.forward and cspn.backward hold."""
    spec = Spec.from_config(conf)
    h, w = conf["data"]["height"], conf["data"]["width"]
    meta = torch.device("meta")
    params = {k: torch.empty(s, device=meta).requires_grad_(_is_param(k))
              for k, s in shapes(spec).items()}
    x = torch.empty((1, h, w, spec.in_channels), device=meta)
    with FlopCounterMode(display=False) as fwd:
        with torch.no_grad():
            forward(params, x, spec, train=True)
    with FlopCounterMode(display=False) as train:
        forward(params, x, spec, train=True).sum().backward()
    def contract(sizes):
        return {"forward": 4 * h * w * sum(k * k + 5 for k in sizes),
                "backward": 4 * h * w * sum(2 * k * k + 5 for k in sizes)}

    return {"flops_per_image": {"forward": fwd.get_total_flops(),
                                "train": train.get_total_flops()},
            "cspn_kxk_bytes_per_image": contract(
                [k for k in spec.kernel_sizes if k > 3]),
            "cspn_bytes_per_image": contract(spec.kernel_sizes)}
