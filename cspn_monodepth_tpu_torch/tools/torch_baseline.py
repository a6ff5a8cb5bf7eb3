"""PyTorch baseline on the card: the reference architecture with its
per-iteration CSPN loop (the port's copy of the root tools/torch_baseline.py,
which measured it on a CPU).

The model is the root tool's, written from the functional spec: ResNet-50
UNet encoder-decoder with UpProj blocks, blur-depth and 8-channel guidance
heads, and the CSPN as the reference structures it, a torch elementwise op
per neighbour and iteration, in float32 (PyTorch's defaults, no autocast).
It times `BENCH_ITERS` train steps (masked MSE, SGD-momentum with weight
decay) and eval forwards at `BENCH_BATCH` on 228x304 (--hw), each step
closed by a synchronize, and prints combined = 1 / (1/train + 1/infer)
img/s with the card's name, power limit and the torch version. On the card
it writes them to cspn_monodepth_tpu_torch/bench_baseline.json, which the
port's bench reads for `vs_baseline` where the card's name and the batch
match; it never writes the root BENCH_BASELINE.json.

    BENCH_BATCH=32 BENCH_ITERS=3 \
        python -m cspn_monodepth_tpu_torch.tools.torch_baseline [--hw 228x304]
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import torch
import torch.nn as nn
import torch.nn.functional as F

from cspn_monodepth_tpu_torch.tools import device_line, parser

OUT = Path(__file__).resolve().parent.parent / "bench_baseline.json"


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride=1):
        super().__init__()
        cout = width * 4
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.down = None
        if stride != 1 or cin != cout:
            self.down = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        r = x if self.down is None else self.down(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + r)


class UpProj(nn.Module):
    """FCRN up-projection. `crop_after=False` (default) crops the
    upsampled map to out_hw BEFORE the 5x5 convs; `crop_after=True` convs
    the full 2Hx2W map and crops the conv OUTPUTS — the ordering the flax
    decoder's sub-pixel decomposition implies (models/unet.py docstring:
    both are valid SAME-conv semantics; they differ only in the last
    row/col at odd sizes). The second mode zero-extends the skip to the
    upsampled size, which is exactly SAME zero padding of an out_hw-sized
    skip once the output is cropped."""

    def __init__(self, cin, cout, crop_after=False):
        super().__init__()
        self.crop_after = crop_after
        self.c1a = nn.Conv2d(cin, cout, 5, padding=2, bias=False)
        self.b1a = nn.BatchNorm2d(cout)
        self.c1b = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.b1b = nn.BatchNorm2d(cout)
        self.c2 = nn.Conv2d(cin, cout, 5, padding=2, bias=False)
        self.b2 = nn.BatchNorm2d(cout)

    def forward(self, x, out_hw, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if self.crop_after:
            if skip is not None:
                skip = F.pad(skip, (0, x.shape[3] - skip.shape[3],
                                    0, x.shape[2] - skip.shape[2]))
                x = torch.cat([x, skip], dim=1)
            a = self.c1a(x)[:, :, :out_hw[0], :out_hw[1]]
            b = self.c2(x)[:, :, :out_hw[0], :out_hw[1]]
        else:
            x = x[:, :, :out_hw[0], :out_hw[1]]
            if skip is not None:
                x = torch.cat([x, skip], dim=1)
            a, b = self.c1a(x), self.c2(x)
        a = self.b1b(self.c1b(F.relu(self.b1a(a))))
        b = self.b2(b)
        return F.relu(a + b)


class AffinityPropagate(nn.Module):
    """Reference-style CSPN loop: per-iteration elementwise ops."""

    def __init__(self, prop_time=24):
        super().__init__()
        self.prop_time = prop_time
        self.offsets = [(-1, -1), (-1, 0), (-1, 1), (0, -1),
                        (0, 1), (1, -1), (1, 0), (1, 1)]

    def forward(self, guidance, blur, sparse=None):
        # guidance (B,8,H,W), blur/sparse (B,1,H,W)
        g = guidance
        s = g.abs().sum(dim=1, keepdim=True).clamp_min(1e-8)
        gate = g / s
        g0 = 1.0 - gate.sum(dim=1, keepdim=True)
        d = blur
        if sparse is not None:
            m = (sparse > 0).float()
            d = (1 - m) * d + m * sparse
        b, _, h, w = d.shape
        for _ in range(self.prop_time):
            pad = F.pad(d, (1, 1, 1, 1))
            new = g0 * d
            for k, (dy, dx) in enumerate(self.offsets):
                new = new + gate[:, k:k + 1] * pad[:, :, 1 + dy:1 + dy + h,
                                                   1 + dx:1 + dx + w]
            if sparse is not None:
                new = (1 - m) * new + m * sparse
            d = new
        return d


class TorchCSPNNet(nn.Module):
    def __init__(self, in_ch=4, prop_time=24, crop_after=False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        widths, blocks, strides = [64, 128, 256, 512], [3, 4, 6, 3], [1, 2, 2, 2]
        cin = 64
        self.layers = nn.ModuleList()
        for wd, nb, st in zip(widths, blocks, strides):
            stage = []
            for i in range(nb):
                stage.append(Bottleneck(cin, wd, st if i == 0 else 1))
                cin = wd * 4
            self.layers.append(nn.Sequential(*stage))
        self.bottleneck = nn.Sequential(
            nn.Conv2d(2048, 1024, 3, padding=1, bias=False),
            nn.BatchNorm2d(1024), nn.ReLU(inplace=True))
        self.up1 = UpProj(1024 + 1024, 512, crop_after)
        self.up2 = UpProj(512 + 512, 256, crop_after)
        self.up3 = UpProj(256 + 256, 128, crop_after)
        self.up4 = UpProj(128 + 64, 64, crop_after)
        self.up5 = UpProj(64, 64, crop_after)
        self.depth_head = nn.Conv2d(64, 1, 3, padding=1)
        self.guide_head = nn.Conv2d(64, 8, 3, padding=1)
        self.cspn = AffinityPropagate(prop_time)

    def forward(self, x):
        sparse = x[:, 3:4] if x.shape[1] == 4 else None
        hw = x.shape[2:]
        stem = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(stem, 3, 2, 1)
        skips = []
        for stage in self.layers:
            y = stage(y)
            skips.append(y)
        c1, c2, c3, c4 = skips
        y = self.bottleneck(c4)
        y = self.up1(y, c3.shape[2:], c3)
        y = self.up2(y, c2.shape[2:], c2)
        y = self.up3(y, c1.shape[2:], c1)
        y = self.up4(y, stem.shape[2:], stem)
        y = self.up5(y, hw)
        blur = self.depth_head(y)
        guide = self.guide_head(y)
        return self.cspn(guide, blur, sparse)


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--hw", default="228x304")
    args = ap.parse_args(argv)
    line = device_line(args.device)
    dev = args.device
    torch.manual_seed(0)
    batch = int(os.environ.get("BENCH_BATCH", "8"))
    iters = int(os.environ.get("BENCH_ITERS", "3"))
    h, w = (int(v) for v in args.hw.split("x"))
    model = TorchCSPNNet(4, 24).to(dev)
    x = torch.rand(batch, 4, h, w).to(dev)
    target = (torch.rand(batch, 1, h, w) * 10).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9,
                          weight_decay=1e-4)

    def train_step():
        opt.zero_grad(set_to_none=True)
        pred = model(x)
        mask = (target > 0).float()
        loss = ((pred - target) ** 2 * mask).sum() / mask.sum().clamp_min(1)
        loss.backward()
        opt.step()
        return loss

    def infer_step():
        with torch.no_grad():
            return model(x)

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    def seconds(step):
        step()                                  # warm
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        sync()
        return (time.perf_counter() - t0) / iters

    t_train = seconds(train_step)
    model.eval()
    t_infer = seconds(infer_step)
    model.train()

    train_ips = batch / t_train
    infer_ips = batch / t_infer
    out = {
        "combined_ips": 1 / (1 / train_ips + 1 / infer_ips),
        "train_images_per_sec": train_ips,
        "infer_images_per_sec": infer_ips,
        "batch": batch,
        "hw": f"{h}x{w}",
        "iters": iters,
        "device": line,
        "torch": torch.__version__,
        "note": ("the reference architecture with its per-iteration CSPN "
                 "loop in plain PyTorch, float32, on this device"),
    }
    if dev != "cpu":
        OUT.write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
