"""Time of each decoder block, forward and forward + backward, beside its
analytic bf16 FLOP time at the card's datasheet rate (the counterpart of
the root tools/profile_decoder.py).

The blocks are the model's own (`--config`'s decoder at full width), fed
seeded inputs at the shapes the encoder gives for --hw; each is timed by
the marginal chain (profile_components.py `chain_ms`) with its input and
skip in the carry. FLOPs count the port's plain math: the two 5x5 convs of
the unpooled map concatenated with the skip (the whole 2H x 2W map, cropped
after) and the 3x3 conv at the output size. `util` is the ideal time over
the measured one.

    python -m cspn_monodepth_tpu_torch.tools.profile_decoder [--batch 32]
        [--iters 10] [--hw 228x304] [--train] [--config nyu_completion_500]
"""

from __future__ import annotations

import json

import torch

from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.models import CSPNDepthNet
from cspn_monodepth_tpu_torch.tools import device_line, parser
from cspn_monodepth_tpu_torch.tools.profile_components import chain_ms, nudge

# Dense bf16 tensor-core peak of one H100 SXM at its full 700 W limit,
# from NVIDIA's H100 Tensor Core GPU datasheet (without sparsity).
PEAK_BF16_TFLOPS = 989.0


def block_flops(block, in_hw, out_hw) -> float:
    """Forward FLOPs per image of an UpProj or UpConv block, plain math."""
    ih, iw = in_hw
    oh, ow = out_hw
    convs = [m for m in block.modules() if isinstance(m, torch.nn.Conv2d)]
    flops = 0.0
    for c in convs:
        k = c.kernel_size[0] * c.kernel_size[1]
        hw = (2 * ih) * (2 * iw) if c.kernel_size[0] == 5 else oh * ow
        flops += 2.0 * hw * k * c.in_channels * c.out_channels
    return flops


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--hw", default="228x304")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--config", default="nyu_completion_500")
    args = ap.parse_args(argv)
    line = device_line(args.device)
    dev, b = args.device, args.batch
    h, w = (int(v) for v in args.hw.split("x"))
    model = CSPNDepthNet.from_config(get_config(args.config).model).to(dev)
    bf16 = model.dtype == torch.bfloat16

    def autocast():
        return torch.autocast(torch.device(dev).type, dtype=torch.bfloat16,
                              enabled=bf16)

    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad(), autocast():
        x = torch.rand((b, model.encoder.conv1.in_channels, h, w),
                       generator=gen, device=dev)
        stem, c1, c2, c3, c4 = model.encoder(x)
    dec = model.decoder
    # Each block's input channels and size, its skip, its output size.
    in_shapes = [(dec.bottleneck.out_channels, c4.shape[-2:])]
    plan = []
    for i, skip in enumerate((c3, c2, c1, stem, None)):
        blk = getattr(dec, f"upproj{i + 1}")
        cin, in_hw = in_shapes[-1]
        out_hw = (h, w) if skip is None else tuple(skip.shape[-2:])
        plan.append((f"up{i + 1}", blk, cin, tuple(in_hw), skip, out_hw))
        out_ch = [m for m in blk.modules()
                  if isinstance(m, torch.nn.Conv2d)][-1].out_channels
        in_shapes.append((out_ch, out_hw))

    res = {}
    for name, blk, cin, in_hw, skip, out_hw in plan:
        xin = torch.rand((b, cin, *in_hw), generator=gen, device=dev)
        sk = (None if skip is None else
              torch.rand(skip.shape, generator=gen, device=dev))

        def fwd(carry, blk=blk, out_hw=out_hw):
            xx, s = carry
            with autocast():
                bump = blk(xx, out_hw, s).float().mean() * 1e-9
            return xx + bump, None if s is None else s + bump

        blk.eval()
        with torch.no_grad():
            ms = chain_ms(fwd, (xin, sk), args.iters)
        gflop = block_flops(blk, in_hw, out_hw) * b / 1e9
        ideal_ms = gflop / PEAK_BF16_TFLOPS
        res[name] = {"cin": cin, "skip_ch": 0 if skip is None else
                     skip.shape[1], "in_hw": list(in_hw),
                     "out_hw": list(out_hw), "fwd_ms": ms, "gflops": gflop,
                     "ideal_ms": ideal_ms, "util": ideal_ms / ms}
        if args.train:
            blk.train()
            params = list(blk.parameters())

            def step(carry, blk=blk, out_hw=out_hw, params=params):
                xx, s = carry
                with autocast():
                    loss = blk(xx, out_hw, s).float().pow(2).mean()
                tick = nudge(params, loss)
                # The loss feeds the skip: the next step depends on it.
                return xx + tick, None if s is None else s + tick

            res[name]["fwdbwd_ms"] = chain_ms(step, (xin, sk), args.iters)
    res.update(batch=b, hw=f"{h}x{w}", config=args.config,
               peak_bf16_tflops=PEAK_BF16_TFLOPS, device=line)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
