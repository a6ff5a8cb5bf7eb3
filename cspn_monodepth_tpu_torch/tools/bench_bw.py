"""The card's achievable memory copy rate and bf16 matmul rate, by the
marginal chain (the counterpart of the root tools/bench_bw.py). It only
reports: the kernels' bounds keep the datasheet rate
(utils/profiling.py HBM_BYTES_PER_S).

  copy64 / copy128 / copy2d - c -> c * k streams of bf16 feature maps,
    NHWC at 64 and 128 channels (the decoder's widths at full resolution)
    and flat 2-D: each step reads and writes the map once.
  mm4k - a square 4096^3 bf16 matmul.
  mm_stream - a (B*228*304, 576) bf16 map times a (576, 64) carry: a 3x3
    convolution's im2col product at 64 channels, bound by the map's read.

    python -m cspn_monodepth_tpu_torch.tools.bench_bw [--batch 32]
        [--mm 4096]
"""

from __future__ import annotations

import json

import torch

from cspn_monodepth_tpu_torch.tools import device_line, parser
from cspn_monodepth_tpu_torch.tools.profile_components import chain_ms


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--batch", type=int, default=32,
                    help="images of 228x304 in the maps")
    ap.add_argument("--mm", type=int, default=4096,
                    help="the square matmul's size")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    line = device_line(args.device)
    dev, bf = args.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    n = args.iters
    px = args.batch * 228 * 304
    res = {}

    scale = 1.0000001
    for name, shape in [("copy64", (args.batch, 228, 304, 64)),
                        ("copy128", (args.batch, 228, 304, 128)),
                        ("copy2d", (px, 64))]:
        c = torch.rand(shape, generator=gen, device=dev).to(bf)
        ms = chain_ms(lambda c: c * scale, c, n)
        gb = 2 * c.numel() * 2 / 1e9
        res[f"{name}_ms"] = ms
        res[f"{name}_gbps"] = gb / (ms / 1e3)
        del c

    m = args.mm
    a = (torch.rand((m, m), generator=gen, device=dev) * 0.01).to(bf)
    b = (torch.rand((m, m), generator=gen, device=dev) * 0.01).to(bf)
    ms = chain_ms(lambda c: c @ b, a, n)
    res["mm_ms"] = ms
    res["mm_size"] = m
    res["mm_tflops"] = 2 * m ** 3 / (ms / 1e3) / 1e12
    del a, b

    big = torch.rand((px, 576), generator=gen, device=dev).to(bf)
    rhs = (torch.randn((576, 64), generator=gen, device=dev) * 0.05).to(bf)

    def stream(c):
        out = big @ c
        return c * (1.0 + out.float().mean() * 1e-12).to(bf)

    ms = chain_ms(stream, rhs, n)
    res["mm_stream_ms"] = ms
    res["mm_stream_gbps"] = big.numel() * 2 / (ms / 1e3) / 1e9
    res["mm_stream_tflops"] = 2 * px * 576 * 64 / (ms / 1e3) / 1e12
    res.update(batch=args.batch, device=line)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
