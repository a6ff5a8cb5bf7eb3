"""The CSPN kernels against the plain loop on the card, forward and all
three gradients (the counterpart of the root tools/tpu_parity_check.py):
ops/parity.py's sweep of the three norms through the 3 x 3 kernels (K1;
K2 and K3) and the slab kernels on a 96x304 slab (K7; K8 and K9); with
--kitti also the same 3 x 3 kernels at 352x1216 and the slab kernels on a
104x1216 slab. A disagreement raises
(ops/parity.py FWD_TOL, GRAD_TOL); the errors are printed as one JSON
object. Judge them relative to the output's magnitude: random signed
gates are expansive (ops/parity.py).

    python -m cspn_monodepth_tpu_torch.tools.parity_check [--kitti]
        [--batch 4] [--hw 228x304]
"""

from __future__ import annotations

import json

from cspn_monodepth_tpu_torch.ops.parity import (
    cspn_parity_check,
    prenorm_parity_check,
)
from cspn_monodepth_tpu_torch.tools import device_line, parser


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--kitti", action="store_true",
                    help="add the kernels at KITTI's 352x1216")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--hw", default="228x304",
                    help="the first case's size (and, with --kitti and "
                         "a size given, the KITTI case's)")
    args = ap.parse_args(argv)
    line = device_line(args.device)
    dev = args.device
    h, w = (int(v) for v in args.hw.split("x"))
    results = cspn_parity_check(batch=args.batch, h=h, w=w, device=dev)
    results["prenorm_96x304"] = prenorm_parity_check(batch=2, h=96, w=304,
                                                     device=dev)
    if args.kitti:
        kh, kw = (352, 1216) if args.hw == "228x304" else (h, w)
        results[f"tiled_{kh}x{kw}"] = cspn_parity_check(
            norms=("8sum_clamp",), batch=2, h=kh, w=kw,
            device=dev)["8sum_clamp"]
        results["prenorm_104x1216"] = prenorm_parity_check(
            batch=2, h=104, w=1216, device=dev)
    results["device"] = line
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
