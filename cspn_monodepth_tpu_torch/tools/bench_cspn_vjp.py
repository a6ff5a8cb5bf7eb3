"""The CSPN's forward + backward kernels against autograd through the plain
loop (the counterpart of the root tools/bench_cspn_vjp.py).

Each step takes the gradients of <cspn(guidance, blur, sparse), cot> with
respect to ALL THREE inputs and feeds every one of them back into the
chain's carry, so neither side can leave part of its adjoint out: the
kernels (CSPNFunction: the stash forward K2 and the adjoint K3, at NYU's
batch 32 x 228x304, or with --kitti at KITTI's batch 8 x 352x1216) against
`impl="torch"`, the plain loop of ops/cspn_ref.py under torch autograd.
Each is timed by the marginal chain (profile_components.py `chain_ms`).
On CPU tensors the kernels' wrappers run their plain versions.

    python -m cspn_monodepth_tpu_torch.tools.bench_cspn_vjp [--kitti]
        [--batch B] [--hw HxW] [--num-iters 24]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from cspn_monodepth_tpu_torch.ops import cspn_propagate
from cspn_monodepth_tpu_torch.tools import device_line, parser
from cspn_monodepth_tpu_torch.tools.profile_components import chain_ms


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--kitti", action="store_true",
                    help="at KITTI's batch 8 x 352x1216")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--hw", default=None)
    ap.add_argument("--num-iters", type=int, default=24)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    line = device_line(args.device)
    b, h, w = (8, 352, 1216) if args.kitti else (32, 228, 304)
    b = args.batch or b
    if args.hw:
        h, w = (int(v) for v in args.hw.split("x"))

    rng = np.random.default_rng(0)
    guid = rng.normal(size=(b, h, w, 8)).astype(np.float32)
    blur = rng.uniform(0.5, 9.5, (b, h, w)).astype(np.float32)
    sp = (blur * (rng.random((b, h, w)) < 0.01)).astype(np.float32)
    cot = torch.from_numpy(
        rng.normal(size=(b, h, w)).astype(np.float32)).to(args.device)
    carry = tuple(torch.from_numpy(a).to(args.device)
                  for a in (guid, blur, sp))

    def step(impl):
        def fn(c):
            leaves = tuple(t.detach().requires_grad_() for t in c)
            out = cspn_propagate(*leaves, num_iters=args.num_iters,
                                 norm_type="8sum_clamp", impl=impl)
            grads = torch.autograd.grad((out * cot).sum(), leaves)
            # Consume every gradient: none of the adjoint is dropped.
            return tuple(t.detach() + g * 1e-12 for t, g in zip(c, grads))
        return fn

    res = {"kernels_fwd_plus_full_bwd_ms": chain_ms(step("auto"), carry,
                                                    args.iters),
           "plain_fwd_plus_full_bwd_ms": chain_ms(step("torch"), carry,
                                                  args.iters),
           "shape": f"{b}x{h}x{w}", "iters": args.num_iters,
           "device": line}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
