"""What BatchNorm costs the eval step: the upper bound of folding it into the
convolutions (the counterpart of the root tools/probe_bn_eval.py).

At eval, BatchNorm is a per-channel affine y = x * a + b of the running
statistics; folding it into the adjacent convolution's weights can at best
remove that pass. This probe times the bench's eval chain (bench.py
`eval_body` by the marginal chain) twice: stock, and with every BatchNorm
module's forward replaced by the identity. The difference is an upper
bound on any folding gain (folding cannot beat removing the op). The
numbers under the patch are wrong; only the time means anything. The
modules' forwards are restored after.

    BENCH_BATCH=32 BENCH_ITERS=10 \
        python -m cspn_monodepth_tpu_torch.tools.probe_bn_eval
        [--config nyu_completion_500]
"""

from __future__ import annotations

import json
import os

import torch

from cspn_monodepth_tpu_torch.bench import eval_body, synthetic_batch
from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.tools import device_line, parser
from cspn_monodepth_tpu_torch.train.loop import Trainer
from cspn_monodepth_tpu_torch.utils.profiling import marginal_chain


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--config", default="nyu_completion_500")
    args = ap.parse_args(argv)
    line = device_line(args.device)
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    n_chain = int(os.environ.get("BENCH_ITERS", "10"))
    cfg = get_config(args.config).override(**{
        "data.dataset": "synthetic", "train.batch_size": batch,
        "train.steps_per_epoch": 1, "mesh.data": 1, "mesh.spatial": 1})
    trainer = Trainer(cfg, device=args.device)
    state = trainer.init_state()
    dev_batch = synthetic_batch(batch, cfg.data.height, cfg.data.width,
                                trainer.device)
    dev_batch["valid_image"] = torch.ones(batch, device=trainer.device)

    def time_infer(label):
        def step(carry, _):
            acc, i = carry
            return eval_body(trainer, state, dev_batch, acc, i), i + 1

        t, _ = marginal_chain(step, (torch.zeros((), device=trainer.device),
                                     0), n=n_chain)
        out = {"variant": label, "eval_step_ms": t * 1e3,
               "images_per_sec": batch / t}
        print(json.dumps(out), flush=True)
        return t

    t_stock = time_infer("stock")
    norms = [m for m in state.model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.forward = lambda x: x
    try:
        t_identity = time_infer("identity_bn")
    finally:
        for m in norms:
            del m.forward
    res = {"bn_eval_cost_ms": (t_stock - t_identity) * 1e3,
           "fold_headroom_pct": 100 * (t_stock - t_identity) / t_stock,
           "eval_step_ms": t_stock * 1e3, "batch": batch,
           "batchnorm_modules": len(norms), "config": args.config,
           "device": line,
           "note": "upper bound on any conv+BN folding win at eval"}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
