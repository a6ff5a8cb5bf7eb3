"""Device time of the train step by kernel and by class, from torch.profiler
(the counterpart of the root tools/xprof_step.py).

The marginal-chain tools time whole components; this traces real train
steps (or, with --eval, eval steps) on synthetic device tensors and sums
the device's kernel times by name and by class (utils/profiling.py
`kernel_class`: convolution, BatchNorm, NCHW<->NHWC layout, CSPN,
optimizer, copies, elementwise), per step, beside the host's wall time.

    python -m cspn_monodepth_tpu_torch.tools.profile_step [--batch 32]
        [--steps 3] [--top 40] [--config nyu_completion_500] [--eval]
"""

from __future__ import annotations

import json

import torch

from cspn_monodepth_tpu_torch.bench import synthetic_batch
from cspn_monodepth_tpu_torch.configs import get_config
from cspn_monodepth_tpu_torch.tools import device_line, parser
from cspn_monodepth_tpu_torch.train.loop import Trainer
from cspn_monodepth_tpu_torch.utils.profiling import device_profile


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--config", default="nyu_completion_500")
    ap.add_argument("--eval", action="store_true",
                    help="profile the eval (inference) step instead")
    args = ap.parse_args(argv)
    line = device_line(args.device)

    cfg = get_config(args.config).override(**{
        "data.dataset": "synthetic", "train.batch_size": args.batch,
        "mesh.data": 1, "mesh.spatial": 1})
    trainer = Trainer(cfg, device=args.device)
    state = trainer.init_state()
    h, w = cfg.data.height, cfg.data.width
    batch = synthetic_batch(args.batch, h, w, trainer.device)
    if args.eval:
        batch["valid_image"] = torch.ones(args.batch, device=trainer.device)

        def run():
            return trainer.eval_step(state, batch, 0)
    else:
        def run():
            return trainer.train_step(state, batch)

    for _ in range(2):              # warm: cuDNN's choices, the allocator
        run()

    def steps():
        for _ in range(args.steps):
            run()

    prof = device_profile(steps, top=args.top, device=args.device)
    per = 1.0 / args.steps
    busy = prof["busy_ms"]
    res = {
        "step": "eval" if args.eval else "train",
        "config": args.config, "batch": args.batch, "h": h, "w": w,
        "steps": args.steps, "device": line,
        "wall_ms_per_step": prof["wall_ms"] * per,
        "busy_ms_per_step": None if busy is None else busy * per,
        "idle_share": prof["idle_share"],
        "by_class_ms_per_step": None if busy is None else {
            k: ms * per for k, ms in sorted(prof["by_class"].items(),
                                            key=lambda kv: -kv[1])},
        "by_class_share": None if busy is None else {
            k: ms / busy for k, ms in prof["by_class"].items()},
        "top_ms_per_step": [[k, ms * per] for k, ms in prof["top"]],
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
