"""Command line of the port (the counterpart of the JAX package's main.py).

    python -m cspn_monodepth_tpu_torch.main --config nyu_completion_500 \
        --set data.root=/data/nyu_packed --workdir /tmp/run1
    python -m cspn_monodepth_tpu_torch.main --config nyu_completion_500 \
        --workdir /tmp/run1 --evaluate
    python -m cspn_monodepth_tpu_torch.main --config synthetic_tiny \
        --device cpu --set train.epochs=2
    python -m cspn_monodepth_tpu_torch.main --list-configs
    torchrun --nproc-per-node 8 -m cspn_monodepth_tpu_torch.main \
        --config kitti_1216 --multihost

Training resumes from the latest checkpoint in the workdir when there is
one. `--evaluate` evaluates the best checkpoint, else the latest, else a
fresh model. The model runs on `--device` (default cuda); `--multihost`
joins the process group that torchrun describes and runs each rank on its
own card (with `--device cpu`, on the CPU over gloo).
"""

from __future__ import annotations

import argparse
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="nyu_completion_500",
                   help="named config (see --list-configs)")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="dotted config override, e.g. train.lr=0.005")
    p.add_argument("--workdir", default=None,
                   help="checkpoint and log directory (default: the "
                        "config's train.checkpoint_dir)")
    p.add_argument("--evaluate", action="store_true",
                   help="evaluate the best (else latest) checkpoint and exit")
    p.add_argument("--resume", action="store_true", default=True,
                   help="resume from the latest checkpoint if present "
                        "(always on)")
    p.add_argument("--list-configs", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's process group before anything")
    p.add_argument("--device", default="cuda",
                   help="device to run on (cuda or cpu)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from cspn_monodepth_tpu_torch.configs import CONFIGS, get_config

    if args.list_configs:
        for name, cfg in CONFIGS.items():
            print(f"{name}: dataset={cfg.data.dataset} "
                  f"{cfg.data.height}x{cfg.data.width} "
                  f"iters={cfg.model.num_iters} batch={cfg.train.batch_size} "
                  f"mesh={cfg.mesh.data}x{cfg.mesh.spatial}")
        return 0

    cfg = get_config(args.config)
    overrides = dict(kv.split("=", 1) for kv in args.set)
    if overrides:
        cfg = cfg.override(**overrides)

    from cspn_monodepth_tpu_torch.parallel import init_distributed, make_mesh
    from cspn_monodepth_tpu_torch.train.checkpoint import CheckpointManager
    from cspn_monodepth_tpu_torch.train.loop import Trainer

    device, mesh = torch.device(args.device), None
    if args.multihost:
        device = init_distributed(device.type)
        # Every rank on the config's mesh: refuses a world of another size.
        mesh = make_mesh(cfg.mesh, device)
    trainer = Trainer(cfg, device=device, mesh=mesh, workdir=args.workdir)

    if args.evaluate:
        state = trainer.init_state()
        ckpt = CheckpointManager(trainer.workdir, group=trainer.group)
        step = ckpt.best_step() or ckpt.latest_step()
        restored, _ = ckpt.restore(state, step=step)
        if restored is not None:
            state = restored
            print(f"evaluating checkpoint step {step}")
        else:
            print("no checkpoint found; evaluating fresh init")
        trainer.evaluate(state)
        return 0

    trainer.fit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
