"""Does the first train epoch of a process differ from its later ones, and
why? nyu_completion_500 as configured (ResNet-50, batch 8) on packed NYU
shards this script writes, as chip_smoke.py's fit_resume runs it: epochs
of RESUME_STEPS steps, each from the same fresh state, cuDNN
deterministic and cuDNN's benchmark mode off. Each mode runs in a fresh
process:
  cold          three epochs, nothing run on the card before the first;
  warm_forward  one eval forward of a batch first (cuDNN's forward
                convolutions and BatchNorm called once), then three epochs;
  warm_step     one train step of a discarded state first (every
                convolution's forward and backward called once), then three;
  cold_no_cudnn as cold, with cuDNN off (PyTorch's own convolutions and
                BatchNorm);
  warm_data     the first batch's records read and copied to the card
                first (the data path alone, no model run);
  warm_cuda     one eval forward of a zero input first (the card alone, no
                record read);
  nan_memory    as cold, with the caching allocator first holding a
                NaN-filled block of NAN_GB: a kernel that reads memory it
                did not write would read NaN.

    python3 compare_first_epoch.py [ROOT]

ROOT (default: this file's directory) is a checkout whose chip_smoke.py and
package are imported. Prints one line "EPOCHS {json}" per mode: each
epoch's step losses, whether epoch 1 equals epoch 2 bit for bit, and the
largest relative difference of their losses.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

MODES = ("cold", "warm_forward", "warm_step", "cold_no_cudnn", "warm_data",
         "warm_cuda", "nan_memory")
EPOCHS = 3
NAN_GB = 16


def child(root: str, data: str, mode: str) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.enabled = mode != "cold_no_cudnn"
    cfg = cs.fit_config(data, **{"train.steps_per_epoch": cs.RESUME_STEPS})
    with tempfile.TemporaryDirectory(prefix="first_epoch_") as work:
        trainer = cs.Trainer(cfg, device="cuda", workdir=work)
        if mode == "warm_forward":
            batch = cs.fixed_batch(trainer, cfg.train.batch_size)
            batch["valid_image"] = torch.ones(cfg.train.batch_size,
                                              device="cuda")
            trainer.eval_step(trainer.init_state(), batch, 0)
        elif mode == "warm_step":
            batch = cs.fixed_batch(trainer, cfg.train.batch_size)
            trainer.train_step(trainer.init_state(), batch)
        elif mode == "warm_data":
            cs.fixed_batch(trainer, cfg.train.batch_size)
        elif mode == "warm_cuda":
            model = trainer.init_state().model.eval()
            with torch.no_grad():
                model(torch.zeros((cfg.train.batch_size, cfg.data.height,
                                   cfg.data.width, 4), device="cuda"))
            del model
        elif mode == "nan_memory":
            block = torch.full((NAN_GB << 28,), float("nan"), device="cuda")
            del block
        torch.cuda.synchronize()
        losses = []
        for _ in range(EPOCHS):
            _, m = trainer.train_epoch(trainer.init_state(), 0, log=cs.quiet)
            losses.append([float(x) for x in m["step_losses"]])
    first, second = np.array(losses[0]), np.array(losses[1])
    return dict(mode=mode, root=root, losses=losses,
                first_equals_second=bool((first == second).all()),
                first_vs_second_max_rel=float(
                    np.max(np.abs(first - second) / np.abs(second))),
                later_equal=all(losses[i] == losses[1]
                                for i in range(2, EPOCHS)))


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.dirname(__file__))
    sys.path.insert(0, root)
    os.chdir(root)
    if len(sys.argv) > 3:
        print("EPOCHS " + json.dumps(child(root, sys.argv[2], sys.argv[3])),
              flush=True)
        return
    import numpy as np

    import chip_smoke as cs

    with tempfile.TemporaryDirectory(prefix="first_epoch_nyu_") as data:
        cs.write_nyu_shards(Path(data), np.random.default_rng(cs.SEED + 12))
        for mode in MODES:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), root, data, mode],
                capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                raise SystemExit(f"{mode} failed:\n{out.stderr[-4000:]}")
            print(next(ln for ln in out.stdout.splitlines()
                       if ln.startswith("EPOCHS ")), flush=True)


if __name__ == "__main__":
    main()
