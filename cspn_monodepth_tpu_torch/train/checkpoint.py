"""Checkpoints of a TrainState (PyTorch counterpart of
cspn_monodepth_tpu/train/checkpoint.py, which saves with orbax).

    ckpt = CheckpointManager(workdir)              # max_to_keep=3
    ckpt.save(state.step, state, extra={"epoch": 0}, is_best=True)
    state, extra = ckpt.restore(state)             # the latest step
    ckpt.best_step(), ckpt.latest_step()

One directory per step, named by the step, under the workdir:
`<step>/state.pt` is `torch.save` of {"step", "model" (parameters and BN
buffers), "optimizer" (momentum)} and `<step>/extra.json` the caller's
extras (epoch, epoch_step, best_rmse, config). `best_step.txt` names the
step saved with `is_best`. A save writes a hidden temporary directory and
renames it into place, so a crash in the middle of a save leaves the
previous steps as they were and no torn latest step.

`restore` fills the live state in place (model and optimizer tensors keep
their devices) from `torch.load(weights_only=True)`. A step is saved
once: a second save of it is refused, as orbax refuses it. After a save
only the newest `max_to_keep` steps stay, as orbax keeps them, except
that with `max_to_keep` > 1 the best step takes the place of the oldest
of them when it is older (orbax removes it, and `best_step.txt` then
names a step that cannot be restored). With `max_to_keep` = 1 only the
latest step stays, and `best_step` gives None once its step is gone. On
a mesh (`group`), rank 0 writes, every rank waits at a barrier after each
save, and every rank restores from the shared directory.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch
import torch.distributed as dist

STATE_FILE = "state.pt"
EXTRA_FILE = "extra.json"
BEST_FILE = "best_step.txt"
TMP_PREFIX = ".tmp-"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, group=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.group = group
        self.writer = group is None or dist.get_rank(group) == 0
        if self.writer:
            os.makedirs(self.directory, exist_ok=True)
            # Leftovers of saves that a crash interrupted.
            for name in os.listdir(self.directory):
                if name.startswith(TMP_PREFIX):
                    shutil.rmtree(os.path.join(self.directory, name))
        self._barrier()

    def _barrier(self):
        if self.group is not None:
            dist.barrier(group=self.group)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def steps(self) -> list[int]:
        """The saved steps, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isfile(os.path.join(self.directory, name,
                                                      STATE_FILE)))

    def save(self, step: int, state, extra: dict[str, Any] | None = None,
             is_best: bool = False):
        """Save the state's step, model and optimizer, and `extra` as JSON,
        under `step`, which must not be saved already (every rank
        refuses it together)."""
        saved = os.path.exists(self._path(step))
        self._barrier()
        if saved:
            raise ValueError(f"step {step} is already saved in "
                             f"{self.directory}")
        if self.writer:
            tmp = os.path.join(self.directory, f"{TMP_PREFIX}{step}")
            os.makedirs(tmp)
            torch.save({"step": int(state.step),
                        "model": state.model.state_dict(),
                        "optimizer": state.optimizer.state_dict()},
                       os.path.join(tmp, STATE_FILE))
            with open(os.path.join(tmp, EXTRA_FILE), "w") as f:
                json.dump(extra or {}, f)
            os.replace(tmp, self._path(step))
            if is_best:
                best_tmp = os.path.join(self.directory,
                                        f"{TMP_PREFIX}{BEST_FILE}")
                with open(best_tmp, "w") as f:
                    f.write(str(step))
                os.replace(best_tmp, os.path.join(self.directory, BEST_FILE))
            self._prune()
        self._barrier()

    def _prune(self):
        steps = self.steps()
        best = self.best_step()
        keep = set(steps[-self.max_to_keep:])
        if best is not None and best not in keep and self.max_to_keep > 1:
            keep = set(steps[-(self.max_to_keep - 1):]) | {best}
        for step in steps:
            if step not in keep:
                shutil.rmtree(self._path(step))

    def restore(self, state, step: int | None = None):
        """Fill `state` (a TrainState) in place from `step`, by default the
        latest; returns (state, extra), or (None, None) when there is no
        checkpoint."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        path = self._path(step)
        device = next(state.model.parameters()).device
        saved = torch.load(os.path.join(path, STATE_FILE),
                           map_location=device, weights_only=True)
        state.model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        with open(os.path.join(path, EXTRA_FILE)) as f:
            extra = json.load(f)
        return state, extra

    def best_step(self) -> int | None:
        """The step last saved with is_best, while it is still saved."""
        path = os.path.join(self.directory, BEST_FILE)
        if os.path.exists(path):
            with open(path) as f:
                step = int(f.read().strip())
            if step in self.steps():
                return step
        return None

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self):
        """Saves are synchronous: nothing to wait for (orbax's are not)."""

    def close(self):
        """Nothing is held open between saves."""
