"""Train state, optimizer and learning-rate schedule (PyTorch counterpart of
cspn_monodepth_tpu/train/train_state.py).

The JAX package chains optax transforms: clip_by_global_norm, then
add_decayed_weights (on every parameter, no mask), then sgd(momentum) or
adam, and scales the encoder's updates by `encoder_lr_mult`. Here:
* the clip is written out in optax's form, g if |g| < c else (g / |g|) c,
  with |g| the global norm over every gradient (`clip_grad_norm_` divides
  by |g| + 1e-6 instead);
* `torch.optim.SGD(momentum, weight_decay)` adds the decay to the clipped
  gradient before the momentum, as the optax chain does, and its first
  step's momentum buffer is the gradient itself, as optax's trace starts
  from zero; `adam` is `torch.optim.Adam(weight_decay)`, L2 folded into
  Adam as the chain does (not AdamW);
* `encoder_lr_mult` is a parameter group over `encoder.*` whose learning
  rate is multiplied (scaling the final update is the same for both
  optimizers);
* the learning rate is a step decay keyed to the global step, set on every
  group before each update, so a run resumes from its step alone;
* on a mesh each rank's gradients are summed over the world group before
  the clip (the loss is already a share of the global mean), flattened
  into buckets of at most BUCKET_BYTES, so that every rank applies the same
  update.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn as nn

from cspn_monodepth_tpu_torch.configs import TrainConfig

BUCKET_BYTES = 64 * 1024 * 1024


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int):
    """Step decay: lr * rate^(epoch // decay_every), epoch = step // spe."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return cfg.lr * (cfg.lr_decay_rate ** (epoch // cfg.lr_decay_every))

    return schedule


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """Clip gradients in place in optax's form; returns the global norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


@torch.no_grad()
def all_reduce_grads(params, group) -> None:
    """Sum every parameter's gradient over the process group, in place, a
    bucket of flattened gradients per collective."""
    grads = [p.grad for p in params if p.grad is not None]
    while grads:
        bucket, size = [], 0
        while grads and (not bucket or size + grads[0].nbytes <= BUCKET_BYTES):
            size += grads[0].nbytes
            bucket.append(grads.pop(0))
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))


def make_optimizer(cfg: TrainConfig, model: nn.Module):
    """The optimizer over every parameter, with the encoder in a group of
    its own when `encoder_lr_mult` != 1 (each group's `lr_mult`)."""
    mult = cfg.encoder_lr_mult
    named = list(model.named_parameters())
    if mult != 1.0:
        groups = [
            {"params": [p for n, p in named if n.startswith("encoder.")],
             "lr_mult": mult},
            {"params": [p for n, p in named if not n.startswith("encoder.")],
             "lr_mult": 1.0}]
    else:
        groups = [{"params": [p for _, p in named], "lr_mult": 1.0}]
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(groups, lr=cfg.lr, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(groups, lr=cfg.lr,
                                weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


@dataclasses.dataclass
class TrainState:
    """The global step, the model (parameters and BN statistics) and the
    optimizer. `apply_gradients` updates all three in place."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

    def apply_gradients(self, schedule, clip_norm: float = 0.0, group=None):
        """One update from the model's .grad: the sum over `group` (a
        mesh's world group) when given, clip, then the optimizer at the
        schedule's learning rate for this step."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        if group is not None:
            all_reduce_grads(params, group)
        if clip_norm > 0:
            clip_by_global_norm(params, clip_norm)
        lr = schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.optimizer.step()
        self.step += 1
