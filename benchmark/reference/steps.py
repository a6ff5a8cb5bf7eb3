"""The plain reference of a train step and of serving, on the reference
network (model.py), from the seed alone.

A train step, as the configuration states it: draw the sparse input (the
`sparse_samples` valid pixels of highest U(0, 1) score in each image, from
a device generator seeded by SeedSequence([seed, tag, step]), the
program's documented stream), forward in train mode, masked MSE over the
pixels with ground truth, gradients, clip by the global norm (g if |g| <
c, else g c / |g|), weight decay added to the clipped gradient, SGD with
momentum (the first step's buffer is the gradient itself).

Serving: rgb uint8 / 255 (in numpy, float32) and the sparse map as the
input's channels, eval mode (BatchNorm on the running statistics).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.model import Spec, forward


def sparse_draw(depth: torch.Tensor, n: int, max_depth: float, seed: int,
                tag: int, step: int) -> torch.Tensor:
    """depth (B, H, W) at the n valid pixels (0 < d <= max_depth) of
    highest score in each image, 0 elsewhere."""
    word = np.random.SeedSequence([seed, tag, step]).generate_state(1)[0]
    g = torch.Generator(device=depth.device).manual_seed(int(word))
    scores = torch.rand(depth.shape, generator=g, device=depth.device)
    valid = (depth > 0) & (depth <= max_depth)
    scores = torch.where(valid, scores, torch.full_like(scores, -1.0))
    b = depth.shape[0]
    flat = scores.reshape(b, -1)
    kth = torch.topk(flat, min(n, flat.shape[1]), dim=1).values[:, -1:]
    keep = (flat >= kth).reshape(depth.shape) & valid
    return torch.where(keep, depth, torch.zeros_like(depth))


def masked_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mask = (target > 0).float()
    return ((pred - target) ** 2 * mask).sum() / mask.sum().clamp_min(1.0)


def leaf_norms(tensors: dict) -> dict[str, float]:
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].float())
                         for k in names]).cpu().tolist()
    return dict(zip(names, norms))


def train_steps(weights: dict, batches: list, conf: dict, seed: int,
                precision, tag: int = 0) -> dict:
    """The configuration's first len(batches) train steps from `weights`
    (name -> tensor, not changed) on `batches` [(rgb (B, H, W, 3), depth
    (B, H, W))]: the losses, the per-leaf norms of the first step's
    clipped gradient, and of each parameter's change over all steps."""
    spec = Spec.from_config(conf)
    t, d = conf["train"], conf["data"]
    params = {k: v.detach().clone().requires_grad_(_is_param(k))
              for k, v in weights.items()}
    leaves = [k for k in params if _is_param(k)]
    start = {k: params[k].detach().clone() for k in leaves}
    momentum: dict = {}
    losses, first_grad = [], None
    for step, (rgb, depth) in enumerate(batches):
        sparse = sparse_draw(depth, d["num_samples"], d["max_depth"], seed,
                             tag, step)
        x = torch.cat([rgb, sparse[..., None]], dim=-1)
        pred = forward(params, x, spec, train=True, precision=precision)
        loss = masked_mse(pred, depth)
        grads = torch.autograd.grad(loss, [params[k] for k in leaves])
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            if norm >= t["clip_norm"]:
                grads = [g / norm * t["clip_norm"] for g in grads]
            if step == 0:
                first_grad = leaf_norms(dict(zip(leaves, grads)))
            for k, g in zip(leaves, grads):
                g = g + t["weight_decay"] * params[k]
                buf = momentum.get(k)
                momentum[k] = g if buf is None else t["momentum"] * buf + g
                params[k] -= t["lr"] * momentum[k]
        losses.append(float(loss.detach()))
    change = leaf_norms({k: params[k].detach() - start[k] for k in leaves})
    return {"losses": losses, "first_grad": first_grad, "change": change}


def _is_param(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


@torch.no_grad()
def serve(weights: dict, rgb: np.ndarray, sparse: np.ndarray, conf: dict,
          precision, block: int = 8) -> np.ndarray:
    """Refined depth (N, H, W) of N frames, rgb uint8 (N, H, W, 3) and
    sparse (N, H, W), in blocks of `block` frames."""
    spec = Spec.from_config(conf)
    device = next(iter(weights.values())).device
    out = []
    for i in range(0, len(rgb), block):
        r = torch.from_numpy(rgb[i:i + block].astype(np.float32) / 255.0)
        s = torch.from_numpy(sparse[i:i + block])
        r, s = r.to(device), s.to(device)
        x = torch.cat([r, s[..., None]], dim=-1)
        out.append(forward(weights, x, spec, train=False,
                           precision=precision).cpu().numpy())
    return np.concatenate(out)
