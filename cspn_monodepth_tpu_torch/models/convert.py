"""Weights between the JAX package's variable tree and the port's modules.

The JAX package keeps its weights as `{"params": ..., "batch_stats": ...}`
nested dicts (flax). `load_jax_variables` fills a port CSPNDepthNet from
such a tree of numpy arrays; `jax_variables` writes one out. Both are
strict: every port parameter and BN statistic is matched to JAX leaves and
every JAX leaf is used.

Layout differences handled here:
* conv kernels: HWIO (JAX) <-> OIHW (torch);
* UpProj blocks: JAX keeps the 5x5 kernels of the unpooled map
  (`conv1a_up`, `conv2_up`) apart from those of the skip (`conv1a_skip`,
  `conv2_skip`); the port's concat conv holds both, in that order along
  the input channels;
* head: `depth_head_*` and `guidance_head_*` are the port's one 9-channel
  head, concatenated along the output channels;
* BatchNorm: scale/bias/mean/var <-> weight/bias/running_mean/running_var.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from cspn_monodepth_tpu_torch.models.unet import UpProjBlock


class _Entry(NamedTuple):
    tensor: str                         # port state_dict key
    leaves: tuple[tuple[str, ...], ...]  # JAX (collection, *path) leaves
    axis: int = 0                       # concat axis (HWIO for kernels)
    sizes: tuple[int, ...] = ()         # leaf sizes along `axis`
    conv: bool = False


def _spec(model: nn.Module) -> list[_Entry]:
    spec = [
        _Entry("head.weight", (("params", "depth_head_kernel"),
                               ("params", "guidance_head_kernel")),
               axis=3, sizes=(1, 8), conv=True),
        _Entry("head.bias", (("params", "depth_head_bias"),
                             ("params", "guidance_head_bias")),
               sizes=(1, 8)),
    ]
    done = {"head"}
    for name, m in model.named_modules():
        if not isinstance(m, UpProjBlock):
            continue
        path = tuple(name.split("."))
        for conv in ("conv1a", "conv2"):
            leaves = [("params", *path, f"{conv}_up")]
            sizes = [m.in_channels]
            if m.skip_channels:
                leaves.append(("params", *path, f"{conv}_skip"))
                sizes.append(m.skip_channels)
            spec.append(_Entry(f"{name}.{conv}.weight", tuple(leaves),
                               axis=2, sizes=tuple(sizes), conv=True))
            done.add(f"{name}.{conv}")
    for name, m in model.named_modules():
        path = tuple(name.split("."))
        if isinstance(m, nn.Conv2d) and name not in done:
            spec.append(_Entry(f"{name}.weight",
                               (("params", *path, "kernel"),), conv=True))
        elif isinstance(m, nn.BatchNorm2d):
            for tensor, col, leaf in (
                    ("weight", "params", "scale"),
                    ("bias", "params", "bias"),
                    ("running_mean", "batch_stats", "mean"),
                    ("running_var", "batch_stats", "var")):
                spec.append(_Entry(f"{name}.{tensor}",
                                   ((col, *path, leaf),)))
    return spec


def _flatten(tree, prefix=()) -> dict[tuple[str, ...], np.ndarray]:
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree)}


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Fill `model` (a port CSPNDepthNet) from the JAX package's
    {"params", "batch_stats"} tree of arrays. Raises on a missing, unused
    or misshapen leaf. Returns the model."""
    leaves = _flatten({k: variables[k] for k in ("params", "batch_stats")})
    state = model.state_dict()
    used, filled = set(), set()
    for e in _spec(model):
        missing = [leaf for leaf in e.leaves if leaf not in leaves]
        if missing:
            raise KeyError(f"{e.tensor}: no JAX leaf {'/'.join(missing[0])}")
        parts = [leaves[leaf] for leaf in e.leaves]
        a = parts[0] if len(parts) == 1 else np.concatenate(parts, e.axis)
        if e.conv:
            a = a.transpose(3, 2, 0, 1)
        dst = state[e.tensor]
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"{e.tensor}: JAX shape {a.shape} vs port "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.ascontiguousarray(a, np.float32)))
        used.update(e.leaves)
        filled.add(e.tensor)
    unfilled = [k for k in state
                if k not in filled and not k.endswith("num_batches_tracked")]
    unused = sorted("/".join(k) for k in set(leaves) - used)
    if unfilled or unused:
        raise ValueError(f"unfilled port tensors {unfilled}; "
                         f"unused JAX leaves {unused}")
    return model


def jax_variables(model: nn.Module) -> dict:
    """The inverse of load_jax_variables: the model's weights as the JAX
    package's {"params", "batch_stats"} tree of float32 numpy arrays. The
    arrays are copies: a later in-place update of the model (an optimizer
    step, a train-mode BN statistic) does not reach them."""
    state = model.state_dict()
    tree: dict = {"params": {}, "batch_stats": {}}
    for e in _spec(model):
        a = state[e.tensor].detach().float().cpu().numpy().copy()
        if e.conv:
            a = a.transpose(2, 3, 1, 0)
        parts = (np.split(a, np.cumsum(e.sizes)[:-1], e.axis) if e.sizes
                 else [a])
        for leaf, part in zip(e.leaves, parts):
            node = tree
            for key in leaf[:-1]:
                node = node.setdefault(key, {})
            node[leaf[-1]] = np.ascontiguousarray(part)
    return tree
