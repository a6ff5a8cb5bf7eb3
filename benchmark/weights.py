"""Seeded weights and inputs, made on the device in a few large calls.

`make_weights(shapes, seed, device)` draws one normal vector for every
float tensor of the network at once from a `torch.Generator` seeded with
`seed`, and shapes it into the tensors by name (views of that one buffer):

* convolution weights N(0, 1 / fan_in);
* the head's weight N(0, 0.01 / fan_in) and bias 1 + N(0, 0.1^2): the
  head is not zero, so the CSPN is not the identity map, and its
  affinities are positive, near 1, so that the normalized gates average
  the neighbours and the T iterations stay bounded, as a trained CSPN's
  do (i.i.d. signed affinities make the 8sum_clamp propagation expand:
  depths of 1e8 after 24 iterations);
* BatchNorm weight 1 + N(0, 0.1^2), bias N(0, 0.1^2), running mean
  N(0, 0.1^2), running variance 1 + 0.5 |N(0, 1)|.

The program and the reference load the same tensors; each copies them
into its own storage, so neither sees the other's updates.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, tag: int, device) -> torch.Generator:
    """A generator on `device` for stream `tag` of `seed` (any size)."""
    state = np.random.SeedSequence([seed % 2 ** 64, tag]).generate_state(2)
    word = (int(state[0]) << 32 | int(state[1])) & (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(word)


WEIGHTS, INPUTS = 1, 2


def _affine(name: str, shape: tuple) -> tuple[float, float, bool]:
    """(shift, scale, absolute) of the tensor `name`: value = shift +
    scale * (|n| if absolute else n) for a unit normal n."""
    leaf = name.rsplit(".", 1)[1]
    if name == "head.weight":
        return 0.0, 0.1 * float(np.prod(shape[1:])) ** -0.5, False
    if name == "head.bias":
        return 1.0, 0.1, False
    if leaf == "weight" and len(shape) == 4:
        return 0.0, float(np.prod(shape[1:])) ** -0.5, False
    if leaf == "weight":
        return 1.0, 0.1, False
    if leaf == "running_var":
        return 1.0, 0.5, True
    return 0.0, 0.1, False          # biases, running means


def make_weights(shapes: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every tensor of `shapes` (name -> shape), float32 on `device`."""
    sizes = [int(np.prod(s)) for s in shapes.values()]
    affine = [_affine(n, s) for n, s in shapes.items()]
    sizes_t = torch.tensor(sizes, device=device)
    shift = torch.repeat_interleave(
        torch.tensor([a[0] for a in affine], device=device), sizes_t)
    scale = torch.repeat_interleave(
        torch.tensor([a[1] for a in affine], device=device), sizes_t)
    absolute = torch.repeat_interleave(
        torch.tensor([a[2] for a in affine], device=device), sizes_t)
    n = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device),
                    device=device)
    flat = shift + scale * torch.where(absolute, n.abs(), n)
    return {name: part.view(shape) for (name, shape), part in
            zip(shapes.items(), flat.split(sizes))}
