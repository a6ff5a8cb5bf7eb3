"""The differentiable collectives of the sharded path, as autograd Functions
over torch.distributed (where XLA transposes psum and all_to_all itself).

* `all_reduce(x, group)`: the sum over the group; its backward is the sum
  of the cotangents over the group, since every rank's output depends on
  every rank's input.
* `all_to_all(x, group)`: x (n, ...) on each of the group's n ranks; slot j
  goes to group rank j, and slot j of the result came from group rank j.
  Its backward sends each cotangent back to where its slot came from: the
  same exchange applied to the cotangents.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all needs one slot per rank: {n} ranks, "
                         f"shape {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the group's ranks, differentiable."""
    return _AllReduce.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Slot j of x (n, ...) to group rank j; differentiable."""
    return _AllToAll.apply(x, group)
