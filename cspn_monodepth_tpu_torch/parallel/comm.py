"""The differentiable collectives of the sharded path, as autograd Functions
over torch.distributed (where XLA transposes psum and all_to_all itself).

* `all_reduce(x, group)`: the sum over the group; its backward is the sum
  of the cotangents over the group, since every rank's output depends on
  every rank's input.
* `all_to_all(x, group)`: x (n, ...) on each of the group's n ranks; slot j
  goes to group rank j, and slot j of the result came from group rank j:
  `all_to_all_v` with slots of one row.
* `all_to_all_v(x, send, recv, group)`: slots of different lengths along
  dim 0 (`send[j]` rows of x to group rank j, `recv[j]` rows from it; a
  rank's own slot may be empty); its backward is the reverse exchange,
  `recv` sent and `send` received, which sends each cotangent back to
  where its row came from.

`COUNTS` tallies every exchange these make, forward and backward: the
calls of each kind and the bytes this rank sends to the other ranks of
the group (its own slot is not sent). Set them to 0 with `reset_counts()`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

COUNTS = {"all_reduce": 0, "all_reduce_bytes": 0, "all_to_all": 0,
          "all_to_all_bytes": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _count(kind: str, nbytes: int) -> None:
    COUNTS[kind] += 1
    COUNTS[kind + "_bytes"] += nbytes


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    _count("all_reduce", out.nbytes)
    dist.all_reduce(out, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.group), None


class _AllToAllV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.sizes = send, recv, group
        return _exchange_v(x, send, recv, group)

    @staticmethod
    def backward(ctx, grad):
        send, recv, group = ctx.sizes
        return _exchange_v(grad, recv, send, group), None, None, None


def _exchange_v(x: torch.Tensor, send: list[int], recv: list[int],
                group) -> torch.Tensor:
    if x.shape[0] != sum(send):
        raise ValueError(f"all_to_all_v sends {sum(send)} rows, shape "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    row_bytes = x.nbytes // max(x.shape[0], 1)
    _count("all_to_all",
           (sum(send) - send[dist.get_rank(group)]) * row_bytes)
    dist.all_to_all_single(out, x, output_split_sizes=list(recv),
                           input_split_sizes=list(send), group=group)
    return out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the group's ranks, differentiable."""
    return _AllReduce.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Slot j of x (n, ...) to group rank j; differentiable."""
    n = dist.get_world_size(group)
    return all_to_all_v(x, [1] * n, [1] * n, group)


def all_to_all_v(x: torch.Tensor, send: list[int], recv: list[int],
                 group) -> torch.Tensor:
    """The first send[0] rows of x to group rank 0, the next send[1] to
    rank 1, ...; the result holds recv[j] rows from each rank j in rank
    order. Every rank's send[j] must be rank j's recv[this rank].
    Differentiable."""
    return _AllToAllV.apply(x, list(send), list(recv), group)
