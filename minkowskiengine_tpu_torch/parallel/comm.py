"""The collectives of the parallel package, counted, and the autograd
Functions built on them.

Every collective the package issues goes through ``all_reduce``,
``all_gather`` or ``broadcast`` here, on a ``torch.distributed`` group
that a mesh axis names (``DeviceMesh.get_group``).  Each call adds one to
``counts[name]`` and the bytes of the tensor this rank hands the collective
to ``counts["bytes"]``; a phase or a test reads them around a step.  The
tensors go to the group's backend as they are: on the card NCCL moves them
device to device, and gloo, which the CPU tests use and which several
processes sharing one card must use, copies CUDA tensors through host
memory itself.  Only the edge bands and the blocks of ``all_gather`` are
padded so that every rank sends one size, as gloo and NCCL require.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

counts = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "bytes": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def axis(mesh, name: str):
    """(group, size, this rank's place) of a mesh axis."""
    group = mesh.get_group(name)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _count(name: str, t: torch.Tensor) -> None:
    counts[name] += 1
    counts["bytes"] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over ``group``; returns ``t``."""
    _count("all_reduce", t)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank), in group rank order."""
    _count("all_gather", t)
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def broadcast(t: torch.Tensor, group) -> torch.Tensor:
    """In place, from the group's first rank; returns ``t``."""
    _count("broadcast", t)
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t


class AllReduceSum(torch.autograd.Function):
    """The sum over ``group``; its gradient is the sum of the ranks'
    gradients.  A statistic summed over the rows of every rank (batch norm
    under spatial execution, the pooling sums)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


class SumGradient(torch.autograd.Function):
    """The identity, whose gradient is summed over ``group``: a value every
    rank holds whole (a parameter), used by a computation split over the
    ranks (row blocks under spatial execution, column slices under tensor
    parallelism).  Each rank's gradient is its share; the sum is the
    whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class GatherColumns(torch.autograd.Function):
    """(N, C/n) column slices of the ranks of ``group`` → the (N, C) whole,
    in rank order; the gradient is this rank's slice of the whole's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = dist.get_rank(group)
        ctx.width = x.shape[1]
        return torch.cat(all_gather(x, group), dim=1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[:, lo:lo + ctx.width].contiguous(), None
