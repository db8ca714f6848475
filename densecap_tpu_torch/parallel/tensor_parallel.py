"""Column-parallel layers over a model group (`--model_parallel`).

fc6, fc7 and the vocab projection each hold one rank's columns of their
(in, out) weight and of their bias (`parallel/mesh.py:split_columns`).
The ranks of a model group see the same batch and draw the same random
numbers, so everything outside these layers is computed alike on each;
a layer

  * copies its input into the model region (`copy_to_model`): the
    identity forward; in the backward each rank holds the part of the
    input's gradient that its columns give, and an all-reduce over the
    group sums them;
  * multiplies by its columns and adds its bias columns;
  * gathers the columns of every rank (`gather_from_model`): an
    all-gather forward; in the backward each rank keeps its own columns
    of the output's gradient, which every rank holds whole.

The JAX package lets XLA place the same collectives from its
PartitionSpecs. Columns that M does not divide evenly are padded to the
widest rank's only inside the all-gather (gloo gathers equal sizes) and
sliced off at once, so no padded column exists outside it. Only
all-reduce, all-gather and broadcast are used, which gloo offers for CUDA
tensors too.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import distributed
from .mesh import split_columns


class ColumnShard:
    """Rank `rank`'s columns of a dim of `width` split over the `size`
    ranks of the model group `group`."""

    def __init__(self, width, rank, size, group):
        self.bounds = split_columns(width, size)
        self.start, self.stop = self.bounds[rank]
        self.group = group

    @classmethod
    def of_this_rank(cls, width):
        """This process's columns in its model group, or None without
        tensor parallelism."""
        if distributed.model_size() == 1:
            return None
        return cls(width, distributed.model_rank(), distributed.model_size(),
                   distributed.model_group())

    def local(self, x):
        """This rank's columns (last dim) of a full tensor."""
        return x[..., self.start:self.stop]

    def gather(self, x):
        """This rank's columns -> the full tensor, on every rank of the
        group (a collective; no autograd)."""
        widest = max(b - a for a, b in self.bounds)
        x = F.pad(x, (0, widest - x.shape[-1])).contiguous()
        parts = [torch.empty_like(x) for _ in self.bounds]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat([p[..., :b - a]
                          for p, (a, b) in zip(parts, self.bounds)], -1)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.group = shard.group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard.gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.local(g).contiguous(), None


def copy_to_model(x, shard):
    """Identity; the backward sums the input's gradient over the group."""
    return _CopyToModel.apply(x, shard)


def gather_from_model(x, shard):
    """The group's column shards -> the full columns; the backward keeps
    this rank's columns of the gradient."""
    return _GatherFromModel.apply(x, shard)
