"""Megatron's conjugate collectives over the model group, as autograd
functions.

No file of the JAX package holds these: there GSPMD inserts the
collectives that the partition rules of :mod:`.mesh` imply.  Here a
tensor-parallel layer calls them itself:

* :func:`copy_to_model` before a column-parallel layer: the identity
  forward (every model rank holds the whole input) and an all-reduce
  backward (each rank's slice of the output gives part of the input's
  gradient);
* :func:`reduce_from_model` after a row-parallel layer: an all-reduce
  forward (each rank's slice of the contraction gives part of the sum) and
  the identity backward;
* :func:`gather_from_model`: the ranks' slices stacked on a new leading
  dimension; its backward keeps the rank's own slice of the gradient;
* :func:`full`: a split parameter gathered whole (the encoder's tables and
  Dense kernels), a parameter that is not split as it is.

A split parameter carries a :class:`Split` in its ``tp_split`` attribute
(set by :func:`.mesh.shard_params`); :func:`split_of` reads it.  Every
model rank runs the same forward and backward, so the collectives meet in
the same order on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Split:
    """A parameter split over the model group: model rank ``rank`` of
    ``size`` holds the ``rank``-th of ``size`` equal slices of dimension
    ``dim`` of the whole tensor."""

    group: Any
    rank: int
    size: int
    dim: int


def split_of(param: torch.Tensor) -> Optional[Split]:
    return getattr(param, "tp_split", None)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank = rank
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank], None, None, None


def copy_to_model(x: torch.Tensor, split: Split) -> torch.Tensor:
    return _CopyToModel.apply(x, split.group)


def reduce_from_model(x: torch.Tensor, split: Split) -> torch.Tensor:
    return _ReduceFromModel.apply(x, split.group)


def gather_from_model(x: torch.Tensor, split: Split) -> torch.Tensor:
    """``(size, *x.shape)``: every model rank's ``x``, in rank order."""
    return _GatherFromModel.apply(x, split.group, split.rank, split.size)


def full(param: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a split parameter; any other as it is."""
    split = split_of(param)
    if split is None:
        return param
    return torch.cat(gather_from_model(param, split).unbind(0), split.dim)


def row_parallel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x W^T + b`` of a Dense layer whose contraction is split: each
    rank's partial product summed over the model group, then the bias
    (whole on every rank) added once; ``dtype`` as in
    :func:`..models.transformer.dense`."""
    split = split_of(weight)
    if dtype is not None:
        x, weight, bias = x.to(dtype), weight.to(dtype), bias.to(dtype)
    return reduce_from_model(torch.nn.functional.linear(x, weight),
                             split) + bias
