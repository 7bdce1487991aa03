"""More than one device: the ``(data, model)`` grid of ranks, the
tensor-parallel partition rules and the collectives they need."""

from .mesh import (
    MODEL_AXIS,
    Grid,
    gather_params,
    partition_spec,
    shard_params,
    spawn,
)

__all__ = [
    "MODEL_AXIS",
    "Grid",
    "gather_params",
    "partition_spec",
    "shard_params",
    "spawn",
]
