"""Job configuration and model construction.

Counterpart of the model-facing fields of ``TrainConfig`` and of
``build_model`` in ``flexdm_tpu/train/trainer.py``.  A job's ``args.json``
(written by the JAX trainer) is read with :meth:`TrainConfig.from_args`;
fields the port does not use (optimizer, schedule, mesh, ...) are ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from flexdm_tpu.data.schema import Schema

from .models.mfp import MFPModel


@dataclasses.dataclass
class TrainConfig:
    """The fields of a job's ``args.json`` that define its model."""

    dataset_name: str = "crello"
    data_dir: str = ""
    latent_dim: int = 256
    num_blocks: int = 4
    block_type: str = "deepsvg"
    arch_type: str = "oneshot"
    seq_type: str = "default"
    context: Optional[str] = None
    input_dtype: str = "set"
    dropout: float = 0.1
    num_heads: int = 8
    dtype: Optional[str] = None
    use_elemwise_noise: bool = False

    @classmethod
    def from_args(cls, args: Dict[str, Any]) -> "TrainConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in args.items() if k in names})


def build_model(config: TrainConfig, schema: Schema) -> MFPModel:
    """The ``arch_type='oneshot'`` model; anything this port does not have
    yet raises ``NotImplementedError``."""
    unsupported = {
        "arch_type": config.arch_type != "oneshot",
        "seq_type": config.seq_type != "default",
        "input_dtype": config.input_dtype != "set",
        "dtype": config.dtype not in (None, "float32"),
        "use_elemwise_noise": config.use_elemwise_noise,
    }
    for field, bad in unsupported.items():
        if bad:
            raise NotImplementedError(
                f"{field}={getattr(config, field)!r} is not in this port yet"
            )
    return MFPModel(
        schema,
        latent_dim=config.latent_dim,
        num_blocks=config.num_blocks,
        block_type=config.block_type,
        num_heads=config.num_heads,
        dropout=config.dropout,
        context=config.context,
    )
