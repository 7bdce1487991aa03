"""Job configuration and model construction.

Counterpart of ``TrainConfig`` and ``build_model`` in
``flexdm_tpu/train/trainer.py``, for the fields the port has: the model,
the task mix, the optimizer, the schedule and the device.  A job's
``args.json`` (written by either trainer) is read with
:meth:`TrainConfig.from_args`; fields the port does not have (mesh,
resume, profiling, ...) are ignored there, and the CLI refuses them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from .data.schema import Schema
from .models.mfp import MFPModel


@dataclasses.dataclass
class TrainConfig:
    """A training job (the fields of its ``args.json``)."""

    dataset_name: str = "crello"
    data_dir: str = ""
    job_dir: str = ""
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
    masking_method: str = "random"
    l2: Optional[float] = 1e-2
    batch_size: int = 256
    num_epochs: int = 500
    learning_rate: float = 1e-4
    validation_freq: int = 10
    seed: int = 0
    device: str = "cuda"  # the torch device the job trains on

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_args(cls, args: Dict[str, Any]) -> "TrainConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in args.items() if k in names})


def build_model(config: TrainConfig, schema: Schema) -> MFPModel:
    """The ``arch_type='oneshot'`` model, built as the JAX trainer builds it
    (``flexdm_tpu/train/trainer.py:105-130``); a baseline or a compute dtype
    other than float32 raises ``NotImplementedError``."""
    unsupported = {
        "arch_type": config.arch_type != "oneshot",
        "dtype": config.dtype not in (None, "float32"),
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
        input_dtype=config.input_dtype,
        seq_type=config.seq_type,
        use_elemwise_noise=config.use_elemwise_noise,
    )
