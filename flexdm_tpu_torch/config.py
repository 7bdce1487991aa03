"""Job configuration and model construction.

Counterpart of ``TrainConfig`` and ``build_model`` in
``flexdm_tpu/train/trainer.py``, for the fields the port has: the model
(``remat`` included), the baselines' KL weight, the task mix, the
optimizer, the schedule, the input mode, warm start, resuming and the
``last`` checkpoint's period, profiling, the device and the grid of
ranks (``num_devices``, ``model_parallel``).  A job's ``args.json``
(written by either trainer) is read with :meth:`TrainConfig.from_args`;
fields the port does not have (the attention implementation, ...) are
ignored there, and the CLI refuses an attention implementation other
than ``auto``.  A job is served, evaluated and resumed on any number of
ranks, whatever its ``num_devices`` says.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional

from torch import nn

from .data.schema import Schema
from .models.baselines import BART, AutoReg, CanvasVAE, LayoutVAE
from .models.mfp import MFPModel

logger = logging.getLogger(__name__)

# arch_type -> the baseline class (flexdm_tpu/train/trainer.py:131-138).
BASELINES = {"canvasvae": CanvasVAE, "layoutvae": LayoutVAE,
             "autoreg": AutoReg, "bart_autoreg": BART}


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
    kl: float = 1.0  # the KL weight of the VAE baselines
    num_heads: int = 8
    dtype: Optional[str] = None
    remat: bool = False  # recompute each block's activations in the backward
    use_elemwise_noise: bool = False
    masking_method: str = "random"
    l2: Optional[float] = 1e-2
    batch_size: int = 256
    num_epochs: int = 500
    learning_rate: float = 1e-4
    validation_freq: int = 10
    seed: int = 0
    weights: Optional[str] = None  # warm start from a *.torch.npz weight file
    resume: bool = False  # continue from checkpoints/last.torch.npz
    # Write 'last' every N epochs (None: every validation_freq epochs; 0:
    # only at the end of the run) and at the end.
    checkpoint_every: Optional[int] = None
    # 'device': the train split resident on the device, batches gathered
    # there; 'host': batches from the host loader through a prefetch thread.
    input_mode: str = "device"
    enable_profile: bool = False  # a torch.profiler trace in logs/trace
    device: str = "cuda"  # the torch device the job trains on
    # None: one process, no process group; N: N ranks in a grid of
    # N / model_parallel data ranks by model_parallel model ranks.
    num_devices: Optional[int] = None
    model_parallel: int = 1

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_args(cls, args: Dict[str, Any]) -> "TrainConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in args.items() if k in names})


def build_model(config: TrainConfig, schema: Schema) -> nn.Module:
    """The model ``arch_type`` names, built as the JAX trainer builds it
    (``flexdm_tpu/train/trainer.py:105-139``).  The oneshot model computes
    in the job's ``dtype`` (None, ``"float32"`` or ``"bfloat16"``; another
    raises ``NotImplementedError``) and takes ``remat``.  A baseline takes
    neither, as in JAX: it computes in float32 whatever ``dtype`` says
    (logged), and its ``input_dtype`` is its own."""
    common = dict(
        latent_dim=config.latent_dim,
        num_blocks=config.num_blocks,
        block_type=config.block_type,
        num_heads=config.num_heads,
        dropout=config.dropout,
    )
    if config.arch_type in BASELINES:
        if config.dtype not in (None, "float32"):
            logger.info("arch_type %s computes in float32: dtype %s applies "
                        "to the oneshot model only, as in the JAX package",
                        config.arch_type, config.dtype)
        cls = BASELINES[config.arch_type]
        if cls in (CanvasVAE, LayoutVAE):
            common["kl"] = config.kl
        return cls(schema, **common)
    if config.arch_type != "oneshot":
        raise ValueError(f"arch_type {config.arch_type!r} not in "
                         f"{('oneshot',) + tuple(BASELINES)}")
    return MFPModel(
        schema,
        **common,
        context=config.context,
        input_dtype=config.input_dtype,
        seq_type=config.seq_type,
        use_elemwise_noise=config.use_elemwise_noise,
        dtype=config.dtype,
        remat=config.remat,
    )
