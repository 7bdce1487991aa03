"""The MFP model, its training forward and its eval forward (PyTorch).

Counterpart of ``flexdm_tpu/models/mfp.py`` for ``seq_type='default'``:

* :class:`MFPModel` is Encoder -> Blocks -> Decoder;
* :func:`forward_train` masks a batch per sampled task, runs the network
  (with dropout when training) and scores it with ``compute_mfp_loss``;
  every random number comes in through :class:`~.masking.TrainDraws`;
* :func:`forward_eval` applies externally supplied masks, runs the network
  once and merges ground truth back onto the unmasked fields.

MaskGIT decoding (``num_iter > 1``), the rico pos-sort protocol and the
baselines are not in this port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..data.schema import Schema, make_task_probs
from .decoder import Decoder
from .encoder import Encoder
from .losses import compute_mfp_loss
from .masking import (
    TrainDraws,
    merge_inputs_and_prediction,
    preprocess_for_test,
    preprocess_for_train,
)
from .transformer import Blocks

Tensors = Dict[str, torch.Tensor]


class MFPModel(nn.Module):
    """Encoder -> Blocks -> Decoder (flexdm_tpu/models/mfp.py:51-112)."""

    def __init__(self, schema: Schema, latent_dim: int = 256,
                 num_blocks: int = 4, block_type: str = "deepsvg",
                 num_heads: int = 8, dropout: float = 0.1,
                 context: Optional[str] = None):
        super().__init__()
        self.schema = schema
        self.context = context
        self.encoder = Encoder(schema, latent_dim, context)
        self.blocks = Blocks(
            latent_dim=latent_dim, num_blocks=num_blocks,
            block_type=block_type, num_heads=num_heads, dropout=dropout,
        )
        self.decoder = Decoder(schema, latent_dim, context)

    def forward(self, inputs: Tensors,
                generator: Optional[torch.Generator] = None) -> Tensors:
        """Predictions per field; dropout draws from ``generator`` (none:
        no dropout)."""
        seq, seq_mask = self.encoder(inputs)
        return self.decoder(self.blocks(seq, seq_mask, generator))


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """Static per-run task configuration."""

    task_probs: Tuple[float, ...]
    sort_pos: bool
    pos_task_id: int


def make_task_config(schema: Schema, masking_method: str) -> TaskConfig:
    return TaskConfig(
        task_probs=tuple(make_task_probs(schema, masking_method)),
        sort_pos=schema.sort_pos,
        pos_task_id=schema.task_names.index("pos"),
    )


def forward_train(model: MFPModel, inputs: Tensors, draws: TrainDraws,
                  task_config: TaskConfig, train: bool = True,
                  sample_weight: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One training forward: mask per task, predict, score.  Returns
    ``(loss, metrics)``.  ``train=False`` keeps the random task masking
    (that is how the reference validates) but turns dropout off;
    ``sample_weight`` (B,) zeroes batch-padding rows."""
    schema = model.schema
    sort_flag = None
    if task_config.sort_pos:
        sort_flag = draws.tasks == task_config.pos_task_id
    targets, modified, masks = preprocess_for_train(
        inputs, schema, draws.tasks, draws.uniforms, draws.element,
        draws.values,
    )
    outputs = model(modified, draws.dropout if train else None)
    return compute_mfp_loss(
        schema, targets, outputs, masks, sort_flag=sort_flag,
        sample_weight=sample_weight,
    )


@torch.no_grad()
def forward_eval(model: MFPModel, inputs: Tensors, masks: Tensors,
                 tasks: Optional[torch.Tensor] = None,
                 num_iter: int = 1) -> Tensors:
    """Masked inputs -> predictions with ground truth merged back."""
    if num_iter != 1:
        raise ValueError(
            f"num_iter={num_iter}: MaskGIT decoding is not in this port yet"
        )
    modified = preprocess_for_test(inputs, model.schema, masks, tasks)
    outputs = model(modified)
    return merge_inputs_and_prediction(inputs, model.schema, masks, outputs)
