"""The MFP model and its eval forward (PyTorch).

Counterpart of ``flexdm_tpu/models/mfp.py`` for ``seq_type='default'``:
:class:`MFPModel` is Encoder -> Blocks -> Decoder, and :func:`forward_eval`
applies externally supplied masks, runs the network once and merges ground
truth back onto the unmasked fields.  MaskGIT decoding (``num_iter > 1``)
is not in this port yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from flexdm_tpu.data.schema import Schema

from .decoder import Decoder
from .encoder import Encoder
from .masking import merge_inputs_and_prediction, preprocess_for_test
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

    def forward(self, inputs: Tensors) -> Tensors:
        seq, seq_mask = self.encoder(inputs)
        return self.decoder(self.blocks(seq, seq_mask))


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
