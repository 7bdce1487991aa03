"""Per-field decoder heads (PyTorch), default detachment.

Counterpart of the ``detachment='default'`` branch of
``flexdm_tpu/models/decoder.py``: every sequence column has a Dense head
``decoder_{name}`` over the transformed sequence; the heads are applied as
ONE matmul of the concatenated kernels and the result is split per column.
Categorical heads give ``(B, S, C, input_dim)`` logits, numerical heads the
``(B, S, C)`` vector.  With a context token the first position is dropped
before the heads.  Canvas heads and the flat/none detachments are not in
this port yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..data.schema import ColumnSpec, Schema


def head_shape(column: ColumnSpec):
    """``(units, per-element output shape)`` of a column's head."""
    if column.is_categorical:
        return (column.shape[-1] * column.input_dim,
                (column.shape[-1], column.input_dim))
    return column.shape[-1], (column.shape[-1],)


class Decoder(nn.Module):
    def __init__(self, schema: Schema, latent_dim: int = 256,
                 context: Optional[str] = None):
        super().__init__()
        self.context = context
        self.columns = [c for c in schema.valid_columns(False) if c.is_sequence]
        for c in self.columns:
            self.add_module(
                f"decoder_{c.name}", nn.Linear(latent_dim, head_shape(c)[0])
            )

    def forward(self, h: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.context is not None:
            h = h[:, 1:]
        heads = [getattr(self, f"decoder_{c.name}") for c in self.columns]
        fused = F.linear(
            h,
            torch.cat([m.weight for m in heads]),
            torch.cat([m.bias for m in heads]),
        )
        b = h.shape[0]
        outputs, offset = {}, 0
        for c in self.columns:
            units, shape = head_shape(c)
            outputs[c.name] = fused[..., offset:offset + units].view(
                (b, -1) + shape
            )
            offset += units
        return outputs
