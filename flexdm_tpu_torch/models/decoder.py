"""Per-field decoder heads (PyTorch).

Counterpart of ``Decoder`` in ``flexdm_tpu/models/decoder.py`` for the
oneshot model.  Every valid sequence column has a Dense head
``decoder_{name}``; categorical heads give ``(B, S, C, input_dim)``
logits, numerical heads the ``(B, S, C)`` vector.

* ``detachment='default'``: the heads read the transformed sequence and
  are applied as ONE matmul of the concatenated kernels, split per column.
  With context ``id``, ``length`` or ``canvas`` the first token is split
  off (``canvas_add`` keeps every token); ``canvas`` adds a head
  ``decoder_{canvas column}`` on that token, ``(B, C, input_dim)`` each.
* ``detachment='flat'``: the ``(B, S * F, D)`` stream is cut back into
  one ``(B, S, D)`` sequence per field, each read by its own head.

Every head is a Dense in the compute ``dtype`` when one is given (input,
kernel and bias cast at apply time, flexdm_tpu/models/decoder.py:100-132),
so the outputs are bf16 under ``--dtype bfloat16``.

The baselines' ``detachment='none'`` and ``predict_mask`` are not in this
port yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..data.schema import ColumnSpec, Schema
from .transformer import dense


def head_shape(column: ColumnSpec):
    """``(units, per-element output shape)`` of a column's head."""
    if column.is_categorical:
        return (column.shape[-1] * column.input_dim,
                (column.shape[-1], column.input_dim))
    return column.shape[-1], (column.shape[-1],)


class Decoder(nn.Module):
    def __init__(self, schema: Schema, latent_dim: int = 256,
                 context: Optional[str] = None, detachment: str = "default",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if detachment not in ("default", "flat"):
            raise NotImplementedError(
                f"detachment {detachment!r} (a baseline's) is not in this "
                "port yet")
        if context is not None and detachment != "default":
            raise ValueError(f"context {context!r} needs detachment 'default'")
        self.context = context
        self.detachment = detachment
        self.latent_dim = latent_dim
        self.dtype = dtype
        columns = schema.valid_columns(context == "canvas")
        self.columns = [c for c in columns if c.is_sequence]
        self.canvas_columns = [c for c in columns if not c.is_sequence]
        for c in columns:
            self.add_module(
                f"decoder_{c.name}", nn.Linear(latent_dim, head_shape(c)[0])
            )

    def _head(self, column: ColumnSpec, h: torch.Tensor) -> torch.Tensor:
        head = getattr(self, f"decoder_{column.name}")
        return dense(h, head.weight, head.bias, self.dtype)

    def forward(self, h: torch.Tensor) -> Dict[str, torch.Tensor]:
        b = h.shape[0]
        canvas_h = None
        if self.context in ("id", "length", "canvas"):
            canvas_h, h = h[:, :1], h[:, 1:]
        outputs = {}
        if self.detachment == "flat":
            fields = h.reshape(b, -1, len(self.columns), self.latent_dim)
            for i, c in enumerate(self.columns):
                outputs[c.name] = self._head(c, fields[:, :, i]).view(
                    (b, -1) + head_shape(c)[1])
            return outputs
        heads = [getattr(self, f"decoder_{c.name}") for c in self.columns]
        fused = dense(
            h,
            torch.cat([m.weight for m in heads]),
            torch.cat([m.bias for m in heads]),
            self.dtype,
        )
        offset = 0
        for c in self.columns:
            units, shape = head_shape(c)
            outputs[c.name] = fused[..., offset:offset + units].view(
                (b, -1) + shape
            )
            offset += units
        for c in self.canvas_columns:
            outputs[c.name] = self._head(c, canvas_h).view(
                (b,) + head_shape(c)[1])
        return outputs
