"""Schema-driven multi-attribute encoder (PyTorch), add fusion.

Counterpart of ``Encoder`` in ``flexdm_tpu/models/encoder.py`` with
``fusion='add'`` and ``context`` in ``(None, 'id')``, the element-token model
the serving path runs.  Every valid sequence column contributes a
``(B, S, D)`` embedding and the contributions are summed:

* categorical: the sum over channels of rows of an ``(input_dim + 2, D)``
  table (two extra rows for ``[MASK]``/``[NULL]``).  All tables are gathered
  in one lookup; an id outside its table adds nothing, as the JAX one-hot
  contraction does.
* numerical: ``Dense(D)`` of the raw vector, with a 2-row special table
  substituted where the input is the all-channel ``MASK_VALUE`` /
  ``NULL_VALUE`` sentinel.  All numerical columns go through ONE matmul of
  ``[x * normal, normal, is_masked, is_unused]`` against
  ``[kernel; bias; special[0]; special[1]]`` (encoder.py:120-144).

``context='id'`` prepends the task-embedding token and lengthens the mask
by one.  The other fusions (concat/flat/none), the canvas/length contexts,
position embeddings and element-wise noise are not in this port yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..data.schema import MASK_VALUE, NULL_VALUE, Schema
from .masking import get_seq_mask

CONTEXTS = (None, "id")


class Encoder(nn.Module):
    def __init__(self, schema: Schema, latent_dim: int = 128,
                 context: Optional[str] = None):
        super().__init__()
        if context not in CONTEXTS:
            raise NotImplementedError(f"encoder context {context!r}")
        self.schema = schema
        self.latent_dim = latent_dim
        self.context = context
        columns = [c for c in schema.valid_columns(False) if c.is_sequence]
        self.cat_columns = [c for c in columns if c.is_categorical]
        self.num_columns = [c for c in columns if not c.is_categorical]
        for c in self.cat_columns:
            self.register_parameter(f"input_{c.name}", nn.Parameter(
                torch.empty(c.input_dim + 2, latent_dim)
            ))
        for c in self.num_columns:
            self.add_module(
                f"input_{c.name}", nn.Linear(c.shape[-1], latent_dim)
            )
            self.register_parameter(f"input_{c.name}_special", nn.Parameter(
                torch.empty(2, latent_dim)
            ))
        if context == "id":
            self.input_task = nn.Parameter(
                torch.empty(len(schema.task_names), latent_dim)
            )

    def _categorical(self, inputs) -> torch.Tensor:
        tables = [getattr(self, f"input_{c.name}") for c in self.cat_columns]
        # One zero row after the tables takes every out-of-range id.
        table = torch.cat(tables + [tables[0].new_zeros(1, self.latent_dim)])
        rows = table.shape[0] - 1
        ids, offset = [], 0
        for c, t in zip(self.cat_columns, tables):
            x = inputs[c.name].long()
            inside = (x >= 0) & (x < t.shape[0])
            ids.append(torch.where(inside, x + offset, rows))
            offset += t.shape[0]
        # F.embedding, not table[ids]: the backward of advanced indexing
        # (index_put with accumulate) walks duplicate ids one by one, and a
        # training batch repeats a few hundred rows ~10^5 times.
        return F.embedding(torch.cat(ids, dim=-1), table).sum(dim=2)

    def _numerical(self, inputs) -> torch.Tensor:
        feats, rows = [], []
        for c in self.num_columns:
            x = inputs[c.name]
            dense = getattr(self, f"input_{c.name}")
            special = getattr(self, f"input_{c.name}_special")
            is_masked = (x == MASK_VALUE).all(-1)
            is_unused = (x == NULL_VALUE).all(-1)
            normal = ~(is_masked | is_unused)
            feats.append(x * normal[..., None].to(x.dtype))
            feats.append(
                torch.stack([normal, is_masked, is_unused], -1).to(x.dtype)
            )
            rows.append(dense.weight.t())
            rows.append(torch.cat([dense.bias[None], special]))
        return torch.cat(feats, -1) @ torch.cat(rows)

    def forward(self, inputs: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        max_length = self.schema.max_length
        seq_mask = get_seq_mask(inputs["length"], max_length)
        parts = []
        if self.cat_columns:
            parts.append(self._categorical(inputs))
        if self.num_columns:
            parts.append(self._numerical(inputs))
        seq = sum(parts[1:], parts[0])
        if self.context == "id":
            task = inputs["task"].reshape(-1).long()
            seq = torch.cat([self.input_task[task][:, None], seq], dim=1)
            seq_mask = get_seq_mask(inputs["length"] + 1, max_length + 1)
        return seq, seq_mask
