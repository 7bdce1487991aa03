"""Per-field decoder heads (PyTorch).

Counterpart of ``Decoder`` in ``flexdm_tpu/models/decoder.py``.  Every
valid sequence column has a Dense head
``decoder_{name}``; categorical heads give ``(B, S, C, input_dim)``
logits, numerical heads the ``(B, S, C)`` vector.

* ``detachment='default'``: the heads read the transformed sequence and
  are applied as ONE matmul of the concatenated kernels, split per column.
  With context ``id``, ``length`` or ``canvas`` the first token is split
  off (``canvas_add`` keeps every token); ``canvas`` adds a head
  ``decoder_{canvas column}`` on that token, ``(B, C, input_dim)`` each.
* ``detachment='flat'``: the ``(B, S * F, D)`` stream is cut back into
  one ``(B, S, D)`` sequence per field, each read by its own head.
* ``detachment='none'``: the input is already a dict of per-field
  ``(B, S, in_dim)`` features (LayoutVAE's CVAE decoders, ``in_dim`` 64),
  each read by its own head.  flax infers a head's input width from its
  input; here it is ``in_dim`` (default ``latent_dim``).

``length_head=True`` adds the ``decoder_length`` Dense that
:meth:`Decoder.predict_mask` reads: the validity mask of the argmax of
its length logits (decoder.py:41-46).  No model of the JAX package calls
it (flax refuses the Dense it makes outside ``setup``/``@compact``), so
no model here builds it.

Every head is a Dense in the compute ``dtype`` when one is given (input,
kernel and bias cast at apply time, flexdm_tpu/models/decoder.py:100-132),
so the outputs are bf16 under ``--dtype bfloat16``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch
from torch import nn

from ..data.schema import ColumnSpec, Schema
from ..parallel.layers import copy_to_model, gather_from_model, split_of
from .masking import get_seq_mask
from .transformer import dense

DETACHMENTS = ("default", "flat", "none")


def head_shape(column: ColumnSpec):
    """``(units, per-element output shape)`` of a column's head."""
    if column.is_categorical:
        return (column.shape[-1] * column.input_dim,
                (column.shape[-1], column.input_dim))
    return column.shape[-1], (column.shape[-1],)


class Decoder(nn.Module):
    def __init__(self, schema: Schema, latent_dim: int = 256,
                 context: Optional[str] = None, detachment: str = "default",
                 dtype: Optional[torch.dtype] = None,
                 in_dim: Optional[int] = None, length_head: bool = False):
        super().__init__()
        if detachment not in DETACHMENTS:
            raise ValueError(f"detachment {detachment!r} not in "
                             f"{DETACHMENTS}")
        if context is not None and detachment != "default":
            raise ValueError(f"context {context!r} needs detachment 'default'")
        self.schema = schema
        self.context = context
        self.detachment = detachment
        self.latent_dim = latent_dim
        self.dtype = dtype
        columns = schema.valid_columns(context == "canvas")
        self.columns = [c for c in columns if c.is_sequence]
        self.canvas_columns = [c for c in columns if not c.is_sequence]
        for c in columns:
            self.add_module(f"decoder_{c.name}", nn.Linear(
                in_dim or latent_dim, head_shape(c)[0]))
        if length_head:
            self.decoder_length = nn.Linear(latent_dim,
                                            schema["length"].input_dim)

    def _head(self, column: ColumnSpec, h: torch.Tensor) -> torch.Tensor:
        return self._heads(h, [getattr(self, f"decoder_{column.name}")])[0]

    def _heads(self, h: torch.Tensor, heads) -> List[torch.Tensor]:
        """Each Dense head of ``heads`` applied to ``h``, as one matmul of
        the concatenated kernels.  Tensor-parallel, the split heads are
        column-parallel, one matmul of this rank's slices whose outputs
        are gathered once over the model group; the heads whose width does
        not divide it run whole on every rank."""
        split = [m for m in heads if split_of(m.weight) is not None]
        whole = [m for m in heads if split_of(m.weight) is None]

        def apply(x, group):
            return dense(x, torch.cat([m.weight for m in group]),
                         torch.cat([m.bias for m in group]), self.dtype)

        def widths(group):
            return [m.weight.shape[0] for m in group]

        out = {}
        if whole:
            out.update(zip(map(id, whole),
                           apply(h, whole).split(widths(whole), -1)))
        if split:
            model = split_of(split[0].weight)
            y = gather_from_model(apply(copy_to_model(h, model), split),
                                  model)
            for m, part in zip(split, y.split(widths(split), -1)):
                # (M, ..., units / M) -> (..., units)
                out[id(m)] = part.movedim(0, -2).flatten(-2)
        return [out[id(m)] for m in heads]

    def predict_mask(self, z: torch.Tensor) -> torch.Tensor:
        """``(B, S)`` validity mask of the length the ``decoder_length``
        head predicts from ``z`` (B, D)."""
        logits = dense(z, self.decoder_length.weight,
                       self.decoder_length.bias)
        return get_seq_mask(logits, self.schema.max_length, from_logits=True)

    def forward(self, h: Union[torch.Tensor, Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
        if self.detachment == "none":
            return {c.name: self._head(c, h[c.name]).view(
                        h[c.name].shape[:2] + head_shape(c)[1])
                    for c in self.columns}
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
        heads = self._heads(h, [getattr(self, f"decoder_{c.name}")
                                for c in self.columns])
        for c, y in zip(self.columns, heads):
            outputs[c.name] = y.view((b, -1) + head_shape(c)[1])
        for c in self.canvas_columns:
            outputs[c.name] = self._head(c, canvas_h).view(
                (b,) + head_shape(c)[1])
        return outputs
