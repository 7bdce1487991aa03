"""Schema-driven multi-attribute encoder (PyTorch).

Counterpart of ``Encoder`` in ``flexdm_tpu/models/encoder.py``.  Fusions:
``add`` (one token per element, the default), ``flat`` (one token per
(element, field), the VanillaTransformer), ``concat`` (the fields'
embeddings concatenated and projected back to D) and ``none`` (a dict of
the fields' embeddings, LayoutVAE's ground-truth encoder).

* categorical column: the sum over channels of rows of an
  ``(input_dim + 2, D)`` table (two extra rows for ``[MASK]``/``[NULL]``);
  an id outside its table adds nothing, as the JAX one-hot contraction
  does.
* numerical column: ``Dense(D)`` of the raw vector, with a 2-row special
  table substituted where the input is the all-channel ``MASK_VALUE`` /
  ``NULL_VALUE`` sentinel.

``add`` sums the sequence columns' embeddings: all tables are gathered in
one lookup, and all numerical columns go through ONE matmul of
``[x * normal, normal, is_masked, is_unused]`` against
``[kernel; bias; special[0]; special[1]]`` (encoder.py:98-149).  The other
fusions and the canvas columns embed each column on its own
(encoder.py:151-180): a table lookup, or the Dense with the special rows
put in by ``torch.where``.  ``flat`` stacks the fields to
``(B, S * F, D)``, repeats the mask F times and adds the position
embedding ``emb_seq_pos`` (encoder.py:198-210).  ``concat`` applies
``fusion_fc`` (``F * D -> D``), the LayerNorm ``fusion_norm`` and dropout
to the concatenated fields (encoder.py:190-197); ``none`` returns
``({name: (B, S, D)}, mask)`` before any context or position embedding
(encoder.py:211-212).

Under a compute ``dtype`` (bf16) the rounding points are JAX's.  The
``add`` contraction rounds every operand (one-hot counts, table rows,
inputs, kernels, bias and special rows) to bf16, sums in float32 and
rounds the sum once; so do the lookups of the other categorical columns.
A numerical column outside ``add`` is a bf16 Dense, and the float32
special rows put in by ``torch.where`` promote it to float32, as
``jnp.where`` does.

Contexts (encoder.py:216-241): ``id`` (task embedding), ``length``
(length embedding) and ``canvas`` (the sum of the canvas columns'
embeddings) prepend a token and lengthen the mask by one; ``canvas_add``
adds the canvas embedding to every token.  ``input_dtype != 'set'`` adds
the ``input_const`` position embedding (encoder.py:243-249), and
``use_elemwise_noise`` adds ``Dense(D)`` of a ``(B, S', 4)`` standard
normal draw that the caller passes in (encoder.py:251-260).  Dropout of
the position embeddings (and of ``concat``) draws from the caller's
generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..data.schema import MASK_VALUE, NULL_VALUE, ColumnSpec, Schema
from .masking import NOISE_SIZE, get_seq_mask
from ..ops.rng import FastDropout
from ..parallel.layers import full
from .transformer import LAYER_NORM_EPS, PositionEmbedding, dense

CONTEXTS = (None, "id", "canvas", "length", "canvas_add")
FUSIONS = ("add", "flat", "concat", "none")


class Encoder(nn.Module):
    def __init__(self, schema: Schema, latent_dim: int = 128,
                 context: Optional[str] = None, input_dtype: str = "set",
                 fusion: str = "add", dropout: float = 0.1,
                 use_elemwise_noise: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if context not in CONTEXTS:
            raise ValueError(f"encoder context {context!r} not in {CONTEXTS}")
        if fusion not in FUSIONS:
            raise ValueError(f"fusion {fusion!r} not in {FUSIONS}")
        if fusion != "add" and context is not None:
            raise ValueError(f"context {context!r} needs fusion 'add'")
        if fusion != "add" and use_elemwise_noise:
            raise ValueError("use_elemwise_noise needs fusion 'add'")
        self.schema = schema
        self.latent_dim = latent_dim
        self.context = context
        self.fusion = fusion
        self.use_elemwise_noise = use_elemwise_noise
        self.dtype = dtype
        use_canvas = context is not None and "canvas" in context
        columns = schema.valid_columns(use_canvas)
        self.seq_columns = [c for c in columns if c.is_sequence]
        self.canvas_columns = [c for c in columns if not c.is_sequence]
        if use_canvas and not self.canvas_columns:
            raise ValueError(f"context {context!r} needs canvas columns")
        if fusion != "add" and self.canvas_columns:
            raise ValueError(f"fusion {fusion!r} takes no canvas columns")
        self.cat_columns = [c for c in self.seq_columns if c.is_categorical]
        self.num_columns = [c for c in self.seq_columns
                            if not c.is_categorical]
        for c in columns:
            if c.is_categorical:
                self.register_parameter(f"input_{c.name}", nn.Parameter(
                    torch.empty(c.input_dim + 2, latent_dim)
                ))
            else:
                self.add_module(
                    f"input_{c.name}", nn.Linear(c.shape[-1], latent_dim)
                )
                self.register_parameter(f"input_{c.name}_special",
                                        nn.Parameter(torch.empty(2, latent_dim)))
        if context == "id":
            self.input_task = nn.Parameter(
                torch.empty(len(schema.task_names), latent_dim)
            )
        elif context == "length":
            self.input_length = nn.Parameter(
                torch.empty(schema["length"].input_dim, latent_dim)
            )
        if fusion == "flat":
            self.emb_seq_pos = PositionEmbedding(
                latent_dim, schema.max_length * len(self.seq_columns) + 1,
                dropout,
            )
        elif fusion == "concat":
            self.fusion_fc = nn.Linear(len(self.seq_columns) * latent_dim,
                                       latent_dim)
            self.fusion_norm = nn.LayerNorm(latent_dim, eps=LAYER_NORM_EPS)
            self.fusion_dropout = FastDropout(dropout)
        if fusion not in ("flat", "none") and input_dtype != "set":
            self.input_const = PositionEmbedding(
                latent_dim, schema["length"].input_dim, dropout
            )
        if use_elemwise_noise:
            self.input_noise = nn.Linear(NOISE_SIZE, latent_dim)

    def _operand(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to the compute dtype and back to float32, where
        there is one: an operand of a bf16 product summed in float32."""
        return x if self.dtype is None else x.to(self.dtype).float()

    def _result(self, x: torch.Tensor) -> torch.Tensor:
        """A float32 sum rounded once to the compute dtype, if any."""
        return x if self.dtype is None else x.to(self.dtype)

    def _categorical(self, inputs, columns) -> torch.Tensor:
        """The sum over ``columns`` and their channels of the table rows
        of their ids, as one lookup in the concatenated tables (float32;
        rows rounded to the compute dtype first)."""
        tables = [self._operand(full(getattr(self, f"input_{c.name}")))
                  for c in columns]
        # One zero row after the tables takes every out-of-range id.
        table = torch.cat(tables + [tables[0].new_zeros(1, self.latent_dim)])
        rows = table.shape[0] - 1
        ids, offset = [], 0
        for c, t in zip(columns, tables):
            x = inputs[c.name].long()
            inside = (x >= 0) & (x < t.shape[0])
            ids.append(torch.where(inside, x + offset, rows))
            offset += t.shape[0]
        # F.embedding, not table[ids]: the backward of advanced indexing
        # (index_put with accumulate) walks duplicate ids one by one, and a
        # training batch repeats a few hundred rows ~10^5 times.
        return F.embedding(torch.cat(ids, dim=-1), table).sum(dim=-2)

    def _numerical(self, inputs, columns) -> torch.Tensor:
        """The sum over ``columns`` of ``normal * (x W + b) + is_masked *
        special[0] + is_unused * special[1]``, as one float32 matmul
        (operands rounded to the compute dtype first)."""
        feats, rows = [], []
        for c in columns:
            x = inputs[c.name]
            layer = getattr(self, f"input_{c.name}")
            special = getattr(self, f"input_{c.name}_special")
            is_masked = (x == MASK_VALUE).all(-1)
            is_unused = (x == NULL_VALUE).all(-1)
            normal = ~(is_masked | is_unused)
            feats.append(x * normal[..., None].to(x.dtype))
            feats.append(
                torch.stack([normal, is_masked, is_unused], -1).to(x.dtype)
            )
            rows.append(full(layer.weight).t())
            rows.append(torch.cat([layer.bias[None], full(special)]))
        return (self._operand(torch.cat(feats, -1))
                @ self._operand(torch.cat(rows)))

    def _column(self, inputs, column: ColumnSpec) -> torch.Tensor:
        """One column's embedding, ``(B, S, D)`` for a sequence column and
        ``(B, D)`` for a canvas one (encoder.py:151-180)."""
        if column.is_categorical:
            return self._result(self._categorical(inputs, [column]))
        x = inputs[column.name]
        layer = getattr(self, f"input_{column.name}")
        special = full(getattr(self, f"input_{column.name}_special"))
        h = dense(x, full(layer.weight), layer.bias, self.dtype)
        h = torch.where((x == MASK_VALUE).all(-1)[..., None], special[0], h)
        return torch.where((x == NULL_VALUE).all(-1)[..., None], special[1], h)

    def forward(self, inputs: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None,
                ) -> Tuple[Union[torch.Tensor, Dict[str, torch.Tensor]],
                           torch.Tensor]:
        """``(seq, seq_mask)`` (``seq`` a dict per field under fusion
        ``none``).  ``generator``: dropout of the position embeddings and of
        ``concat`` (none: off); ``noise``: the ``(B, S', 4)`` normal draw a
        ``use_elemwise_noise`` encoder needs."""
        max_length = self.schema.max_length
        b = inputs["length"].shape[0]
        seq_mask = get_seq_mask(inputs["length"], max_length)
        if self.fusion == "add":
            parts = []
            if self.cat_columns:
                parts.append(self._categorical(inputs, self.cat_columns))
            if self.num_columns:
                parts.append(self._numerical(inputs, self.num_columns))
            seq = self._result(sum(parts[1:], parts[0]))
        else:
            fields = [self._column(inputs, c) for c in self.seq_columns]
            if self.fusion == "none":
                return ({c.name: f for c, f in zip(self.seq_columns, fields)},
                        seq_mask)
            if self.fusion == "concat":
                seq = dense(torch.cat(fields, -1), self.fusion_fc.weight,
                            self.fusion_fc.bias, self.dtype)
                # flax's fusion_norm has no dtype: it computes in float32.
                seq = self.fusion_dropout(self.fusion_norm(seq.float()),
                                          generator)
            else:
                seq = torch.stack(fields, dim=2).reshape(b, -1,
                                                         self.latent_dim)
                seq_mask = seq_mask.repeat_interleave(len(fields), dim=1)
                seq = seq + self.emb_seq_pos(seq.shape[1], b, generator)

        canvas = None
        if self.canvas_columns:
            canvas = sum(self._column(inputs, c) for c in self.canvas_columns)
        if self.context == "canvas_add":
            seq = seq + canvas[:, None, :]
        elif self.context is not None:
            if self.context == "id":
                token = full(self.input_task)[
                    inputs["task"].reshape(-1).long()]
            elif self.context == "length":
                # Clamped like a jnp gather.
                length = inputs["length"].reshape(-1).long().clamp(
                    0, self.input_length.shape[0] - 1)
                token = full(self.input_length)[length]
            else:
                token = canvas
            seq = torch.cat([token[:, None], seq], dim=1)
            seq_mask = get_seq_mask(inputs["length"] + 1, max_length + 1)

        if hasattr(self, "input_const"):
            seq = seq + self.input_const(seq.shape[1], b, generator)
        if self.use_elemwise_noise:
            if noise is None:
                raise ValueError(
                    "use_elemwise_noise: the encoder needs its (B, S', "
                    f"{NOISE_SIZE}) normal draw, and none was given"
                )
            seq = seq + dense(noise.to(seq.dtype),
                              full(self.input_noise.weight),
                              self.input_noise.bias, self.dtype)
        return seq, seq_mask
