"""Autoregressive element decoders: AutoReg and BART (PyTorch).

Counterpart of ``flexdm_tpu/models/baselines/autoreg.py``.  Both predict
the elements left to right from a learned BOS embedding ``bos``: training
is teacher-forced (``[bos, gt_1 .. gt_{S-1}]`` predicts ``[e_1 .. e_S]``
in one causal pass); the deterministic forward (evaluation, validation,
serving) decodes element by element.

The decode keeps JAX's static ``(B, S, D)`` buffer: slot 0 holds ``bos``,
and step ``t`` runs the whole causal stack over the buffer, decodes
position ``t``, merges the prediction with the ground truth on the fields
that are not masked, re-encodes that element and writes it to slot
``t + 1`` (in place, where JAX used ``dynamic_update_slice`` inside an
``nn.scan``).  The causal attention keeps the slots after ``t`` (zeros, or
nothing yet) out of step ``t``.  A decode runs ``S - 1`` steps and one
final pass: AutoReg launches the attention forward ``S * num_blocks``
times per forward, BART ``S * num_blocks + enc_blocks`` times (its
decoder blocks attend twice each).

:class:`CrossBlock` is JAX's working pre-norm decoder block: causal
self-attention, cross-attention over the encoder memory (same length S),
MLP.  Dropout draws from the ``dropout`` generator (None: off).

Tensor-parallel (JAX's partition rules, :mod:`...parallel.mesh`), both
attentions split their heads and the MLP is column- then row-parallel
(:func:`..transformer.mlp`); the encoder memory, whole on every model
rank, enters the model group as the cross-attention's ``kv`` through
``copy_to_model``, so its gradient is summed over the group.  The decode
runs in lockstep on every model rank: each step makes the same
collectives (the blocks', the decoder heads' gather, the encoder's
gathered tables) in the same order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...data.schema import Schema
from ...ops.rng import FastDropout
from ..decoder import Decoder
from ..encoder import Encoder
from ..masking import get_seq_mask
from ..transformer import LAYER_NORM_EPS, Blocks, MultiHeadAttention, mlp

Tensors = Dict[str, torch.Tensor]


class CrossBlock(nn.Module):
    """Pre-norm decoder block: causal self-attention, cross-attention over
    ``memory``, MLP (autoreg.py:45-72); tensor-parallel as the module
    docstring says."""

    def __init__(self, emb_size: int, num_heads: int = 8,
                 dropout: float = 0.1, attention_impl: str = "auto"):
        super().__init__()
        self.norm1 = nn.LayerNorm(emb_size, eps=LAYER_NORM_EPS)
        self.self_attn = MultiHeadAttention(emb_size, num_heads,
                                            lookahead=False,
                                            attention_impl=attention_impl)
        self.norm2 = nn.LayerNorm(emb_size, eps=LAYER_NORM_EPS)
        self.cross_attn = MultiHeadAttention(emb_size, num_heads,
                                             attention_impl=attention_impl)
        self.norm3 = nn.LayerNorm(emb_size, eps=LAYER_NORM_EPS)
        self.mlp_0 = nn.Linear(emb_size, 2 * emb_size)
        self.mlp_1 = nn.Linear(2 * emb_size, emb_size)
        self.dropout = FastDropout(dropout)

    def forward(self, x, memory, tgt_mask, memory_mask, generator=None):
        x = x + self.dropout(self.self_attn(self.norm1(x), tgt_mask),
                             generator)
        x = x + self.dropout(
            self.cross_attn(self.norm2(x), memory_mask, kv=memory), generator)
        return x + self.dropout(mlp(self.norm3(x), self.mlp_0, self.mlp_1),
                                generator)


class CrossBlocks(nn.Module):
    """``num_blocks`` :class:`CrossBlock` named ``cross_{i}``
    (autoreg.py:75-92)."""

    def __init__(self, latent_dim: int, num_blocks: int = 2,
                 num_heads: int = 8, dropout: float = 0.1,
                 attention_impl: str = "auto"):
        super().__init__()
        for i in range(num_blocks):
            self.add_module(f"cross_{i}",
                            CrossBlock(latent_dim, num_heads, dropout,
                                       attention_impl))

    def forward(self, x, memory, tgt_mask, memory_mask, generator=None):
        for block in self.children():
            x = block(x, memory, tgt_mask, memory_mask, generator)
        return x


def next_embedding(schema: Schema, encoder: Encoder, outputs_t: Tensors,
                   inputs: Tensors, masks: Tensors, t: int) -> torch.Tensor:
    """Element ``t`` committed and re-encoded, ``(B, 1, D)``: the decoded
    fields ``outputs_t`` (categorical ones argmaxed) where ``masks`` masks
    them, the inputs elsewhere (autoreg.py:126-153)."""
    new_inputs: Tensors = {}
    for c in schema.modeled:
        if not c.is_sequence:
            continue
        x = inputs[c.name][:, t:t + 1]
        out = outputs_t[c.name][:, :1]
        if c.is_categorical:
            out = out.argmax(-1).to(x.dtype)
        new_inputs[c.name] = torch.where(masks[c.name][:, t:t + 1, None],
                                         out, x)
    b = x.shape[0]
    new_inputs["length"] = torch.zeros((b, 1), dtype=torch.int32,
                                       device=x.device)
    return encoder(new_inputs)[0]


class _ARBase(nn.Module):
    """The encoder, the decoder heads and ``bos`` (autoreg.py:95-124)."""

    # Autoregressive models shuffle their inputs and elem-mask the LAST
    # element in training.
    is_autoreg = True

    def __init__(self, schema: Schema, latent_dim: int = 256,
                 num_blocks: int = 4, block_type: str = "deepsvg",
                 num_heads: int = 8, dropout: float = 0.1,
                 input_dtype: str = "shuffled_set",
                 attention_impl: str = "auto"):
        super().__init__()
        self.schema = schema
        self.latent_dim = latent_dim
        self.input_dtype = input_dtype
        self.attention_impl = attention_impl
        self.encoder = Encoder(schema, latent_dim, input_dtype=input_dtype,
                               dropout=dropout)
        self.decoder = Decoder(schema, latent_dim)
        self.bos = nn.Parameter(torch.empty(1, 1, latent_dim))

    def _teacher_forced(self, targets: Tensors, generator) -> torch.Tensor:
        """``[bos, gt_1 .. gt_{S-1}]``: the training stack's input."""
        h_tgt = self.encoder(targets, generator)[0]
        bos = self.bos.expand(h_tgt.shape[0], 1, -1)
        return torch.cat([bos, h_tgt[:, :-1]], 1)

    def _decode(self, stack, inputs: Tensors, masks: Tensors) -> Tensors:
        """The sequential decode over the static buffer, written in place
        (a decode runs without autograd); ``stack(buf)`` is the causal
        transformer."""
        b = inputs["length"].shape[0]
        s = self.schema.max_length
        buf = torch.zeros((b, s, self.latent_dim), dtype=self.bos.dtype,
                          device=self.bos.device)
        buf[:, :1] = self.bos
        for t in range(s - 1):
            h_t = stack(buf)[:, t:t + 1]
            buf[:, t + 1:t + 2] = next_embedding(
                self.schema, self.encoder, self.decoder(h_t), inputs, masks,
                t)
        return self.decoder(stack(buf))


class AutoReg(_ARBase):
    """Causal transformer over element embeddings (autoreg.py:156-216)."""

    def __init__(self, schema: Schema, latent_dim: int = 256,
                 num_blocks: int = 4, block_type: str = "deepsvg",
                 num_heads: int = 8, dropout: float = 0.1,
                 input_dtype: str = "shuffled_set",
                 attention_impl: str = "auto"):
        super().__init__(schema, latent_dim, num_blocks, block_type,
                         num_heads, dropout, input_dtype, attention_impl)
        self.blocks = Blocks(latent_dim, num_blocks, block_type, num_heads,
                             lookahead=False, dropout=dropout,
                             attention_impl=attention_impl)

    def forward(self, inputs: Tensors, targets: Tensors, masks: Tensors,
                deterministic: bool = True,
                dropout: Optional[torch.Generator] = None,
                vae: Optional[torch.Generator] = None
                ) -> Tuple[Tensors, Tensors]:
        if deterministic:
            dropout = None
        mask = get_seq_mask(inputs["length"], self.schema.max_length)
        if not deterministic:
            h = self.blocks(self._teacher_forced(targets, dropout), mask,
                            dropout)
            return self.decoder(h), {}
        return self._decode(lambda buf: self.blocks(buf, mask), inputs,
                            masks), {}


class BART(_ARBase):
    """Bidirectional encoder over the masked set, causal cross-attention
    decoder (autoreg.py:219-284)."""

    def __init__(self, schema: Schema, latent_dim: int = 256,
                 num_blocks: int = 4, block_type: str = "deepsvg",
                 num_heads: int = 8, dropout: float = 0.1,
                 input_dtype: str = "shuffled_set",
                 attention_impl: str = "auto"):
        super().__init__(schema, latent_dim, num_blocks, block_type,
                         num_heads, dropout, input_dtype, attention_impl)
        half = max(num_blocks // 2, 1)
        self.enc_blocks = Blocks(latent_dim, half, block_type, num_heads,
                                 dropout=dropout,
                                 attention_impl=attention_impl)
        self.dec_blocks = CrossBlocks(latent_dim, half, num_heads, dropout,
                                      attention_impl)

    def forward(self, inputs: Tensors, targets: Tensors, masks: Tensors,
                deterministic: bool = True,
                dropout: Optional[torch.Generator] = None,
                vae: Optional[torch.Generator] = None
                ) -> Tuple[Tensors, Tensors]:
        if deterministic:
            dropout = None
        h_masked, mask = self.encoder(inputs, dropout)
        memory = self.enc_blocks(h_masked, mask, dropout)
        if not deterministic:
            h = self.dec_blocks(self._teacher_forced(targets, dropout),
                                memory, mask, mask, dropout)
            return self.decoder(h), {}
        return self._decode(
            lambda buf: self.dec_blocks(buf, memory, mask, mask), inputs,
            masks), {}
