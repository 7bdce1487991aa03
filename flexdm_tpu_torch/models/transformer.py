"""Transformer building blocks (PyTorch).

Counterpart of ``flexdm_tpu/models/transformer.py``: multi-head
self-attention with a fused QKV projection, the post-norm
``TransformerBlock``, the pre-norm ``DeepSVGBlock`` (the default), the
``Blocks`` stack and the learned ``PositionEmbedding``.  Parameter names
follow the flax tree (``attn.query``, ``norm1``, ``mlp_0``,
``seq2seq_{i}``, ...) so the weight bridge in
:mod:`flexdm_tpu_torch.convert` maps leaves one to one.

Dropout sits where the JAX blocks put ``FastDropout`` (after attention and
after the MLP) and draws from the ``generator`` passed down the stack; with
no generator it is off (JAX ``deterministic=True``).

LayerNorm epsilon is 1e-3 (keras), not PyTorch's 1e-5; the MLP is ``2 * D``
wide with ReLU.

``dtype`` (None or ``torch.bfloat16``) is the compute dtype of flax's
``dtype=`` (``--dtype bfloat16``); parameters stay float32.  A Dense layer
casts its input, kernel and bias to it at apply time (:func:`dense`), as
``nn.Dense(dtype=...)`` does; a LayerNorm normalises in float32 and casts
only its output (:func:`layer_norm`), as flax's does.  Everything else
follows PyTorch's promotion (bf16 + float32 -> float32), which is JAX's.

Cross-attention and the conditional input are used only by the
baselines; they are not in this port yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.rng import FastDropout

LAYER_NORM_EPS = 1e-3


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x W^T + b``, with ``x``, ``W`` and ``b`` cast to ``dtype`` first
    when one is given (flax ``nn.Dense(dtype=...)``)."""
    if dtype is not None:
        x, weight, bias = x.to(dtype), weight.to(dtype), bias.to(dtype)
    return F.linear(x, weight, bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``norm(x)``; with ``dtype``, statistics and affine map in float32 and
    the result cast to ``dtype`` (flax ``nn.LayerNorm(dtype=...)``)."""
    if dtype is None:
        return norm(x)
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(dtype)


class PositionEmbedding(nn.Module):
    """Learned ``(maxlen + 1, D)`` position table, broadcast over the batch,
    then dropout on the caller's generator (transformer.py:63-77)."""

    def __init__(self, output_dim: int, maxlen: int, dropout: float = 0.1):
        super().__init__()
        self.embeddings = nn.Parameter(torch.empty(maxlen + 1, output_dim))
        self.dropout = FastDropout(dropout)

    def forward(self, seq_len: int, batch: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        emb = self.embeddings[None, :seq_len].expand(batch, -1, -1)
        return self.dropout(emb, generator)


class MultiHeadAttention(nn.Module):
    """Self-attention: one fused ``(D, 3D)`` QKV matmul, the attention core,
    then the ``out`` projection.  ``query``/``key``/``value`` stay separate
    parameters (the flax layout) and are concatenated at apply time."""

    def __init__(self, emb_size: int, num_heads: int = 8,
                 lookahead: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if emb_size % num_heads != 0:
            raise ValueError(
                f"emb_size {emb_size} not divisible by num_heads {num_heads}"
            )
        self.num_heads = num_heads
        self.lookahead = lookahead
        self.dtype = dtype
        self.query = nn.Linear(emb_size, emb_size)
        self.key = nn.Linear(emb_size, emb_size)
        self.value = nn.Linear(emb_size, emb_size)
        self.out = nn.Linear(emb_size, emb_size)

    def forward(self, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, d = x.shape
        h = self.num_heads
        projections = (self.query, self.key, self.value)
        qkv = dense(
            x,
            torch.cat([p.weight for p in projections]),
            torch.cat([p.bias for p in projections]),
            self.dtype,
        )
        # (B, S, 3, H, Dh) -> (3, B, H, S, Dh) in one copy; each of q, k, v
        # is then a contiguous (B, H, S, Dh) slice.
        q, k, v = (
            qkv.view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4).contiguous()
        )
        o = dot_product_attention(
            q, k, v, key_mask=key_mask, causal=not self.lookahead
        )
        return dense(o.transpose(1, 2).reshape(b, s, d), self.out.weight,
                     self.out.bias, self.dtype)


class _BlockBase(nn.Module):
    def __init__(self, emb_size: int = 64, num_heads: int = 8,
                 ff_dim: Optional[int] = None, dropout: float = 0.1,
                 lookahead: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        ff_dim = ff_dim or 2 * emb_size
        self.dtype = dtype
        self.attn = MultiHeadAttention(emb_size, num_heads, lookahead, dtype)
        self.norm1 = nn.LayerNorm(emb_size, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(emb_size, eps=LAYER_NORM_EPS)
        self.mlp_0 = nn.Linear(emb_size, ff_dim)
        self.mlp_1 = nn.Linear(ff_dim, emb_size)
        self.dropout = FastDropout(dropout)

    def _mlp(self, x):
        h = F.relu(dense(x, self.mlp_0.weight, self.mlp_0.bias, self.dtype))
        return dense(h, self.mlp_1.weight, self.mlp_1.bias, self.dtype)

    def _norm(self, norm, x):
        return layer_norm(norm, x, self.dtype)


class TransformerBlock(_BlockBase):
    """Post-norm block (flexdm_tpu/models/transformer.py:180-193)."""

    def forward(self, x, key_mask=None, generator=None):
        x = self._norm(self.norm1,
                       x + self.dropout(self.attn(x, key_mask), generator))
        return self._norm(self.norm2,
                          x + self.dropout(self._mlp(x), generator))


class DeepSVGBlock(_BlockBase):
    """Pre-norm block, the default (transformer.py:196-210)."""

    def forward(self, x, key_mask=None, generator=None):
        y = self.attn(self._norm(self.norm1, x), key_mask)
        x = x + self.dropout(y, generator)
        return x + self.dropout(self._mlp(self._norm(self.norm2, x)),
                                generator)


BLOCK_TYPES = {
    "transformer": TransformerBlock,
    "deepsvg": DeepSVGBlock,
}


class Blocks(nn.Module):
    """Stack of N blocks named ``seq2seq_{i}`` (transformer.py:219-252)."""

    def __init__(self, latent_dim: int = 128, num_blocks: int = 1,
                 block_type: str = "deepsvg", num_heads: int = 8,
                 lookahead: bool = True, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        block_cls = BLOCK_TYPES[block_type]
        for i in range(num_blocks):
            self.add_module(f"seq2seq_{i}", block_cls(
                emb_size=latent_dim, num_heads=num_heads, dropout=dropout,
                lookahead=lookahead, dtype=dtype,
            ))

    def forward(self, seq, key_mask=None, generator=None):
        for block in self.children():
            seq = block(seq, key_mask, generator)
        return seq
