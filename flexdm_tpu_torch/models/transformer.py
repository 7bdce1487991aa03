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
wide with ReLU.  Cross-attention and the conditional input are used only
by the baselines; they are not in this port yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.rng import FastDropout

LAYER_NORM_EPS = 1e-3


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
                 lookahead: bool = True):
        super().__init__()
        if emb_size % num_heads != 0:
            raise ValueError(
                f"emb_size {emb_size} not divisible by num_heads {num_heads}"
            )
        self.num_heads = num_heads
        self.lookahead = lookahead
        self.query = nn.Linear(emb_size, emb_size)
        self.key = nn.Linear(emb_size, emb_size)
        self.value = nn.Linear(emb_size, emb_size)
        self.out = nn.Linear(emb_size, emb_size)

    def forward(self, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, d = x.shape
        h = self.num_heads
        projections = (self.query, self.key, self.value)
        qkv = F.linear(
            x,
            torch.cat([p.weight for p in projections]),
            torch.cat([p.bias for p in projections]),
        )
        # (B, S, 3, H, Dh) -> (3, B, H, S, Dh) in one copy; each of q, k, v
        # is then a contiguous (B, H, S, Dh) slice.
        q, k, v = (
            qkv.view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4).contiguous()
        )
        o = dot_product_attention(
            q, k, v, key_mask=key_mask, causal=not self.lookahead
        )
        return self.out(o.transpose(1, 2).reshape(b, s, d))


class _BlockBase(nn.Module):
    def __init__(self, emb_size: int = 64, num_heads: int = 8,
                 ff_dim: Optional[int] = None, dropout: float = 0.1,
                 lookahead: bool = True):
        super().__init__()
        ff_dim = ff_dim or 2 * emb_size
        self.attn = MultiHeadAttention(emb_size, num_heads, lookahead)
        self.norm1 = nn.LayerNorm(emb_size, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(emb_size, eps=LAYER_NORM_EPS)
        self.mlp_0 = nn.Linear(emb_size, ff_dim)
        self.mlp_1 = nn.Linear(ff_dim, emb_size)
        self.dropout = FastDropout(dropout)

    def _mlp(self, x):
        return self.mlp_1(F.relu(self.mlp_0(x)))


class TransformerBlock(_BlockBase):
    """Post-norm block (flexdm_tpu/models/transformer.py:180-193)."""

    def forward(self, x, key_mask=None, generator=None):
        x = self.norm1(x + self.dropout(self.attn(x, key_mask), generator))
        return self.norm2(x + self.dropout(self._mlp(x), generator))


class DeepSVGBlock(_BlockBase):
    """Pre-norm block, the default (transformer.py:196-210)."""

    def forward(self, x, key_mask=None, generator=None):
        x = x + self.dropout(self.attn(self.norm1(x), key_mask), generator)
        return x + self.dropout(self._mlp(self.norm2(x)), generator)


BLOCK_TYPES = {
    "transformer": TransformerBlock,
    "deepsvg": DeepSVGBlock,
}


class Blocks(nn.Module):
    """Stack of N blocks named ``seq2seq_{i}`` (transformer.py:219-252)."""

    def __init__(self, latent_dim: int = 128, num_blocks: int = 1,
                 block_type: str = "deepsvg", num_heads: int = 8,
                 lookahead: bool = True, dropout: float = 0.1):
        super().__init__()
        block_cls = BLOCK_TYPES[block_type]
        for i in range(num_blocks):
            self.add_module(f"seq2seq_{i}", block_cls(
                emb_size=latent_dim, num_heads=num_heads, dropout=dropout,
                lookahead=lookahead,
            ))

    def forward(self, seq, key_mask=None, generator=None):
        for block in self.children():
            seq = block(seq, key_mask, generator)
        return seq
