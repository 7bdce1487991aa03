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

``remat=True`` recomputes each block's activations in the backward
(``torch.utils.checkpoint``, non-reentrant), as JAX's ``nn.remat`` over
each block does: the forward kernel then runs twice a block per training
step.  The recomputation replays the block's dropout draws: its
``preserve_rng_state`` covers only the default CPU and CUDA generators,
not the explicit one the blocks draw from, so :func:`_remat_block` saves
that generator's state before the block, sets it back for the
recomputation and then restores the state the generator had.

The baselines add two things (transformer.py:80-149, :151-210):
cross-attention, ``MultiHeadAttention(x, key_mask, kv=memory)``, whose
queries come from ``x`` and keys and values from ``memory`` (the key and
value projections of ``memory`` are applied as one ``(D, 2D)`` matmul),
and conditional blocks (``conditional=True``), which add a ``conditional``
Dense of a per-document vector ``z`` to every token after the attention
residual (DeepSVG) or before a third LayerNorm ``norm3`` (post-norm).
:func:`masked_average_pool` is the mean over the valid tokens.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention
from ..ops.rng import FastDropout
from ..parallel.layers import (copy_to_model, gather_from_model,
                               row_parallel, split_of)

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


def mlp(x: torch.Tensor, mlp_0: nn.Linear, mlp_1: nn.Linear,
        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``mlp_1(relu(mlp_0(x)))``; tensor-parallel (split ``mlp_0`` and
    ``mlp_1``), column- then row-parallel: ``x`` enters the model group
    and the partial products are summed over it once."""
    split = split_of(mlp_0.weight)
    if split is not None:
        x = copy_to_model(x, split)
    h = F.relu(dense(x, mlp_0.weight, mlp_0.bias, dtype))
    if split_of(mlp_1.weight) is not None:
        return row_parallel(h, mlp_1.weight, mlp_1.bias, dtype)
    return dense(h, mlp_1.weight, mlp_1.bias, dtype)


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
    parameters (the flax layout) and are concatenated at apply time.  With
    ``kv`` (cross-attention) the queries are ``query(x)`` and the keys and
    values one fused ``(D, 2D)`` matmul of ``kv``; ``key_mask`` masks the
    keys of ``kv``, which must have the length of ``x`` (the kernels take
    one S)."""

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

    def _project(self, x: torch.Tensor, projections) -> torch.Tensor:
        """``x`` through ``projections`` as one matmul, split into heads:
        ``(len(projections), B, H, S, Dh)`` in one copy, so each slice is a
        contiguous ``(B, H, S, Dh)`` tensor.  Column-parallel (split
        projections), ``H`` is this rank's ``num_heads / M`` heads: the
        heads are contiguous in the output features, so a rank's slice is
        whole heads."""
        b, s, d = x.shape
        split = split_of(projections[0].weight)
        if split is not None:
            x = copy_to_model(x, split)
        width = projections[0].weight.shape[0]
        head_dim = d // self.num_heads
        out = dense(
            x,
            torch.cat([p.weight for p in projections]),
            torch.cat([p.bias for p in projections]),
            self.dtype,
        )
        return out.view(b, s, len(projections), width // head_dim,
                        head_dim).permute(2, 0, 3, 1, 4).contiguous()

    def forward(self, x: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, d = x.shape
        if kv is None:
            q, k, v = self._project(x, (self.query, self.key, self.value))
        else:
            if kv.shape != x.shape:
                raise ValueError(
                    f"cross-attention memory {tuple(kv.shape)} must have "
                    f"the shape of its queries {tuple(x.shape)}")
            q = self._project(x, (self.query,))[0]
            k, v = self._project(kv, (self.key, self.value))
        o = dot_product_attention(
            q, k, v, key_mask=key_mask, causal=not self.lookahead
        )
        o = o.transpose(1, 2).reshape(b, s, -1)
        if split_of(self.out.weight) is not None:
            return row_parallel(o, self.out.weight, self.out.bias, self.dtype)
        return dense(o, self.out.weight, self.out.bias, self.dtype)


class _BlockBase(nn.Module):
    def __init__(self, emb_size: int = 64, num_heads: int = 8,
                 ff_dim: Optional[int] = None, dropout: float = 0.1,
                 lookahead: bool = True, dtype: Optional[torch.dtype] = None,
                 conditional: bool = False):
        super().__init__()
        ff_dim = ff_dim or 2 * emb_size
        self.dtype = dtype
        self.attn = MultiHeadAttention(emb_size, num_heads, lookahead, dtype)
        self.norm1 = nn.LayerNorm(emb_size, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(emb_size, eps=LAYER_NORM_EPS)
        self.mlp_0 = nn.Linear(emb_size, ff_dim)
        self.mlp_1 = nn.Linear(ff_dim, emb_size)
        self.dropout = FastDropout(dropout)
        if conditional:
            self.conditional = nn.Linear(emb_size, emb_size)

    def _mlp(self, x):
        return mlp(x, self.mlp_0, self.mlp_1, self.dtype)

    def _norm(self, norm, x):
        return layer_norm(norm, x, self.dtype)

    def _condition(self, z):
        """``conditional(z)`` as a ``(B, 1, D)`` term of every token."""
        if z is None:
            raise ValueError("a conditional block needs z")
        split = split_of(self.conditional.weight)
        if split is None:
            return dense(z, self.conditional.weight, self.conditional.bias,
                         self.dtype)[:, None, :]
        # Column-parallel, the output features gathered.
        y = dense(copy_to_model(z, split), self.conditional.weight,
                  self.conditional.bias, self.dtype)
        return torch.cat(gather_from_model(y, split).unbind(0),
                         -1)[:, None, :]


class TransformerBlock(_BlockBase):
    """Post-norm block (flexdm_tpu/models/transformer.py:180-193)."""

    def __init__(self, emb_size: int = 64, *args, conditional: bool = False,
                 **kwargs):
        super().__init__(emb_size, *args, conditional=conditional, **kwargs)
        if conditional:
            self.norm3 = nn.LayerNorm(emb_size, eps=LAYER_NORM_EPS)

    def forward(self, x, key_mask=None, generator=None, z=None):
        x = self._norm(self.norm1,
                       x + self.dropout(self.attn(x, key_mask), generator))
        if hasattr(self, "conditional"):
            x = self._norm(self.norm3, x + self._condition(z))
        return self._norm(self.norm2,
                          x + self.dropout(self._mlp(x), generator))


class DeepSVGBlock(_BlockBase):
    """Pre-norm block, the default (transformer.py:196-210)."""

    def forward(self, x, key_mask=None, generator=None, z=None):
        y = self.attn(self._norm(self.norm1, x), key_mask)
        x = x + self.dropout(y, generator)
        if hasattr(self, "conditional"):
            x = x + self._condition(z)
        return x + self.dropout(self._mlp(self._norm(self.norm2, x)),
                                generator)


BLOCK_TYPES = {
    "transformer": TransformerBlock,
    "deepsvg": DeepSVGBlock,
}


def _remat_block(block: nn.Module, seq: torch.Tensor,
                 key_mask: Optional[torch.Tensor],
                 generator: Optional[torch.Generator],
                 z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``block(seq, key_mask, generator, z)`` under ``torch.utils.checkpoint``,
    its recomputation drawing the same dropout masks as its forward.  The
    recomputation may stop early, by an exception, once it has rebuilt the
    saved tensors: the generator's state is restored in a ``finally``."""
    start = None if generator is None else generator.get_state()
    calls = []

    def run(x, mask, z):
        if start is None or not calls:  # the forward
            calls.append(True)
            return block(x, mask, generator, z)
        resume = generator.get_state()  # the recomputation: replay
        generator.set_state(start)
        try:
            return block(x, mask, generator, z)
        finally:
            generator.set_state(resume)

    return checkpoint(run, seq, key_mask, z, use_reentrant=False,
                      preserve_rng_state=False)


class Blocks(nn.Module):
    """Stack of N blocks named ``seq2seq_{i}`` (transformer.py:219-252);
    ``remat`` recomputes each block in the backward; ``conditional`` blocks
    take the ``(B, D)`` vector ``z``."""

    def __init__(self, latent_dim: int = 128, num_blocks: int = 1,
                 block_type: str = "deepsvg", num_heads: int = 8,
                 lookahead: bool = True, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, remat: bool = False,
                 conditional: bool = False):
        super().__init__()
        self.remat = remat
        block_cls = BLOCK_TYPES[block_type]
        for i in range(num_blocks):
            self.add_module(f"seq2seq_{i}", block_cls(
                emb_size=latent_dim, num_heads=num_heads, dropout=dropout,
                lookahead=lookahead, dtype=dtype, conditional=conditional,
            ))

    def forward(self, seq, key_mask=None, generator=None, z=None):
        remat = self.remat and torch.is_grad_enabled()
        for block in self.children():
            if remat:
                seq = _remat_block(block, seq, key_mask, generator, z)
            else:
                seq = block(seq, key_mask, generator, z)
        return seq


def masked_average_pool(seq: torch.Tensor,
                        key_mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``seq`` (B, S, D) over the valid positions of ``key_mask``
    (B, S); a row with none divides by 1 (transformer.py:255-258)."""
    w = key_mask.to(seq.dtype)[..., None]
    return (seq * w).sum(1) / w.sum(1).clamp_min(1.0)
