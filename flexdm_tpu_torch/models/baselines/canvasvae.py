"""CanvasVAE baseline: a document-level VAE (PyTorch).

Counterpart of ``flexdm_tpu/models/baselines/canvasvae.py``: encode the
sorted document behind a length-context token, run the conditional
``enc_blocks`` (conditioned on that token), pool the valid elements into
the reparameterised latent ``z`` (``prior_head``, with its KL), predict
the length from ``z`` (``length_fc``), and decode the element set from the
learned position table ``embedding_const`` through the conditional
``blocks`` (conditioned on ``z``).

JAX's two deliberate deviations from the TF reference stay: the
transformed sequence is pooled (the reference pooled the untransformed
embeddings), and the norm before pooling is a LayerNorm (``pool_norm``),
not BatchNorm.

Training decodes the ground-truth number of elements and adds
``length_loss`` (the length's cross-entropy) and ``kl_loss`` (``kl`` times
``kl_divergence``) to ``aux``; the deterministic forward decodes
``argmax(length_logits) + 1`` elements with ``z`` the posterior mean.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...data.schema import Schema
from ..decoder import Decoder
from ..encoder import Encoder
from ..masking import get_seq_mask
from ..transformer import (
    LAYER_NORM_EPS,
    Blocks,
    PositionEmbedding,
    masked_average_pool,
)
from .cvae import Head

Tensors = Dict[str, torch.Tensor]


class CanvasVAE(nn.Module):
    """canvasvae.py:42-131."""

    def __init__(self, schema: Schema, latent_dim: int = 256,
                 num_blocks: int = 4, block_type: str = "deepsvg",
                 num_heads: int = 8, dropout: float = 0.1, kl: float = 1.0,
                 input_dtype: str = "sorted_set",
                 attention_impl: str = "auto"):
        super().__init__()
        self.schema = schema
        self.kl = kl
        self.input_dtype = input_dtype
        self.attention_impl = attention_impl
        half = max(num_blocks // 2, 1)
        length_dim = schema["length"].input_dim
        self.encoder = Encoder(schema, latent_dim, context="length",
                               input_dtype="sorted_set", dropout=dropout)
        self.enc_blocks = Blocks(latent_dim, half, block_type, num_heads,
                                 dropout=dropout, conditional=True,
                                 attention_impl=attention_impl)
        self.pool_norm = nn.LayerNorm(latent_dim, eps=LAYER_NORM_EPS)
        self.prior_head = Head(latent_dim, latent_dim, compute_kl=True)
        self.length_fc = nn.Linear(latent_dim, length_dim)
        self.embedding_const = PositionEmbedding(latent_dim, length_dim,
                                                 dropout)
        self.blocks = Blocks(latent_dim, half, block_type, num_heads,
                             dropout=dropout, conditional=True,
                             attention_impl=attention_impl)
        self.decoder = Decoder(schema, latent_dim)

    def forward(self, inputs: Tensors, targets: Optional[Tensors] = None,
                masks: Optional[Tensors] = None, deterministic: bool = True,
                dropout: Optional[torch.Generator] = None,
                vae: Optional[torch.Generator] = None
                ) -> Tuple[Tensors, Tensors]:
        if deterministic:
            dropout = None
        aux: Tensors = {}
        h, enc_mask = self.encoder(inputs, dropout)
        # The kernels take a contiguous key mask.
        canvas, sequence = h[:, 0], h[:, 1:]
        seq_valid = enc_mask[:, 1:].contiguous()
        h_enc = self.enc_blocks(sequence, seq_valid, dropout, z=canvas)
        pooled = masked_average_pool(F.relu(self.pool_norm(h_enc)),
                                     seq_valid)
        z_out, kl_aux = self.prior_head(pooled, deterministic, vae)
        z = z_out["z"]
        if "kl_divergence" in kl_aux:
            aux["kl_divergence"] = kl_aux["kl_divergence"]
            aux["kl_loss"] = self.kl * kl_aux["kl_divergence"]

        length_logits = self.length_fc(z)
        s = self.schema.max_length
        if deterministic:
            mask = get_seq_mask(length_logits.argmax(-1)[:, None], s)
        else:
            labels = inputs["length"].reshape(-1).long()
            log_probs = F.log_softmax(length_logits, -1).gather(
                -1, labels[:, None])
            aux["length_loss"] = -log_probs.mean()
            mask = get_seq_mask(inputs["length"], s)

        b = mask.shape[0]
        sequence = self.embedding_const(s, b, dropout)
        h_dec = self.blocks(sequence, mask, dropout, z=z)
        return self.decoder(h_dec), aux
