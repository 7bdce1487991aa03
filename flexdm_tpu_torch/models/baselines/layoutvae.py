"""LayoutVAE baseline: a per-attribute autoregressive conditional VAE
(PyTorch).

Counterpart of ``flexdm_tpu/models/baselines/layoutvae.py``.  Elements are
predicted one at a time.  At step ``i`` the transformer ``blocks`` read
the fixed-shape fusion ``where(pos < i, committed, inputs)`` of two
``(B, S, D)`` tensors, and position ``i`` of their output is the context
``c_i``.  Each attribute ``k`` then gets a latent (in training the
posterior ``encoder_cvae`` of its ground-truth embedding from
``encoder_gt``, in the deterministic forward the mean of the ``prior``),
and its CVAE decoder ``decoder_cvae`` turns ``(z, c_i)`` into a 64-wide
feature that the per-field heads of ``decoder`` (``detachment='none'``)
read.

* Training: ``committed`` is the ground truth (teacher forcing); the KL
  between posterior and prior, weighted by the mfp mask and ``kl``,
  averaged per attribute (``{k}_kl``) and summed (``kl_loss``), joins the
  loss.  Autograd keeps all S passes.
* Deterministic: step ``i`` decodes element ``i``, merges it with the
  inputs on the fields that are not masked, re-encodes it and writes it to
  slot ``i`` of ``committed`` (in place: a decode runs without autograd).

JAX runs both loops as an ``nn.scan`` (one compiled body); here they are
Python loops over the same shapes, S passes of ``num_blocks`` attention
forwards each.  Training draws the posterior's normals from ``vae`` and
the dropout masks from ``dropout`` step after step; the prior's own
normals, which nothing reads, are not drawn.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...data.schema import Schema
from ..decoder import Decoder
from ..encoder import Encoder
from ..transformer import Blocks
from .autoreg import next_embedding
from .cvae import FEATURE_DIM, MACVAEDecoder, MACVAEEncoder, MAPrior, \
    gaussian_kl

Tensors = Dict[str, torch.Tensor]


class LayoutVAE(nn.Module):
    """layoutvae.py:41-187."""

    is_autoreg = True

    def __init__(self, schema: Schema, latent_dim: int = 256,
                 num_blocks: int = 4, block_type: str = "deepsvg",
                 num_heads: int = 8, dropout: float = 0.1, kl: float = 1.0,
                 attention_impl: str = "auto"):
        super().__init__()
        self.schema = schema
        self.kl = kl
        self.attention_impl = attention_impl
        self.keys = tuple(c.name for c in schema.valid_columns())
        self.encoder = Encoder(schema, latent_dim, dropout=dropout)
        self.encoder_gt = Encoder(schema, latent_dim, dropout=dropout,
                                  fusion="none")
        self.blocks = Blocks(latent_dim, num_blocks, block_type, num_heads,
                             dropout=dropout, attention_impl=attention_impl)
        self.encoder_cvae = MACVAEEncoder(self.keys, latent_dim, latent_dim)
        self.decoder_cvae = MACVAEDecoder(self.keys, latent_dim)
        self.prior = MAPrior(self.keys, latent_dim)
        self.decoder = Decoder(schema, latent_dim, detachment="none",
                               in_dim=FEATURE_DIM)

    def forward(self, inputs: Tensors, targets: Optional[Tensors] = None,
                masks: Optional[Tensors] = None, deterministic: bool = True,
                dropout: Optional[torch.Generator] = None,
                vae: Optional[torch.Generator] = None
                ) -> Tuple[Tensors, Tensors]:
        if deterministic:
            dropout = None
        s = self.schema.max_length
        h_inputs, mask = self.encoder(inputs, dropout)
        pos = torch.arange(s, device=mask.device)[None, :, None]
        steps = []
        aux: Tensors = {}
        if not deterministic:
            h_targets = self.encoder(targets, dropout)[0]
            h_gts = self.encoder_gt(targets, dropout)[0]
            for i in range(s):
                h_fused = torch.where(pos < i, h_targets, h_inputs)
                c = self.blocks(h_fused, mask, dropout)[:, i:i + 1]
                zs = self.encoder_cvae(
                    {k: h_gts[k][:, i:i + 1] for k in self.keys}, c, False,
                    vae)
                zs_p = self.prior(c, True)
                feats = self.decoder_cvae({k: zs[k]["z"] for k in self.keys},
                                          c)
                steps.append((feats, zs, zs_p))
            kl_total = torch.zeros((), device=mask.device)
            for k in self.keys:
                def stat(which, name):
                    return torch.cat([st[which][k][name] for st in steps], 1)

                kl = gaussian_kl(stat(1, "z_mean"), stat(1, "z_log_sigma"),
                                 stat(2, "z_mean"), stat(2, "z_log_sigma"))
                kl = torch.mean(self.kl * kl * masks[k].to(torch.float32))
                aux[f"{k}_kl"] = kl  # a metric; summed into kl_loss
                kl_total = kl_total + kl
            aux["kl_loss"] = kl_total
        else:
            committed = torch.zeros_like(h_inputs)
            for i in range(s):
                h_fused = torch.where(pos < i, committed, h_inputs)
                c = self.blocks(h_fused, mask)[:, i:i + 1]
                zs = self.prior(c, True)
                feats = self.decoder_cvae({k: zs[k]["z"] for k in self.keys},
                                          c)
                committed[:, i:i + 1] = next_embedding(
                    self.schema, self.encoder, self.decoder(feats), inputs,
                    masks, i)
                steps.append((feats,))
        features = {k: torch.cat([st[0][k] for st in steps], 1)
                    for k in self.keys}
        return self.decoder(features), aux
