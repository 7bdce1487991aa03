"""Conditional-VAE building blocks of the baselines (PyTorch).

Counterpart of ``flexdm_tpu/models/baselines/cvae.py``: the
reparameterised :class:`Head`, the :class:`Prior`, :class:`VAEEncoder` and
:class:`VAEDecoder` stacks, their per-attribute ``MA*`` wrappers and
:func:`gaussian_kl`.  Modules return ``(z-dict, aux)`` where ``aux``
carries the KL terms the loss sums, as in JAX.

Layer widths are the JAX package's defaults, which flax's lazy shapes
leave implicit and which are written out here: ``Head`` and ``Prior`` are
32 wide, ``VAEEncoder`` is ``fc1: D -> 128``, ``fc2: 128 + D -> 32``,
``VAEDecoder`` is ``fc1: 32 + D -> 128``, ``fc2: 128 -> 64`` (``D`` the
width of the context, the transformer's latent).

Randomness: a Head in training (``deterministic=False``) adds
``exp(0.5 log_sigma) * eps`` to its mean; ``eps`` are standard normals
drawn from the ``vae`` generator on that generator's device and moved to
the model's, so the same generator gives the same noise on the CPU and on
a card.  ``vae=None`` makes ``eps`` zero.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.rng import normal

Tensors = Dict[str, torch.Tensor]

HEAD_DIM = 32  # Head / Prior latent_dim, VAEEncoder dim_out
HIDDEN_DIM = 128  # VAEEncoder dim_in, VAEDecoder hidden_dim
FEATURE_DIM = 64  # VAEDecoder out_dim


def normal_like(x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard normals shaped like ``x`` from ``generator`` (on its
    device), on ``x``'s device; zeros without a generator."""
    if generator is None:
        return torch.zeros_like(x)
    return normal(x.shape, generator, generator.device).to(x.device)


class Head(nn.Module):
    """``fc_mean`` / ``fc_log_sigma`` and the reparameterisation
    (cvae.py:24-47); ``compute_kl`` adds ``kl_divergence`` (the mean KL to
    N(0, 1)) to ``aux`` in training."""

    def __init__(self, in_dim: int, latent_dim: int = HEAD_DIM,
                 compute_kl: bool = False):
        super().__init__()
        self.compute_kl = compute_kl
        self.fc_mean = nn.Linear(in_dim, latent_dim)
        self.fc_log_sigma = nn.Linear(in_dim, latent_dim)

    def forward(self, h: torch.Tensor, deterministic: bool = True,
                vae: Optional[torch.Generator] = None
                ) -> Tuple[Tensors, Tensors]:
        z_mean = self.fc_mean(h)
        z_log_sigma = self.fc_log_sigma(h)
        if deterministic:
            z = z_mean
        else:
            z = z_mean + torch.exp(0.5 * z_log_sigma) * normal_like(
                z_log_sigma, vae)
        aux: Tensors = {}
        if self.compute_kl and not deterministic:
            aux["kl_divergence"] = -0.5 * torch.mean(
                1.0 + z_log_sigma - z_mean.square() - torch.exp(z_log_sigma))
        return {"z": z, "z_mean": z_mean, "z_log_sigma": z_log_sigma}, aux


class Prior(nn.Module):
    """relu Dense ``fc`` -> :class:`Head` (cvae.py:50-59)."""

    def __init__(self, in_dim: int, latent_dim: int = HEAD_DIM):
        super().__init__()
        self.fc = nn.Linear(in_dim, latent_dim)
        self.head = Head(latent_dim, latent_dim)

    def forward(self, h, deterministic: bool = True, vae=None) -> Tensors:
        return self.head(F.relu(self.fc(h)), deterministic, vae)[0]


class VAEEncoder(nn.Module):
    """Posterior of one attribute from its ground-truth embedding and the
    context (cvae.py:62-75)."""

    def __init__(self, hidden_in: int, context_dim: int,
                 dim_in: int = HIDDEN_DIM, dim_out: int = HEAD_DIM):
        super().__init__()
        self.fc1 = nn.Linear(hidden_in, dim_in)
        self.fc2 = nn.Linear(dim_in + context_dim, dim_out)
        self.head = Head(dim_out)

    def forward(self, hidden, context, deterministic: bool = True,
                vae=None) -> Tensors:
        h = torch.cat([self.fc1(hidden), context], -1)
        return self.head(F.relu(self.fc2(h)), deterministic, vae)[0]


class VAEDecoder(nn.Module):
    """``(z, context)`` -> the attribute's feature (cvae.py:78-88)."""

    def __init__(self, z_dim: int, context_dim: int,
                 hidden_dim: int = HIDDEN_DIM, out_dim: int = FEATURE_DIM):
        super().__init__()
        self.fc1 = nn.Linear(z_dim + context_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, z, context) -> torch.Tensor:
        h = F.relu(self.fc1(torch.cat([z, context], -1)))
        return F.relu(self.fc2(h))


class MAPrior(nn.Module):
    """A :class:`Prior` ``prior_{k}`` per attribute (cvae.py:91-101)."""

    def __init__(self, keys: Sequence[str], context_dim: int):
        super().__init__()
        self.keys = tuple(keys)
        for k in self.keys:
            self.add_module(f"prior_{k}", Prior(context_dim))

    def forward(self, context, deterministic: bool = True,
                vae=None) -> Dict[str, Tensors]:
        return {k: getattr(self, f"prior_{k}")(context, deterministic, vae)
                for k in self.keys}


class MACVAEEncoder(nn.Module):
    """A :class:`VAEEncoder` ``enc_{k}`` per attribute (cvae.py:104-114)."""

    def __init__(self, keys: Sequence[str], hidden_in: int,
                 context_dim: int):
        super().__init__()
        self.keys = tuple(keys)
        for k in self.keys:
            self.add_module(f"enc_{k}", VAEEncoder(hidden_in, context_dim))

    def forward(self, h_gts: Tensors, context, deterministic: bool = True,
                vae=None) -> Dict[str, Tensors]:
        return {k: getattr(self, f"enc_{k}")(h_gts[k], context,
                                              deterministic, vae)
                for k in self.keys}


class MACVAEDecoder(nn.Module):
    """A :class:`VAEDecoder` ``dec_{k}`` per attribute (cvae.py:117-127)."""

    def __init__(self, keys: Sequence[str], context_dim: int,
                 z_dim: int = HEAD_DIM):
        super().__init__()
        self.keys = tuple(keys)
        for k in self.keys:
            self.add_module(f"dec_{k}", VAEDecoder(z_dim, context_dim))

    def forward(self, zs: Tensors, context) -> Tensors:
        return {k: getattr(self, f"dec_{k}")(zs[k], context)
                for k in self.keys}


def gaussian_kl(mean_q: torch.Tensor, log_sigma_q: torch.Tensor,
                mean_p: torch.Tensor, log_sigma_p: torch.Tensor
                ) -> torch.Tensor:
    """KL(q || p) of diagonal Gaussians with variances ``exp(log_sigma)``,
    summed over the last axis (cvae.py:130-149)."""
    var_q = torch.exp(log_sigma_q)
    var_p = torch.exp(log_sigma_p)
    return 0.5 * torch.sum(
        (var_q + (mean_q - mean_p).square()) / var_p
        + log_sigma_p - log_sigma_q - 1.0,
        dim=-1,
    )
