"""Baseline model families (PyTorch): CanvasVAE, LayoutVAE, AutoReg and
BART, counterparts of ``flexdm_tpu/models/baselines``.

Each takes ``(inputs, targets, masks, deterministic, dropout, vae)`` and
returns ``(outputs, aux)``: the per-field predictions and the auxiliary
losses and metrics (``kl_loss``, ``length_loss``, ``kl_divergence``,
``{field}_kl``).  They compute in float32.
"""

from .autoreg import BART, AutoReg, CrossBlock, CrossBlocks
from .canvasvae import CanvasVAE
from .cvae import (
    Head,
    MACVAEDecoder,
    MACVAEEncoder,
    MAPrior,
    Prior,
    VAEDecoder,
    VAEEncoder,
    gaussian_kl,
)
from .layoutvae import LayoutVAE

__all__ = [
    "AutoReg",
    "BART",
    "CanvasVAE",
    "CrossBlock",
    "CrossBlocks",
    "Head",
    "LayoutVAE",
    "MACVAEDecoder",
    "MACVAEEncoder",
    "MAPrior",
    "Prior",
    "VAEDecoder",
    "VAEEncoder",
    "gaussian_kl",
]
