"""Dropout whose keep mask comes from an explicit generator.

Counterpart of ``FastDropout`` in ``flexdm_tpu/ops/rng.py``: inverted
dropout (keep with probability ``1 - rate``, survivors scaled by
``1 / (1 - rate)``).  The JAX module draws its mask from the ``"dropout"``
rng collection; here the caller passes the ``torch.Generator`` (on the
tensor's device) that the mask is drawn from, and passing none turns
dropout off, as ``deterministic=True`` does in JAX.  The global RNG is
never read.  The TPU's ``rbg`` key conversion is not ported: the draws
differ from JAX's in any case, so tests hand both packages the same masks
or turn dropout off.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class FastDropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        draw = torch.rand(x.shape, generator=generator, device=x.device)
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))
