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

Data-parallel, every rank draws the masks of the *global* batch and keeps
its rows: the trainer passes a :class:`BatchRows` in place of the
generator, and :func:`uniform` / :func:`normal` draw through it.  The
ranks' generators then stay in lockstep, and a data-parallel step draws
what the single-process step of the same global batch draws.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn


class BatchRows:
    """``generator``, drawn for a global batch of ``batch`` rows of which
    the caller keeps ``rows`` (a slice): :func:`uniform` and :func:`normal`
    draw the whole batch's numbers and return the rows.  ``device``,
    ``get_state`` and ``set_state`` are the generator's."""

    def __init__(self, generator: torch.Generator, rows: slice, batch: int):
        self.generator = generator
        self.rows = rows
        self.batch = batch

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)

    def draw(self, fn, shape: Sequence[int], device) -> torch.Tensor:
        n = self.rows.stop - self.rows.start
        if shape[0] != n:
            raise ValueError(f"a draw of {shape[0]} rows from a generator "
                             f"that keeps {n} of {self.batch}")
        whole = fn((self.batch,) + tuple(shape[1:]),
                   generator=self.generator, device=device)
        return whole[self.rows]


Generator = Union[torch.Generator, BatchRows]


def uniform(shape: Sequence[int], generator: Generator,
            device=None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator`` (or its rows)."""
    if isinstance(generator, BatchRows):
        return generator.draw(torch.rand, shape, device)
    return torch.rand(shape, generator=generator, device=device)


def normal(shape: Sequence[int], generator: Generator,
           device=None) -> torch.Tensor:
    """``torch.randn(shape)`` from ``generator`` (or its rows)."""
    if isinstance(generator, BatchRows):
        return generator.draw(torch.randn, shape, device)
    return torch.randn(shape, generator=generator, device=device)


class FastDropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[Generator] = None) -> torch.Tensor:
        if generator is None or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        draw = uniform(x.shape, generator, x.device)
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))
