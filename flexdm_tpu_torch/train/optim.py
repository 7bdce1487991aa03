"""The optimizer of the reference's training dynamics (PyTorch).

Counterpart of ``flexdm_tpu/train/optim.py``, which replicates keras
``Adam(learning_rate, clipnorm=1.0)`` with L2 regularizers:

* :func:`clip_by_per_leaf_norm` clips each gradient tensor to its own norm
  (keras ``clipnorm``), not the global norm of ``clip_grad_norm_``;
* :class:`KerasAdam` adds ``eps = 1e-7`` to the square root of the
  UNcorrected second moment and scales by
  ``alpha_t = sqrt(1 - b2^t) / (1 - b1^t)``; ``torch.optim.Adam`` adds eps
  to the corrected one, which shifts parameters with tiny gradients;
* :func:`l2_penalty` is ``sum(w^2)`` over every parameter but the
  LayerNorm ones; it enters the loss, so it is clipped and adapted like
  any other gradient.

Tensor-parallel, a split parameter's gradient clips by the norm of the
whole tensor and its L2 term is the whole tensor's ``sum(w^2)``: each
takes its shards' squared sums summed over the model group (a shard's own
norm would clip differently, and only when clipping binds).  The moments
live with the shard.

Updates are in place on the parameters and on the moment buffers.
:meth:`KerasAdam.state_dict` and :meth:`KerasAdam.load_state_dict` carry
the moments and the iteration count in and out of the ``last``
checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..parallel.layers import reduce_from_model, split_of


@torch.no_grad()
def clip_by_per_leaf_norm(grads: Sequence[torch.Tensor], max_norm: float,
                          params: Sequence[torch.Tensor] = ()) -> None:
    """Scale each gradient in place to a norm of at most ``max_norm``; the
    gradient of a split parameter of ``params`` (the gradients' own
    parameters, in order) by the norm of the whole tensor."""
    norms = torch.stack(torch._foreach_norm(list(grads)))
    split = [i for i, p in enumerate(params) if split_of(p) is not None]
    if split:
        index = torch.tensor(split, device=norms.device)
        squares = norms[index].square()
        dist.all_reduce(squares, group=split_of(params[split[0]]).group)
        norms = norms.index_copy(0, index, squares.sqrt())
    scales = (max_norm / norms.clamp_min(1e-12)).clamp(max=1.0)
    torch._foreach_mul_(list(grads), list(scales.unbind()))


class KerasAdam:
    """keras Adam over a fixed list of parameters.

    ``step(grads)`` applies ``p -= lr * alpha_t * m / (sqrt(v) + eps)``.
    The step counter lives on the host, so ``alpha_t`` is a Python number
    (computed in float32, as the JAX package computes it) and a step
    never waits for the device.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-7

    def __init__(self, params: Sequence[torch.Tensor],
                 learning_rate: float = 1e-4):
        self.params: List[torch.Tensor] = list(params)
        self.learning_rate = learning_rate
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def alpha(self, count: int) -> float:
        t = np.float32(count)
        b1, b2 = np.float32(self.B1), np.float32(self.B2)
        one = np.float32(1.0)
        return float(np.sqrt(one - b2 ** t) / (one - b1 ** t))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_add_(denom, self.EPS)
        update = torch._foreach_div(self.mu, denom)
        torch._foreach_mul_(update, self.alpha(self.count))
        torch._foreach_mul_(update, -self.learning_rate)
        torch._foreach_add_(self.params, update)

    def state_dict(self) -> Dict[str, Any]:
        """``{"count": int, "mu": [...], "nu": [...]}``, the moments in
        the order of :attr:`params` (the tensors themselves, not copies)."""
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy a :meth:`state_dict` in (onto the moments' device); the
        moments must match :attr:`params` in number and shapes."""
        for name in ("mu", "nu"):
            moments = list(state[name])
            if len(moments) != len(self.params):
                raise ValueError(f"{name}: {len(moments)} moments for "
                                 f"{len(self.params)} parameters")
            for mine, theirs in zip(getattr(self, name), moments):
                if tuple(mine.shape) != tuple(theirs.shape):
                    raise ValueError(f"{name}: shape {tuple(theirs.shape)} "
                                     f"for {tuple(mine.shape)}")
                mine.copy_(torch.as_tensor(theirs))
        self.count = int(state["count"])


def regularized(model: nn.Module) -> List[torch.Tensor]:
    """The parameters the L2 penalty covers: all but LayerNorm's."""
    return [
        p for m in model.modules() if not isinstance(m, nn.LayerNorm)
        for p in m.parameters(recurse=False)
    ]


def l2_penalty(model: nn.Module) -> torch.Tensor:
    """``sum(w^2)`` over :func:`regularized`, as one reduction over the
    concatenated parameters; split parameters' squared sums are summed
    over the model group (the backward keeps each rank's own)."""
    params = regularized(model)
    split = [p for p in params if split_of(p) is not None]
    whole = [p for p in params if split_of(p) is None]
    penalty = torch.cat([p.reshape(-1) for p in whole]).square().sum()
    if split:
        shards = torch.cat([p.reshape(-1) for p in split]).square().sum()
        penalty = penalty + reduce_from_model(shards, split_of(split[0]))
    return penalty
