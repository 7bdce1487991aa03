"""Weights across the two packages, and the port's initialisation.

The port's parameter names follow the flax tree one to one, so the bridge
is a renaming:

* flax ``params/a/b/kernel`` ``(in, out)`` <-> torch ``a.b.weight``
  ``(out, in)`` (transposed: ``nn.Linear`` stores ``(out, in)``);
* flax LayerNorm ``scale`` <-> torch ``weight``; every ``bias`` keeps its
  name;
* embedding tables (``input_{col}``, ``input_{col}_special``,
  ``input_task``) keep name and layout.

A job's port weights live in ``<job>/checkpoints/<name>.torch.npz``: the
flat flax-named arrays, readable with numpy alone, written from an orbax
checkpoint by ``tools/export_torch_weights.py`` or from a port model by
:func:`save_weights`.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

Flat = Dict[str, np.ndarray]


def params_from_jax(flat: Flat) -> Dict[str, torch.Tensor]:
    """Flat ``/``-joined flax parameter paths -> a torch ``state_dict``."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] != "params" or len(parts) < 2:
            raise KeyError(f"not a flax parameter path: {path!r}")
        *modules, leaf = parts[1:]
        array = np.asarray(value)
        if leaf == "kernel":
            if array.ndim != 2:
                raise ValueError(f"{path}: kernel of rank {array.ndim}")
            leaf, array = "weight", array.T
        elif leaf == "scale":
            leaf = "weight"
        key = ".".join(modules + [leaf])
        if key in state:
            raise KeyError(f"{path!r} and another leaf both map to {key!r}")
        state[key] = torch.from_numpy(np.array(array, order="C"))
    return state


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Flat:
    """Inverse of :func:`params_from_jax`."""
    flat: Flat = {}
    for key, tensor in state_dict.items():
        *modules, leaf = key.split(".")
        array = tensor.detach().cpu().numpy()
        if leaf == "weight":
            if array.ndim == 2:
                leaf, array = "kernel", array.T
            else:
                leaf = "scale"
        flat["/".join(["params", *modules, leaf])] = np.ascontiguousarray(array)
    return flat


def load_jax_params(model: nn.Module, flat: Flat) -> nn.Module:
    """Load flat flax parameters into ``model``; raises on any leaf that is
    unused, missing or of the wrong shape."""
    model.load_state_dict(params_from_jax(flat), strict=True)
    return model


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> nn.Module:
    """The JAX package's initialisers, drawn from a seeded generator:
    Dense kernels glorot-uniform with zero bias, LayerNorm 1 / 0, embedding
    tables U(-0.05, 0.05), and the autoregressive baselines' ``bos``
    N(0, 0.05^2) (autoreg.py:122-124).  Draws are made on the CPU, so the
    weights do not depend on the model's device."""
    generator = torch.Generator().manual_seed(seed)

    def uniform(param, limit):
        draw = torch.empty(param.shape, dtype=param.dtype)
        param.copy_(draw.uniform_(-limit, limit, generator=generator))

    def normal(param, std):
        draw = torch.empty(param.shape, dtype=param.dtype)
        param.copy_(draw.normal_(0.0, std, generator=generator))

    for module in model.modules():
        if isinstance(module, nn.Linear):
            fan_out, fan_in = module.weight.shape
            uniform(module.weight, math.sqrt(6.0 / (fan_in + fan_out)))
            module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        else:
            for name, param in module.named_parameters(recurse=False):
                if name == "bos":
                    normal(param, 0.05)
                else:
                    uniform(param, 0.05)
    return model


def save_weights(path: str, model: nn.Module) -> None:
    """Write ``model``'s weights as flat flax-named arrays (``np.savez``)."""
    with open(path, "wb") as f:
        np.savez(f, **params_to_jax(model.state_dict()))


def load_weights(path: str, model: nn.Module) -> nn.Module:
    with np.load(path) as data:
        return load_jax_params(model, {k: data[k] for k in data.files})
