"""A job's checkpoints on disk: ``<job>/checkpoints/<name>.torch.npz``.

The JAX package writes orbax checkpoints (``best``, ``final``, and ``last``
with the optimizer state for ``--resume``).  The port writes numpy
archives:

* ``best`` and ``final`` hold the weights in the flat flax-named layout of
  :func:`flexdm_tpu_torch.convert.save_weights`, which
  ``flexdm_tpu_torch.serve`` and ``--weights`` load;
* ``last`` holds what ``--resume`` needs to continue a run as if it had
  not stopped: the same weights (``params/...``), the keras-Adam moments
  in the same layout (``adam/mu/params/...``, ``adam/nu/params/...``) and
  its iteration count (``adam/count``), the step, the state of the
  training ``torch.Generator`` (the port draws every step's randomness
  from one sequential generator, where JAX folds a key from the step) and
  the best validation score so far, the watermark that ``best`` holds.

Every file is written to a temporary name and then renamed, so a reader
never sees a half-written one.

On more than one rank, every rank calls the writers (a tensor-parallel
model's split parameters and moments are gathered whole over its model
group, a collective) and only the primary rank writes: the files are the
single-device ones, so a job trained on N ranks serves, evaluates and
resumes on one, and the reverse.  ``last`` holds the one generator state
every rank's generator is at.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import load_jax_params, params_from_jax, params_to_jax
from ..parallel.mesh import gather_params, gather_tensors
from .optim import KerasAdam

PARAMS, MU, NU = "params/", "adam/mu/", "adam/nu/"


def checkpoint_path(job_dir: str, name: str) -> str:
    return os.path.join(job_dir, "checkpoints", f"{name}.torch.npz")


def _write(job_dir: str, name: str, arrays: Dict[str, np.ndarray],
           primary: bool) -> str:
    path = checkpoint_path(job_dir, name)
    if not primary:
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def save_checkpoint(job_dir: str, name: str, model: nn.Module,
                    primary: bool = True) -> str:
    """Write ``model``'s weights (whole) as checkpoint ``name``; only
    ``primary`` writes."""
    return _write(job_dir, name, params_to_jax(gather_params(model)),
                  primary)


def _moments(model: nn.Module, moments, prefix: str) -> Dict[str, np.ndarray]:
    names, params = zip(*model.named_parameters())
    flat = params_to_jax(dict(zip(names, gather_tensors(params, moments))))
    return {prefix + k: v for k, v in flat.items()}


def save_last(job_dir: str, model: nn.Module, optimizer: KerasAdam,
              step: int, generator: torch.Generator,
              best_score: float, primary: bool = True) -> str:
    """Write the ``last`` checkpoint: weights, Adam state, step, generator
    state and best-score watermark (whole; only ``primary`` writes)."""
    state = optimizer.state_dict()
    arrays = {
        **params_to_jax(gather_params(model)),
        **_moments(model, state["mu"], MU),
        **_moments(model, state["nu"], NU),
        "adam/count": np.int64(state["count"]),
        "step": np.int64(step),
        "generator": generator.get_state().numpy(),
        "best_score": np.float64(best_score),
    }
    return _write(job_dir, "last", arrays, primary)


def load_last(job_dir: str, model: nn.Module, optimizer: KerasAdam,
              generator: torch.Generator) -> Tuple[int, float]:
    """Restore the ``last`` checkpoint into ``model``, ``optimizer`` and
    ``generator``; returns ``(step, best_score)``."""
    with np.load(checkpoint_path(job_dir, "last")) as data:
        arrays = {k: data[k] for k in data.files}

    def strip(prefix):
        return {k[len(prefix):]: v for k, v in arrays.items()
                if k.startswith(prefix)}

    load_jax_params(model, {k: v for k, v in arrays.items()
                            if k.startswith(PARAMS)})
    names = [n for n, _ in model.named_parameters()]
    moments = {}
    for key, prefix in (("mu", MU), ("nu", NU)):
        state = params_from_jax(strip(prefix))
        if set(state) != set(names):
            raise KeyError(f"last: the {key} leaves "
                           f"{sorted(set(state) ^ set(names))} do not match "
                           "the model's parameters")
        moments[key] = [state[n] for n in names]
    optimizer.load_state_dict({"count": int(arrays["adam/count"]), **moments})
    generator.set_state(torch.from_numpy(arrays["generator"]))
    return int(arrays["step"]), float(arrays["best_score"])
