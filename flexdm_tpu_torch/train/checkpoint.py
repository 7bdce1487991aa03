"""A job's weights on disk: ``<job>/checkpoints/<name>.torch.npz``.

The JAX package writes orbax checkpoints (``best``, ``final``, and ``last``
with the optimizer state for ``--resume``).  The port writes the weights
of ``best`` and ``final`` in the flat flax-named layout of
:func:`flexdm_tpu_torch.convert.save_weights`, which
``flexdm_tpu_torch.serve`` loads; ``last`` and resuming are not in this
port yet.
"""

from __future__ import annotations

import os

from torch import nn

from ..convert import save_weights


def checkpoint_path(job_dir: str, name: str) -> str:
    return os.path.join(job_dir, "checkpoints", f"{name}.torch.npz")


def save_checkpoint(job_dir: str, name: str, model: nn.Module) -> str:
    """Write ``model``'s weights as checkpoint ``name``; a reader never sees
    a half-written file (write, then rename)."""
    path = checkpoint_path(job_dir, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    save_weights(tmp, model)
    os.replace(tmp, path)
    return path
