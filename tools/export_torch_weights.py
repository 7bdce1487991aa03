"""Export a JAX job's checkpoint as the PyTorch port's weight file.

Reads ``<job>/checkpoints/<name>`` (orbax) through the JAX package's
``load_model`` and writes ``<job>/checkpoints/<name>.torch.npz``: the flax
parameter tree flattened to ``/``-joined paths (``params/encoder/input_type``,
``params/blocks/seq2seq_0/attn/query/kernel``, ...), one numpy array each.
``flexdm_tpu_torch`` reads that file with numpy alone, so the machine that
serves the port needs neither JAX nor orbax.  This script needs them (and
not torch): run it where the JAX package runs.

Usage:
    python tools/export_torch_weights.py --job-dir /path/to/job --checkpoint best
"""

from __future__ import annotations

# Repo-root bootstrap so `python tools/export_torch_weights.py` works
# without pip install.
if __package__ in (None, ""):
    import os as _os
    import sys as _sys

    _repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    if _repo not in _sys.path:
        _sys.path.insert(0, _repo)

import argparse
import os
from typing import Dict

import numpy as np


def flatten_params(params) -> Dict[str, np.ndarray]:
    """Flax variable tree -> ``{"params/a/b/kernel": array}``."""
    import jax
    from flax import traverse_util

    flat = traverse_util.flatten_dict(jax.device_get(params), sep="/")
    return {k: np.asarray(v) for k, v in flat.items()}


def export(job_dir: str, checkpoint: str = "best") -> str:
    """Write the weight file of ``job_dir``'s ``checkpoint``; returns its
    path."""
    from flexdm_tpu.demo import load_model

    _, params, _ = load_model(job_dir, checkpoint, batch_size=2)
    out = os.path.join(job_dir, "checkpoints", f"{checkpoint}.torch.npz")
    with open(out, "wb") as f:
        np.savez(f, **flatten_params(params))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--job-dir", dest="job_dir", required=True)
    parser.add_argument("--checkpoint", default="best")
    args = parser.parse_args(argv)
    print(export(args.job_dir, args.checkpoint))


if __name__ == "__main__":
    main()
