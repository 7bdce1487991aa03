"""Shared helpers of the PyTorch-port parity tests: one numpy batch, masks
and weights handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from flexdm_tpu.data import split_device_batch
from flexdm_tpu.models.masking import get_seq_mask


def numpy_batch(spec, n=4):
    """The first ``n`` test documents as a dict of numpy arrays."""
    batch = next(iter(spec.make_dataset("test", batch_size=n)))
    return {k: np.asarray(v) for k, v in split_device_batch(batch).items()}


def random_masks(schema, batch, seed=0, p=0.4):
    """Per sequence column, a random subset of the valid elements; canvas
    columns all-True."""
    rng = np.random.default_rng(seed)
    seq_mask = np.asarray(get_seq_mask(jnp.asarray(batch["length"]),
                                       schema.max_length))
    b = seq_mask.shape[0]
    return {
        c.name: (seq_mask & (rng.random(seq_mask.shape) < p))
        if c.is_sequence else np.ones(b, bool)
        for c in schema.modeled
    }


def to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def to_torch(tree, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in tree.items()}


def to_numpy(tree):
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def flat_params(variables):
    """Flax variables -> ``{"params/a/b/kernel": numpy array}``."""
    flat = traverse_util.flatten_dict(jax.device_get(variables), sep="/")
    return {k: np.asarray(v) for k, v in flat.items()}


def assert_trees_close(got, want, rtol, atol):
    for name in sorted(want):
        np.testing.assert_allclose(
            np.asarray(got[name]), np.asarray(want[name]),
            rtol=rtol, atol=atol, err_msg=name,
        )
