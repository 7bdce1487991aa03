"""Port element sorting and shuffling against the JAX package: the same
numpy batch (with tied sort keys) in, exactly the same batch out."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flexdm_tpu.models import sorting as jax_sorting  # noqa: E402
from flexdm_tpu_torch.models import sorting as port_sorting  # noqa: E402
from tests._torch_parity import (  # noqa: E402
    assert_trees_close,
    numpy_batch,
    to_jax,
    to_numpy,
    to_torch,
)


def _tied_batch(spec, n=6, seed=0):
    """A test batch in which, per sample, a few elements copy the sort keys
    of element 0 (their other fields stay as they were, so the order of
    the ties shows in the output) and a few copy only its type."""
    batch = numpy_batch(spec, n)
    rng = np.random.default_rng(seed)
    for i in range(n):
        length = int(batch["length"][i, 0]) + 1
        if length < 3:
            continue
        for j in rng.choice(np.arange(1, length), size=min(3, length - 1),
                            replace=False):
            for key in port_sorting.SORT_KEYS:
                batch[key][i, j] = batch[key][i, 0]
        batch["type"][i, length - 1] = batch["type"][i, 0]
    return batch


def _has_ties(batch):
    keys = np.stack([batch[k][..., 0] for k in port_sorting.SORT_KEYS], -1)
    for i, row in enumerate(keys):
        valid = row[: int(batch["length"][i, 0]) + 1]
        if len({tuple(r) for r in valid}) < len(valid):
            return True
    return False


@pytest.mark.parametrize("dataset", ["crello", "rico"])
def test_sort_inputs_with_ties_matches_jax(request, dataset):
    spec = request.getfixturevalue(f"{dataset}_spec")
    batch = _tied_batch(spec)
    assert _has_ties(batch)
    want = jax_sorting.sort_inputs(to_jax(batch), spec.schema)
    got = port_sorting.sort_inputs(to_torch(batch), spec.schema)
    assert set(got) == set(want)
    assert_trees_close(to_numpy(got), want, 0, 0)
    # Something really moved.
    assert any(not np.array_equal(got[k].numpy(), batch[k]) for k in got)


@pytest.mark.parametrize("dataset", ["crello", "rico"])
def test_sort_inputs_from_logits_matches_jax(request, dataset):
    """Predicted logits whose argmaxes tie across elements, and ties inside
    one argmax (the first maximum wins in both)."""
    spec = request.getfixturevalue(f"{dataset}_spec")
    schema = spec.schema
    batch = numpy_batch(spec, 6)
    rng = np.random.default_rng(1)
    pred = {"length": batch["length"]}
    for c in schema.sequence_columns:
        shape = (6, schema.max_length) + (
            (c.shape[-1], c.input_dim) if c.is_categorical else c.shape)
        x = rng.normal(size=shape).astype(np.float32)
        if c.is_categorical and c.name in port_sorting.SORT_KEYS:
            # Few distinct argmaxes, so elements tie; every tenth element
            # has two equal maxima.
            top = rng.integers(0, 3, size=shape[:-1])
            np.put_along_axis(x, top[..., None], 10.0, axis=-1)
            x[:, ::10, :, 3] = 10.0
        pred[c.name] = x
    want = jax_sorting.sort_inputs(to_jax(pred), schema, from_logits=True)
    got = port_sorting.sort_inputs(to_torch(pred), schema, from_logits=True)
    assert_trees_close(to_numpy(got), want, 0, 0)


@pytest.mark.parametrize("dataset", ["crello", "rico"])
def test_shuffle_inputs_matches_jax(request, dataset):
    spec = request.getfixturevalue(f"{dataset}_spec")
    batch = numpy_batch(spec, 6)
    key = jax.random.PRNGKey(4)
    want = jax_sorting.shuffle_inputs(to_jax(batch), spec.schema, key)
    uniforms = jax.random.uniform(key, (6, spec.schema.max_length))
    got = port_sorting.shuffle_inputs(
        to_torch(batch), spec.schema, torch.from_numpy(np.array(uniforms)))
    assert set(got) == set(want)
    assert_trees_close(to_numpy(got), want, 0, 0)
    # The padding stays in place, the valid prefix is permuted.
    length = batch["length"][:, 0] + 1
    for i, n in enumerate(length):
        np.testing.assert_array_equal(got["left"][i, n:].numpy(),
                                      batch["left"][i, n:])
    assert not all(np.array_equal(got[k].numpy(), batch[k]) for k in got)


def test_lexsort_matches_jnp_lexsort():
    """Many equal keys: the stable chain equals ``jnp.lexsort``."""
    rng = np.random.default_rng(2)
    keys = [rng.integers(0, 3, size=(5, 40)).astype(np.int32)
            for _ in range(4)]
    want = jnp.lexsort(tuple(jnp.asarray(k) for k in keys), axis=-1)
    got = port_sorting.lexsort([torch.from_numpy(k) for k in keys])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
