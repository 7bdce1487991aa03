"""Port ``compute_mfp_loss`` against the JAX package on random logits,
with and without the rico pos-sort protocol: the loss and every metric
within 1e-5 relative (``MODULE_TOL`` of the model tests is 2e-5)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flexdm_tpu.models import losses as jax_losses  # noqa: E402
from flexdm_tpu_torch.models import losses as port_losses  # noqa: E402
from tests._torch_parity import (  # noqa: E402
    numpy_batch,
    random_masks,
    to_jax,
    to_torch,
)

TOL = dict(rtol=1e-5, atol=1e-6)


def _predictions(schema, b, seed):
    rng = np.random.default_rng(seed)
    return {
        c.name: (3.0 * rng.normal(size=(b, schema.max_length) + (
            (c.shape[-1], c.input_dim) if c.is_categorical else c.shape
        ))).astype(np.float32)
        for c in schema.sequence_columns
    }


@pytest.mark.parametrize("dataset", ["crello", "rico"])
@pytest.mark.parametrize("weighted", [False, True])
def test_compute_mfp_loss_matches_jax(request, dataset, weighted):
    spec = request.getfixturevalue(f"{dataset}_spec")
    schema = spec.schema
    batch = numpy_batch(spec, 6)
    masks = random_masks(schema, batch, seed=2, p=0.6)
    pred = _predictions(schema, 6, seed=3)
    weight = np.array([1, 1, 1, 1, 0, 0], np.float32) if weighted else None
    want_loss, want = jax.jit(jax_losses.compute_mfp_loss, static_argnums=0)(
        schema, to_jax(batch), to_jax(pred), to_jax(masks),
        sample_weight=None if weight is None else jnp.asarray(weight),
    )
    got_loss, got = port_losses.compute_mfp_loss(
        schema, to_torch(batch), to_torch(pred), to_torch(masks),
        sample_weight=None if weight is None else torch.from_numpy(weight),
    )
    assert set(got) == set(want)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **TOL)
    for name in sorted(want):
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   err_msg=name, **TOL)
    if weighted:  # the padded rows really are left out
        _, unweighted = port_losses.compute_mfp_loss(
            schema, to_torch(batch), to_torch(pred), to_torch(masks))
        assert got["loss"].item() != unweighted["loss"].item()


def test_categorical_score_ignores_out_of_range_labels():
    """A label outside the logits picks 0, as the JAX one-hot does."""
    logits = torch.tensor([[[2.0, 1.0, -1e9]]])
    labels = torch.tensor([[5]])
    ce, hit = port_losses.categorical_loss_and_score(labels, logits)
    want_ce, want_hit = jax_losses.categorical_loss_and_score(
        jnp.asarray(labels.numpy()), jnp.asarray(logits.numpy()))
    np.testing.assert_allclose(ce.numpy(), np.asarray(want_ce), rtol=1e-6)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(want_hit))


@pytest.mark.parametrize("dataset", ["crello", "rico"])
@pytest.mark.parametrize("ignore_sort", [None, "gt", "pred"])
def test_sort_flag_matches_jax(request, dataset, ignore_sort):
    """The pos-sort protocol: the flagged samples are scored on sorted
    ground truth and sorted (argmaxed) predictions."""
    spec = request.getfixturevalue(f"{dataset}_spec")
    schema = spec.schema
    batch = numpy_batch(spec, 6)
    masks = random_masks(schema, batch, seed=4, p=0.6)
    pred = _predictions(schema, 6, seed=5)
    flag = np.array([1, 0, 1, 1, 0, 1], bool)
    want_loss, want = jax.jit(jax_losses.compute_mfp_loss,
                              static_argnums=(0, 5))(
        schema, to_jax(batch), to_jax(pred), to_jax(masks),
        jnp.asarray(flag), ignore_sort,
    )
    got_loss, got = port_losses.compute_mfp_loss(
        schema, to_torch(batch), to_torch(pred), to_torch(masks),
        sort_flag=torch.from_numpy(flag), ignore_sort=ignore_sort,
    )
    assert set(got) == set(want)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **TOL)
    for name in sorted(want):
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   err_msg=name, **TOL)
    # The flag really changes the score.
    _, unsorted = port_losses.compute_mfp_loss(
        schema, to_torch(batch), to_torch(pred), to_torch(masks))
    assert got["left_loss"].item() != unsorted["left_loss"].item()
