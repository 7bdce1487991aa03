"""Port train-path masking against the JAX package, with the draws JAX made
handed to torch: ``sample_tasks``, ``random_masking`` and
``preprocess_for_train`` must agree exactly; and the port's own draw
helpers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flexdm_tpu.data import make_task_probs  # noqa: E402
from flexdm_tpu.models import masking as jax_masking  # noqa: E402
from flexdm_tpu_torch.models import masking as port_masking  # noqa: E402
from tests._torch_parity import (  # noqa: E402
    assert_trees_close,
    numpy_batch,
    to_jax,
    to_numpy,
    to_torch,
)


def _replacement_values(schema, batch, key):
    """The tokens ``apply_token(..., "random", fold_in(key, i))`` draws for
    each sequence column (``i`` its index in ``schema.modeled``)."""
    values = {}
    for i, column in enumerate(schema.modeled):
        if not column.is_sequence:
            continue
        x = batch[column.name]
        k = jax.random.fold_in(key, i)
        if column.is_categorical:
            v = jax.random.randint(k, x.shape, 0, column.input_dim, x.dtype)
        else:
            v = 0.1 * jax.random.normal(k, x.shape, dtype=x.dtype)
        values[column.name] = np.asarray(v)
    return values


@pytest.mark.parametrize("method", ["elem_pos_attr_img_txt", "random",
                                    "elem_pos_attr"])
def test_sample_tasks_matches_jax(crello_spec, method):
    probs = tuple(make_task_probs(crello_spec.schema, method))
    key = jax.random.PRNGKey(len(method))
    want = jax_masking.sample_tasks(key, 64, probs)
    gumbel = jax.random.gumbel(key, (64, len(probs)), jnp.float32)
    got = port_masking.sample_tasks(torch.from_numpy(np.array(gumbel)),
                                    probs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dataset", ["crello", "rico"])
def test_random_masking_matches_jax(request, dataset):
    spec = request.getfixturevalue(f"{dataset}_spec")
    schema = spec.schema
    batch = numpy_batch(spec, 8)
    key = jax.random.PRNGKey(3)
    seq_mask = jax_masking.get_seq_mask(jnp.asarray(batch["length"]),
                                        schema.max_length)
    want = jax_masking.random_masking(to_jax(batch), schema, seq_mask, key)
    uniforms = jax.random.uniform(
        key, port_masking.train_draw_shape(schema, 8))
    got = port_masking.random_masking(
        to_torch(batch), schema, torch.from_numpy(np.asarray(seq_mask)),
        torch.from_numpy(np.asarray(uniforms)),
        to_torch(_replacement_values(schema, batch, key)),
    )
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert_trees_close(to_numpy(g), w, 0, 0)


@pytest.mark.parametrize("dataset", ["crello", "rico"])
@pytest.mark.parametrize("seed", [0, 1])
def test_preprocess_for_train_matches_jax(request, dataset, seed):
    """Every task id appears in the batch; targets, masked inputs (with the
    task column) and masks are equal."""
    spec = request.getfixturevalue(f"{dataset}_spec")
    schema = spec.schema
    n_tasks = len(schema.task_names)
    batch = numpy_batch(spec, 2 * n_tasks)
    tasks = np.random.default_rng(seed).permutation(
        np.arange(2 * n_tasks) % n_tasks).astype(np.int32)
    key = jax.random.PRNGKey(10 + seed)
    want = jax_masking.preprocess_for_train(
        to_jax(batch), schema, jnp.asarray(tasks), key)
    k_random, k_elem = jax.random.split(key)
    b = 2 * n_tasks
    draws = {
        "uniforms": jax.random.uniform(
            k_random, port_masking.train_draw_shape(schema, b)),
        "element": jax.random.uniform(k_elem, (b,)),
    }
    got = port_masking.preprocess_for_train(
        to_torch(batch), schema, torch.from_numpy(tasks),
        values=to_torch(_replacement_values(schema, batch, k_random)),
        **to_torch(draws),
    )
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert_trees_close(to_numpy(g), w, 0, 0)
    # Every task really masked something.
    assert all(got[2][c.name].any() for c in schema.sequence_columns
               if c.name in got[2])


def test_draw_train_shapes_and_determinism(crello_spec):
    schema = crello_spec.schema
    probs = make_task_probs(schema, "elem_pos_attr_img_txt")

    def draw(seed):
        return port_masking.draw_train(
            schema, 6, probs, torch.Generator().manual_seed(seed))

    a, b = draw(0), draw(0)
    assert a.uniforms.shape == port_masking.train_draw_shape(schema, 6)
    assert a.tasks.dtype == torch.int32 and a.element.shape == (6,)
    # masking_method excludes random (0) and type (2).
    assert set(a.tasks.tolist()) <= {1, 3, 4, 5, 6}
    for c in schema.sequence_columns:
        if c.name not in a.values:
            continue
        v = a.values[c.name]
        assert v.shape == (6, schema.max_length) + tuple(c.shape)
        if c.is_categorical:
            assert v.dtype == torch.int32
            assert 0 <= int(v.min()) and int(v.max()) < c.input_dim
    for x, y in zip(vars(a).values(), vars(b).values()):
        if isinstance(x, dict):
            assert all(torch.equal(x[k], y[k]) for k in x)
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
    assert not torch.equal(a.uniforms, draw(1).uniforms)


def test_record_draws_depend_on_the_record_only(crello_spec):
    schema = crello_spec.schema
    probs = make_task_probs(schema, "random")
    whole = port_masking.record_draws(schema, probs, 7, range(6))
    part = port_masking.record_draws(schema, probs, 7, [3, 4])
    assert torch.equal(part.uniforms, whole.uniforms[3:5])
    assert torch.equal(part.element, whole.element[3:5])
    for k, v in part.values.items():
        assert torch.equal(v, whole.values[k][3:5])
    other = port_masking.record_draws(schema, probs, 8, [3, 4])
    assert not torch.equal(other.uniforms, part.uniforms)
