"""The port's autoregressive evaluation against the JAX package's, on the
CPU: ``reorganize_indices`` exactly; the port's autoreg ``elem`` chunk
(rows and masks) against ``_expand_elem(..., autoreg=True)`` exactly; and
``evaluate_task`` of a tiny AutoReg job (crello, D=16, 1 block, 2 heads;
the port's seeded weights in both packages) within 1e-5 of JAX's scores
on ``elem`` (the reordered protocol), ``random`` (JAX's own draws) and
``pos``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from flexdm_tpu.data import DatasetSpec as JaxSpec  # noqa: E402
from flexdm_tpu.evaluation import harness as jax_harness  # noqa: E402
from flexdm_tpu.models import sorting as jax_sorting  # noqa: E402
from flexdm_tpu.models.baselines import AutoReg as JaxAutoReg  # noqa: E402
from flexdm_tpu_torch.convert import init_params, params_to_jax  # noqa: E402
from flexdm_tpu_torch.data import DatasetSpec as PortSpec  # noqa: E402
from flexdm_tpu_torch.evaluation import harness  # noqa: E402
from flexdm_tpu_torch.models import baselines as port_baselines  # noqa: E402
from flexdm_tpu_torch.models import sorting as port_sorting  # noqa: E402
from tests._torch_baselines import _unflatten  # noqa: E402
from tests._torch_parity import to_jax, to_torch  # noqa: E402
from tests.test_masking import tiny_inputs, tiny_schema  # noqa: E402
from tests.test_torch_eval import _jax_uniforms  # noqa: E402

SCORE_ATOL = 1e-5
SIZES = dict(latent_dim=16, num_blocks=1, num_heads=2)


def test_reorganize_indices_matches_jax():
    rng = np.random.default_rng(0)
    maxlen = 7
    n = rng.integers(0, maxlen, (40, 1))
    f = rng.integers(0, maxlen, (40, 1))
    want = jax_sorting.reorganize_indices(jnp.asarray(f), jnp.asarray(n),
                                          maxlen)
    got = port_sorting.reorganize_indices(torch.from_numpy(f),
                                          torch.from_numpy(n), maxlen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Each row is a permutation with f at n.
    assert (np.sort(got.numpy(), 1) == np.arange(maxlen)).all()
    assert (got.numpy()[np.arange(40), n[:, 0]] == f[:, 0]).all()


def test_elem_chunk_autoreg_matches_expand_elem():
    """Replica ``(b, i)`` moves element ``i`` to position ``length`` and
    masks it there: the rows and masks of JAX's ``_expand_elem``."""
    schema = tiny_schema()
    x = {k: np.asarray(v) for k, v in
         tiny_inputs(schema=schema, lengths=(3, 1, 0, 5)).items()}
    S = schema.max_length
    expanded, eye, weight = jax_harness._expand_elem(to_jax(x), schema,
                                                     autoreg=True)
    idx = torch.arange(4 * S + 2)  # two chunk-padding ids past the end
    rows, masks, got_w = harness._elem_chunk(
        schema, to_torch(x), idx, torch.ones(4), autoreg=True)
    for c in schema.modeled:
        if c.is_sequence:
            np.testing.assert_array_equal(rows[c.name][:4 * S].numpy(),
                                          np.asarray(expanded[c.name]),
                                          err_msg=c.name)
            np.testing.assert_array_equal(masks[c.name][:4 * S].numpy(),
                                          np.asarray(eye), err_msg=c.name)
    np.testing.assert_array_equal(got_w[:4 * S].numpy(),
                                  np.asarray(weight, np.float32))
    assert (got_w[4 * S:] == 0).all()
    # Without autoreg the element stays where it is.
    rows, masks, _ = harness._elem_chunk(schema, to_torch(x), idx,
                                         torch.ones(4))
    np.testing.assert_array_equal(rows["left"][:4 * S].numpy(),
                                  np.repeat(x["left"], S, 0))


@pytest.fixture(scope="module")
def autoreg_pair(crello_dir):
    """JAX's AutoReg and its params, and the port's, with the same
    (port-initialised) weights, and both packages' specs."""
    jax_spec = JaxSpec("crello", crello_dir, 8)
    schema = jax_spec.schema
    port = init_params(port_baselines.AutoReg(schema, **SIZES), 0).eval()
    params = {"params": _unflatten({
        k: jnp.asarray(v)
        for k, v in params_to_jax(port.state_dict()).items()})}
    model = JaxAutoReg(schema=schema, attention_impl="xla", **SIZES)
    return jax_spec, PortSpec("crello", crello_dir, 8), model, params, port


@pytest.mark.parametrize("task_mode", ["elem", "random", "pos"])
def test_evaluate_task_matches_jax(autoreg_pair, task_mode):
    jax_spec, port_spec, model, params, port = autoreg_pair
    groups = jax_spec.schema.attribute_groups
    group = (task_mode, groups[task_mode]) if task_mode in groups else None
    kwargs = dict(seed=3, elem_chunk=64)
    want = jax_harness.evaluate_task(
        model, params, jax_spec.make_dataset("test", batch_size=8),
        task_mode, group, **kwargs)
    got = harness.evaluate_task(
        port, port_spec.make_dataset("test", batch_size=8), task_mode, group,
        uniforms_fn=_jax_uniforms, **kwargs)
    assert want and set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=SCORE_ATOL,
                                   err_msg=k)

