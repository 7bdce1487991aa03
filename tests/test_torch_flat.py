"""The flat VanillaTransformer (``seq_type='flat'``: one token per
(element, field), S * F tokens) against the JAX package: flat fusion in the
encoder and flat detachment in the decoder within ``MODULE_TOL``, and the
eval forward of the whole model within ``SLICE_TOL``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flexdm_tpu import demo as jax_demo  # noqa: E402
from flexdm_tpu.models import decoder as jax_decoder  # noqa: E402
from flexdm_tpu.models import encoder as jax_encoder  # noqa: E402
from flexdm_tpu.models import masking as jax_masking  # noqa: E402
from flexdm_tpu.models import mfp as jax_mfp  # noqa: E402
from flexdm_tpu_torch import demo as port_demo  # noqa: E402
from flexdm_tpu_torch.convert import load_jax_params  # noqa: E402
from flexdm_tpu_torch.models import decoder as port_decoder  # noqa: E402
from flexdm_tpu_torch.models import encoder as port_encoder  # noqa: E402
from flexdm_tpu_torch.models import mfp as port_mfp  # noqa: E402
from tests._torch_parity import (  # noqa: E402
    assert_trees_close,
    flat_params,
    model_pair,
    numpy_batch,
    random_masks,
    to_jax,
    to_numpy,
    to_torch,
)

MODULE_TOL = dict(rtol=2e-5, atol=1e-5)
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)
D = 32
FLAT = dict(seq_type="flat", input_dtype="shuffled_set")


def _fields(schema):
    return [c for c in schema.valid_columns(False) if c.is_sequence]


@pytest.mark.parametrize("dataset", ["crello", "rico"])
def test_flat_encoder_matches_jax(request, dataset):
    spec = request.getfixturevalue(f"{dataset}_spec")
    schema = spec.schema
    batch = numpy_batch(spec)
    masks = random_masks(schema, batch, seed=1)
    inputs = {k: np.asarray(v) for k, v in jax_masking.preprocess_for_test(
        to_jax(batch), schema, to_jax(masks)).items()}
    kwargs = dict(latent_dim=D, input_dtype="shuffled_set", fusion="flat")
    jax_enc = jax_encoder.Encoder(schema, **kwargs)
    variables = jax_enc.init(jax.random.PRNGKey(0), to_jax(inputs))
    want_seq, want_mask = jax_enc.apply(variables, to_jax(inputs))
    n_fields = len(_fields(schema))
    assert want_seq.shape == (4, schema.max_length * n_fields, D)
    port_enc = port_encoder.Encoder(schema, **kwargs)
    load_jax_params(port_enc, flat_params(variables))
    with torch.no_grad():
        seq, seq_mask = port_enc(to_torch(inputs))
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), **MODULE_TOL)
    np.testing.assert_array_equal(seq_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("dataset", ["crello", "rico"])
def test_flat_decoder_matches_jax(request, dataset):
    schema = request.getfixturevalue(f"{dataset}_spec").schema
    s = schema.max_length * len(_fields(schema))
    h = np.random.default_rng(5).normal(size=(2, s, D)).astype(np.float32)
    jax_dec = jax_decoder.Decoder(schema, latent_dim=D, detachment="flat")
    variables = jax_dec.init(jax.random.PRNGKey(3), jnp.asarray(h))
    want = jax_dec.apply(variables, jnp.asarray(h))
    port_dec = port_decoder.Decoder(schema, latent_dim=D, detachment="flat")
    load_jax_params(port_dec, flat_params(variables))
    with torch.no_grad():
        got = port_dec(torch.from_numpy(h))
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
    assert_trees_close(to_numpy(got), want, **MODULE_TOL)


@pytest.mark.parametrize("dataset", ["crello", "rico"])
@pytest.mark.parametrize("num_iter", [1, 2])
def test_flat_forward_eval_matches_jax(request, dataset, num_iter):
    """The slice: task masks -> forward_eval of a flat model -> merged
    predictions (MaskGIT at num_iter=2)."""
    spec = request.getfixturevalue(f"{dataset}_spec")
    schema = spec.schema
    batch = numpy_batch(spec)
    jax_model, params, port_model = model_pair(schema, batch, **FLAT)
    want = jax_mfp.forward_eval(
        jax_model, params, to_jax(batch),
        jax_demo.build_task_masks(schema, to_jax(batch), "pos"),
        num_iter=num_iter)
    got = port_mfp.forward_eval(
        port_model, to_torch(batch),
        port_demo.build_task_masks(schema, to_torch(batch), "pos"),
        num_iter=num_iter)
    assert set(got) == set(want)
    assert_trees_close(to_numpy(got), want, **SLICE_TOL)


def test_flat_needs_shuffled_set_and_no_context(crello_spec):
    schema = crello_spec.schema
    with pytest.raises(ValueError, match="shuffled_set"):
        port_mfp.MFPModel(schema, latent_dim=D, seq_type="flat")
    with pytest.raises(ValueError, match="context"):
        port_mfp.MFPModel(schema, latent_dim=D, context="id", **FLAT)
    model = port_mfp.MFPModel(schema, latent_dim=D, **FLAT)
    assert model.draw_options() == dict(shuffle=True, noise_length=None)
