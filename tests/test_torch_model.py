"""Port modules and the eval forward against the JAX package, on the same
numpy batch and the same weights (moved through ``params_from_jax``).

Module tolerance is 1e-5 abs / 2e-5 rel (the two LayerNorms compute the
variance differently); the whole slice is held to 1e-4, the bar of the TF
checkpoint golden.
"""

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
from flexdm_tpu.models import transformer as jax_transformer  # noqa: E402
from flexdm_tpu.train.trainer import init_params as jax_init_params  # noqa: E402
from flexdm_tpu_torch import demo as port_demo  # noqa: E402
from flexdm_tpu_torch.convert import load_jax_params  # noqa: E402
from flexdm_tpu_torch.models import decoder as port_decoder  # noqa: E402
from flexdm_tpu_torch.models import encoder as port_encoder  # noqa: E402
from flexdm_tpu_torch.models import masking as port_masking  # noqa: E402
from flexdm_tpu_torch.models import mfp as port_mfp  # noqa: E402
from flexdm_tpu_torch.models import transformer as port_transformer  # noqa: E402
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
D, HEADS, BLOCKS = 32, 4, 2


def _spec(request, dataset):
    return request.getfixturevalue(f"{dataset}_spec")


def _modified(schema, batch, seed=0):
    """JAX-masked model inputs (MASK and NULL tokens present), with random
    task ids, as numpy."""
    masks = random_masks(schema, batch, seed)
    tasks = np.random.default_rng(seed).integers(
        0, len(schema.task_names), batch["length"].shape[0]
    ).astype(np.int32)
    modified = jax_masking.preprocess_for_test(
        to_jax(batch), schema, to_jax(masks), jnp.asarray(tasks)
    )
    return {k: np.asarray(v) for k, v in modified.items()}


CONTEXTS = [None, "id", "length", "canvas", "canvas_add"]


@pytest.mark.parametrize("dataset", ["crello", "rico"])
@pytest.mark.parametrize("context", CONTEXTS)
def test_encoder_matches_jax(request, dataset, context):
    schema = _spec(request, dataset).schema
    inputs = _modified(schema, numpy_batch(_spec(request, dataset)))
    jax_enc = jax_encoder.Encoder(schema, latent_dim=D, context=context)
    if dataset == "rico" and "canvas" in str(context):
        # rico has no canvas columns: both packages refuse.
        with pytest.raises(AssertionError, match="canvas"):
            jax_enc.init(jax.random.PRNGKey(0), to_jax(inputs))
        with pytest.raises(ValueError, match="canvas columns"):
            port_encoder.Encoder(schema, latent_dim=D, context=context)
        return
    variables = jax_enc.init(jax.random.PRNGKey(0), to_jax(inputs))
    want_seq, want_mask = jax_enc.apply(variables, to_jax(inputs))
    port_enc = port_encoder.Encoder(schema, latent_dim=D, context=context)
    load_jax_params(port_enc, flat_params(variables))
    with torch.no_grad():
        seq, seq_mask = port_enc(to_torch(inputs))
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), **MODULE_TOL)
    np.testing.assert_array_equal(seq_mask.numpy(), np.asarray(want_mask))


def _noise_of(module, variables, inputs, key):
    """The encoder's output with its element-wise noise drawn from ``key``,
    and that noise (the input of its ``input_noise`` Dense)."""
    from flax import linen as nn

    seen = []

    def grab(next_fun, args, kwargs, context):
        if (context.module.name == "input_noise"
                and context.method_name == "__call__"):
            seen.append(np.array(args[0]))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(grab):
        out = module.apply(variables, inputs, rngs={"noise": key})
    assert len(seen) == 1
    return out, seen[0]


@pytest.mark.parametrize("dataset,context", [
    ("crello", None), ("crello", "canvas"), ("crello", "canvas_add"),
    ("rico", "id"), ("rico", "length"),
])
def test_encoder_position_and_noise_match_jax(request, dataset, context):
    """``input_dtype='shuffled_set'`` (the ``input_const`` position table)
    and ``use_elemwise_noise``, the noise JAX drew handed to the port."""
    schema = _spec(request, dataset).schema
    inputs = _modified(schema, numpy_batch(_spec(request, dataset)))
    kwargs = dict(latent_dim=D, context=context, input_dtype="shuffled_set",
                  use_elemwise_noise=True)
    jax_enc = jax_encoder.Encoder(schema, **kwargs)
    variables = jax_enc.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        to_jax(inputs))
    (want_seq, want_mask), noise = _noise_of(
        jax_enc, variables, to_jax(inputs), jax.random.PRNGKey(2))
    token = context in ("id", "length", "canvas")
    assert noise.shape == (4, schema.max_length + token, 4)
    port_enc = port_encoder.Encoder(schema, **kwargs)
    load_jax_params(port_enc, flat_params(variables))
    with torch.no_grad():
        seq, seq_mask = port_enc(to_torch(inputs),
                                 noise=torch.from_numpy(noise))
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), **MODULE_TOL)
    np.testing.assert_array_equal(seq_mask.numpy(), np.asarray(want_mask))
    with pytest.raises(ValueError, match="noise"):
        port_enc(to_torch(inputs))


@pytest.mark.parametrize("block", ["deepsvg", "transformer"])
def test_block_matches_jax(block):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 50, D)).astype(np.float32)
    key_mask = np.arange(50)[None, :] < np.array([[50], [7], [1]])
    jax_block = jax_transformer.BLOCK_TYPES[block](
        emb_size=D, num_heads=HEADS, attention_impl="xla"
    )
    variables = jax_block.init(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(key_mask)
    )
    # Non-trivial LayerNorm parameters, so scale/bias mapping is exercised.
    flat = flat_params(variables)
    for name in flat:
        if "norm" in name:
            flat[name] = flat[name] + rng.normal(
                scale=0.1, size=flat[name].shape).astype(np.float32)
    want = jax_block.apply(
        jax.tree_util.tree_map(jnp.asarray, _unflatten(flat)),
        jnp.asarray(x), jnp.asarray(key_mask),
    )
    port_block = port_transformer.BLOCK_TYPES[block](
        emb_size=D, num_heads=HEADS
    ).eval()
    load_jax_params(port_block, flat)
    with torch.no_grad():
        got = port_block(torch.from_numpy(x), torch.from_numpy(key_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


def _unflatten(flat):
    from flax import traverse_util

    return traverse_util.unflatten_dict(flat, sep="/")


@pytest.mark.parametrize("dataset", ["crello", "rico"])
@pytest.mark.parametrize("context", CONTEXTS)
def test_decoder_matches_jax(request, dataset, context):
    """Every context: the context token split off (id, length, canvas) or
    kept (canvas_add), and crello's canvas heads (canvas)."""
    schema = _spec(request, dataset).schema
    s = schema.max_length + (context in ("id", "length", "canvas"))
    h = np.random.default_rng(4).normal(size=(2, s, D)).astype(np.float32)
    jax_dec = jax_decoder.Decoder(schema, latent_dim=D, context=context)
    variables = jax_dec.init(jax.random.PRNGKey(2), jnp.asarray(h))
    want = jax_dec.apply(variables, jnp.asarray(h))
    port_dec = port_decoder.Decoder(schema, latent_dim=D, context=context)
    load_jax_params(port_dec, flat_params(variables))
    with torch.no_grad():
        got = port_dec(torch.from_numpy(h))
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
    assert_trees_close(to_numpy(got), want, **MODULE_TOL)


@pytest.mark.parametrize("dataset", ["crello", "rico"])
def test_test_path_masking_matches_jax(request, dataset):
    """get_seq_mask, filter_padding, apply_token, get_initial_masks,
    preprocess_for_test and merge_inputs_and_prediction: exact."""
    schema = _spec(request, dataset).schema
    batch = numpy_batch(_spec(request, dataset))
    masks = random_masks(schema, batch, seed=5)
    jb, tb = to_jax(batch), to_torch(batch)
    jm, tm = to_jax(masks), to_torch(masks)
    S = schema.max_length

    seq_mask = port_masking.get_seq_mask(tb["length"], S)
    want_seq_mask = jax_masking.get_seq_mask(jb["length"], S)
    np.testing.assert_array_equal(seq_mask.numpy(), np.asarray(want_seq_mask))
    logits = np.random.default_rng(6).normal(size=(4, S)).astype(np.float32)
    np.testing.assert_array_equal(
        port_masking.get_seq_mask(torch.from_numpy(logits), S, True).numpy(),
        np.asarray(jax_masking.get_seq_mask(jnp.asarray(logits), S, True)),
    )
    for token in ("masked", "unused"):
        for column in schema.sequence_columns:
            np.testing.assert_array_equal(
                port_masking.apply_token(
                    tb[column.name], column, tm[column.name], token).numpy(),
                np.asarray(jax_masking.apply_token(
                    jb[column.name], column, jm[column.name], token)),
                err_msg=f"{column.name}/{token}",
            )
    assert_trees_close(
        to_numpy(port_masking.filter_padding(tb, schema, seq_mask)),
        jax_masking.filter_padding(jb, schema, want_seq_mask), 0, 0,
    )
    assert_trees_close(
        to_numpy(port_masking.get_initial_masks(schema, seq_mask)),
        jax_masking.get_initial_masks(schema, want_seq_mask), 0, 0,
    )
    tasks = np.arange(4, dtype=np.int32) % len(schema.task_names)
    assert_trees_close(
        to_numpy(port_masking.preprocess_for_test(
            tb, schema, tm, torch.from_numpy(tasks))),
        jax_masking.preprocess_for_test(jb, schema, jm, jnp.asarray(tasks)),
        0, 0,
    )
    rng = np.random.default_rng(7)
    prediction = {
        c.name: rng.normal(size=(4, S) + (
            (c.shape[-1], c.input_dim) if c.is_categorical else c.shape
        )).astype(np.float32)
        for c in schema.sequence_columns
    }
    assert_trees_close(
        to_numpy(port_masking.merge_inputs_and_prediction(
            tb, schema, tm, to_torch(prediction))),
        jax_masking.merge_inputs_and_prediction(
            jb, schema, jm, to_jax(prediction)),
        0, 0,
    )


def test_select_single_element_matches_jax():
    """Same uniforms in, same element out (the draw is injected)."""
    seq_mask = np.arange(50)[None, :] < np.array([[1], [7], [50], [0]])
    key = jax.random.PRNGKey(11)
    u = np.asarray(jax.random.uniform(key, (4,)))
    want = jax_masking.select_single_element(jnp.asarray(seq_mask), key)
    got = port_masking.select_single_element(
        torch.from_numpy(seq_mask), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        port_masking.select_single_element(
            torch.from_numpy(seq_mask), select_last=True).numpy(),
        np.asarray(jax_masking.select_single_element(
            jnp.asarray(seq_mask), key, select_last=True)),
    )


@pytest.mark.parametrize("task", ["elem", "pos", "attr", "type"])
def test_build_task_masks_matches_jax(crello_spec, task):
    schema = crello_spec.schema
    batch = numpy_batch(crello_spec)
    element = np.array([0, 1, 2, 0], np.int32) if task == "elem" else None
    want = jax_demo.build_task_masks(
        schema, to_jax(batch), task,
        element=None if element is None else jnp.asarray(element),
    )
    got = port_demo.build_task_masks(
        schema, to_torch(batch), task,
        element=None if element is None else torch.from_numpy(element),
    )
    assert_trees_close(to_numpy(got), want, 0, 0)


def _models(schema, context, sample):
    jax_model = jax_mfp.MFPModel(
        schema, latent_dim=D, num_blocks=BLOCKS, num_heads=HEADS,
        context=context, attention_impl="xla",
    )
    params = jax.jit(lambda: jax_init_params(jax_model, sample, seed=0))()
    port_model = port_mfp.MFPModel(
        schema, latent_dim=D, num_blocks=BLOCKS, num_heads=HEADS,
        context=context,
    ).eval()
    load_jax_params(port_model, flat_params(params))
    return jax_model, params, port_model


@pytest.mark.parametrize("dataset,context", [("crello", None), ("rico", "id")])
@pytest.mark.parametrize("task", ["pos", "attr", "elem"])
def test_forward_eval_matches_jax(request, dataset, context, task):
    """The slice: task masks -> forward_eval -> merged predictions."""
    spec = _spec(request, dataset)
    schema = spec.schema
    batch = numpy_batch(spec)
    jax_model, params, port_model = _models(schema, context, batch)
    element = np.array([0, 1, 0, 2], np.int32) if task == "elem" else None
    jax_masks = jax_demo.build_task_masks(
        schema, to_jax(batch), task,
        element=None if element is None else jnp.asarray(element),
    )
    port_masks = port_demo.build_task_masks(
        schema, to_torch(batch), task,
        element=None if element is None else torch.from_numpy(element),
    )
    tasks = None
    if context == "id":
        tasks = np.full(4, schema.task_names.index(task), np.int32)
    want = jax_mfp.forward_eval(
        jax_model, params, to_jax(batch), jax_masks,
        tasks=None if tasks is None else jnp.asarray(tasks),
    )
    got = port_mfp.forward_eval(
        port_model, to_torch(batch), port_masks,
        tasks=None if tasks is None else torch.from_numpy(tasks),
    )
    assert set(got) == set(want)
    assert_trees_close(to_numpy(got), want, **SLICE_TOL)
    # the masked fields really were predicted (not all ground truth)
    masked = [c for c in schema.sequence_columns if port_masks[c.name].any()]
    assert masked


def test_forward_eval_refuses_a_noise_model(crello_spec):
    """A ``use_elemwise_noise`` model draws noise only in training: JAX's
    forward_eval has no noise rng for it and fails; the port says why."""
    schema = crello_spec.schema
    batch = numpy_batch(crello_spec, 2)
    jax_model, params, port_model = model_pair(
        schema, batch, num_blocks=1, use_elemwise_noise=True)
    masks = port_demo.build_task_masks(schema, to_torch(batch), "pos")
    with pytest.raises(Exception, match="noise"):
        jax_mfp.forward_eval(jax_model, params, to_jax(batch),
                             to_jax(to_numpy(masks)))
    for num_iter in (1, 2):
        with pytest.raises(ValueError, match="use_elemwise_noise"):
            port_mfp.forward_eval(port_model, to_torch(batch), masks,
                                  num_iter=num_iter)
