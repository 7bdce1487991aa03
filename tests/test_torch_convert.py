"""The weight bridge between the flax tree and the port's state_dict, and
the port's initialisation."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flax import traverse_util  # noqa: E402

from flexdm_tpu.models import mfp as jax_mfp  # noqa: E402
from flexdm_tpu.train.trainer import init_params as jax_init_params  # noqa: E402
from flexdm_tpu_torch.convert import (  # noqa: E402
    init_params,
    load_jax_params,
    load_weights,
    params_from_jax,
    params_to_jax,
    save_weights,
)
from flexdm_tpu_torch.models.mfp import MFPModel  # noqa: E402
from tests._torch_parity import numpy_batch  # noqa: E402


def _port_model(schema, context=None, seed=0):
    return init_params(MFPModel(schema, latent_dim=32, num_blocks=2,
                                num_heads=4, context=context), seed)


@pytest.mark.parametrize("dataset", ["crello", "rico"])
@pytest.mark.parametrize("context", [None, "id"])
def test_port_names_cover_the_jax_tree(request, dataset, context):
    """Every leaf of the JAX MFPModel tree maps onto the port model (and
    back) with the same shape; nothing is left over on either side."""
    spec = request.getfixturevalue(f"{dataset}_spec")
    jax_model = jax_mfp.MFPModel(spec.schema, latent_dim=32, num_blocks=2,
                                 num_heads=4, context=context)
    shapes = traverse_util.flatten_dict(jax_init_params(
        jax_model, numpy_batch(spec, 2), 0, abstract=True), sep="/")
    port_flat = params_to_jax(_port_model(spec.schema, context).state_dict())
    assert set(port_flat) == set(shapes)
    for name, value in shapes.items():
        assert port_flat[name].shape == value.shape, name
        assert port_flat[name].dtype == value.dtype, name
    load_jax_params(_port_model(spec.schema, context), {
        name: np.zeros(v.shape, v.dtype) for name, v in shapes.items()
    })


@pytest.mark.parametrize("dataset,variant", [
    ("crello", dict(context="length")),
    ("crello", dict(context="canvas")),
    ("crello", dict(context="canvas_add")),
    ("rico", dict(input_dtype="shuffled_set", context="id")),
    ("crello", dict(input_dtype="sorted_set", use_elemwise_noise=True)),
    ("crello", dict(seq_type="flat", input_dtype="shuffled_set")),
    ("rico", dict(seq_type="flat", input_dtype="shuffled_set")),
], ids=["length", "canvas", "canvas_add", "shuffled-id", "sorted-noise",
        "flat-crello", "flat-rico"])
def test_port_names_cover_every_variant(request, dataset, variant):
    """The same for every other oneshot variant: the position tables
    (``emb_seq_pos``, ``input_const``), ``input_length``, the canvas
    columns' tables and heads, ``input_noise``; a missing or extra leaf
    fails."""
    spec = request.getfixturevalue(f"{dataset}_spec")
    sizes = dict(latent_dim=32, num_blocks=2, num_heads=4)
    shapes = traverse_util.flatten_dict(jax_init_params(
        jax_mfp.MFPModel(spec.schema, **sizes, **variant),
        numpy_batch(spec, 2), 0, abstract=True), sep="/")
    port = init_params(MFPModel(spec.schema, **sizes, **variant), 0)
    port_flat = params_to_jax(port.state_dict())
    assert set(port_flat) == set(shapes)
    for name, value in shapes.items():
        assert port_flat[name].shape == value.shape, name
    load_jax_params(MFPModel(spec.schema, **sizes, **variant), {
        name: np.zeros(v.shape, v.dtype) for name, v in shapes.items()
    })


@pytest.mark.parametrize("dataset", ["crello", "rico"])
def test_round_trip_is_bit_exact(request, dataset):
    schema = request.getfixturevalue(f"{dataset}_spec").schema
    flat = params_to_jax(_port_model(schema, "id").state_dict())
    back = params_to_jax(params_from_jax(flat))
    assert set(back) == set(flat)
    for name, value in flat.items():
        assert back[name].dtype == value.dtype
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    model = load_jax_params(
        MFPModel(schema, latent_dim=32, num_blocks=2, num_heads=4,
                 context="id"), flat)
    for name, value in params_to_jax(model.state_dict()).items():
        np.testing.assert_array_equal(value, flat[name], err_msg=name)


def test_unused_missing_and_foreign_leaves_raise(crello_spec):
    schema = crello_spec.schema
    flat = params_to_jax(_port_model(schema).state_dict())
    extra = dict(flat, **{"params/encoder/input_nonsense": np.zeros(3)})
    with pytest.raises(RuntimeError, match="input_nonsense"):
        load_jax_params(_port_model(schema), extra)
    missing = dict(flat)
    del missing["params/decoder/decoder_type/bias"]
    with pytest.raises(RuntimeError, match="decoder_type.bias"):
        load_jax_params(_port_model(schema), missing)
    with pytest.raises(KeyError):
        params_from_jax({"batch_stats/encoder/x": np.zeros(3)})
    with pytest.raises(ValueError, match="rank"):
        params_from_jax({"params/a/kernel": np.zeros(3)})


def test_init_params_follows_keras_defaults(crello_spec):
    model = _port_model(crello_spec.schema, "id", seed=3)
    for module in model.modules():
        if isinstance(module, torch.nn.Linear):
            fan_out, fan_in = module.weight.shape
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            assert module.weight.abs().max() <= limit
            assert module.weight.abs().max() > 0.5 * limit
            assert torch.all(module.bias == 0)
        elif isinstance(module, torch.nn.LayerNorm):
            assert torch.all(module.weight == 1) and torch.all(module.bias == 0)
    for name in ("input_type", "input_task", "input_image_embedding_special"):
        table = getattr(model.encoder, name)
        assert 0.03 < table.abs().max() <= 0.05, name
    again = params_to_jax(_port_model(crello_spec.schema, "id", 3).state_dict())
    other = params_to_jax(_port_model(crello_spec.schema, "id", 4).state_dict())
    mine = params_to_jax(model.state_dict())
    assert all(np.array_equal(mine[k], again[k]) for k in mine)
    assert not np.array_equal(mine["params/encoder/input_type"],
                              other["params/encoder/input_type"])


def test_weight_file_round_trip(crello_spec, tmp_path):
    model = _port_model(crello_spec.schema)
    path = str(tmp_path / "best.torch.npz")
    save_weights(path, model)
    loaded = load_weights(path, MFPModel(crello_spec.schema, latent_dim=32,
                                         num_blocks=2, num_heads=4))
    for (name, a), b in zip(model.state_dict().items(),
                            loaded.state_dict().values()):
        assert torch.equal(a, b), name


def test_exported_baseline_weights_load(tmp_path):
    """A JAX baseline's parameters, written as ``tools/export_torch_weights.py``
    writes them (``flatten_params``, ``np.savez``), load into the port's
    model through ``load_weights`` bit for bit: BART's tree holds ``bos``
    (rank 3), the cross-attention blocks and the encoder blocks."""
    import jax

    from flexdm_tpu.models.baselines import BART
    from flexdm_tpu_torch.models.baselines import BART as PortBART
    from tests.test_masking import tiny_inputs, tiny_schema
    from tools.export_torch_weights import flatten_params

    schema = tiny_schema()
    x = tiny_inputs(schema=schema)
    masks = {c.name: x["left"][..., 0] >= 0 if c.is_sequence
             else np.ones(4, bool) for c in schema.modeled}
    model = BART(schema=schema, latent_dim=16, num_blocks=2, num_heads=2,
                 attention_impl="xla")
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params",
                                                            "dropout"))}
    flat = flatten_params(jax.jit(lambda: model.init(
        rngs, x, x, masks, deterministic=False))())
    path = str(tmp_path / "best.torch.npz")
    with open(path, "wb") as f:
        np.savez(f, **flat)
    port = load_weights(path, PortBART(schema, latent_dim=16, num_blocks=2,
                                       num_heads=2))
    back = params_to_jax(port.state_dict())
    assert set(back) == set(flat) and back["params/bos"].shape == (1, 1, 16)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
