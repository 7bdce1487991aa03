"""Port optimizer against the JAX package: per-tensor clip + keras Adam
against the optax chain of ``make_optimizer`` over 3 steps on the same
gradients (parameters within 1e-7), and ``l2_penalty`` on the same
weights."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import traverse_util  # noqa: E402

from flexdm_tpu.models import mfp as jax_mfp  # noqa: E402
from flexdm_tpu.train import optim as jax_optim  # noqa: E402
from flexdm_tpu.train.trainer import init_params as jax_init_params  # noqa: E402
from flexdm_tpu_torch.convert import load_jax_params  # noqa: E402
from flexdm_tpu_torch.models.mfp import MFPModel  # noqa: E402
from flexdm_tpu_torch.train import optim as port_optim  # noqa: E402
from tests._torch_parity import numpy_batch  # noqa: E402

LR = 1e-4
SHAPES = {"a": (3, 4), "b": (7,), "c": (2, 5, 3), "d": (6,)}


def _grads(rng, step):
    """Gradients over a wide range: tiny (eps matters), ordinary, large
    (clipped), one exactly zero leaf."""
    scales = {"a": 1e-6, "b": 0.05, "c": 10.0 ** step, "d": 0.0}
    return {k: (scales[k] * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def test_clip_and_keras_adam_match_optax_chain():
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    tx = jax_optim.make_optimizer(LR, clipnorm=1.0)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jax_params)
    port_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    adam = port_optim.KerasAdam(port_params.values(), LR)
    for step in range(3):
        grads = _grads(rng, step)
        updates, state = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        port_grads = [torch.from_numpy(grads[k].copy()) for k in port_params]
        port_optim.clip_by_per_leaf_norm(port_grads, 1.0)
        adam.step(port_grads)
        for k in SHAPES:
            np.testing.assert_allclose(
                port_params[k].numpy(), np.asarray(jax_params[k]),
                rtol=0, atol=1e-7, err_msg=f"step {step + 1}: {k}",
            )
    assert adam.count == 3


def test_clip_by_per_leaf_norm():
    grads = [torch.tensor([3.0, 4.0]), torch.tensor([0.1, 0.0])]
    port_optim.clip_by_per_leaf_norm(grads, 1.0)
    np.testing.assert_allclose(grads[0].numpy(), [0.6, 0.8], rtol=1e-6)
    np.testing.assert_allclose(grads[1].numpy(), [0.1, 0.0], rtol=1e-6)


def test_l2_penalty_matches_jax(crello_spec):
    """Same random weights in both packages (LayerNorm parameters too,
    which both leave out)."""
    schema = crello_spec.schema
    jax_model = jax_mfp.MFPModel(schema, latent_dim=32, num_blocks=2,
                                 num_heads=4, attention_impl="xla")
    shapes = traverse_util.flatten_dict(jax_init_params(
        jax_model, numpy_batch(crello_spec, 2), 0, abstract=True), sep="/")
    rng = np.random.default_rng(1)
    flat = {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in shapes.items()}
    model = load_jax_params(MFPModel(schema, latent_dim=32, num_blocks=2,
                                     num_heads=4), flat)
    tree = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    np.testing.assert_allclose(
        port_optim.l2_penalty(model).item(),
        float(jax_optim.l2_penalty(tree)), rtol=1e-6,
    )
    assert not any(p is q for p in port_optim.regularized(model)
                   for m in model.modules()
                   if isinstance(m, torch.nn.LayerNorm)
                   for q in m.parameters())
