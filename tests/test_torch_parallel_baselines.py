"""The four baselines tensor-parallel, held to the JAX package's mesh.

* ``partition_spec`` gives JAX's layout for every parameter of crello
  CanvasVAE, LayoutVAE, AutoReg and BART at their published widths, at
  M = 2 and 4: the attention projections of every block (BART's
  ``CrossBlock`` self- and cross-attention too), ``mlp_0`` / ``mlp_1``,
  the ``conditional`` Dense, the decoder heads and the encoder tables
  split; the CVAE layers, ``prior_head``, ``length_fc``, ``bos`` and the
  position tables whole.
* One SGD step of each baseline's training branch (the tiny crello-like
  schema of ``tests/test_masking.py``, S=6; D=16, 2 blocks, 2 heads,
  batch 4; dropout 0, no VAE noise; the ``*_loss`` terms,
  L2 and the per-tensor clip) from the same weights (through
  ``convert.py``), inputs and masks: the port on one data rank by 2 model
  ranks (2 CPU ranks under gloo) against the port alone (loss 1e-5
  relative, parameters 1e-6) and against JAX's ``make_mesh(8,
  model_parallel=2)`` step (loss 1e-4 relative, parameters 2e-4 relative
  + 1e-5), ``tests/test_torch_parallel.py``'s bars; both ranks end with
  the same parameters, bit for bit.
* AutoReg's ``elem`` sums over those 4 documents on the 1 x 2 grid (its
  decode in lockstep on both model ranks) equal the sums alone to 1e-5.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import traverse_util  # noqa: E402

from flexdm_tpu.models import baselines as jax_baselines  # noqa: E402
from flexdm_tpu.models import mfp as jax_mfp  # noqa: E402
from flexdm_tpu.models.baselines import cvae as jax_cvae  # noqa: E402
from flexdm_tpu.parallel import mesh as jax_mesh  # noqa: E402
from flexdm_tpu.train import optim as jax_optim  # noqa: E402
from flexdm_tpu_torch.convert import init_params, params_to_jax  # noqa: E402
from flexdm_tpu_torch.models import baselines as port_baselines  # noqa: E402
from flexdm_tpu_torch.parallel import mesh  # noqa: E402
from tests import _torch_ranks as ranks  # noqa: E402
from tests._torch_baselines import (  # noqa: E402
    _jax_loss,
    schema_inputs,
    zero_normal_jax,
)
from tests._torch_parity import (  # noqa: E402
    assert_partition_specs_match_jax,
    flat_params,
    to_jax,
)

LR, L2 = 1e-2, 1e-2
ELEM_CHUNK = 8  # the 4 documents' replicas in chunks of 8
SIZES = dict(latent_dim=16, num_blocks=1, num_heads=2, dropout=0.0)
PRESETS = ("crello_canvasvae", "crello_layoutvae", "crello_autoreg",
           "crello_bart")
# AutoReg first: the ranks also score its ``elem`` task.
NAMES = ("AutoReg", "CanvasVAE", "LayoutVAE", "BART")
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("preset", PRESETS)
def test_partition_spec_matches_jax(request, preset, model_size):
    with open(os.path.join(CONFIGS, preset + ".json")) as f:
        args = json.load(f)
    dataset = args["dataset_name"]
    got = assert_partition_specs_match_jax(
        args, request.getfixturevalue(f"{dataset}_spec"),
        request.getfixturevalue(f"{dataset}_dir"), model_size)
    assert any(".query.weight" in n for n in got)
    assert any(n.startswith("decoder.decoder_") for n in got)
    assert any(n.startswith("encoder.input_") for n in got)
    if preset == "crello_bart":
        for part in ("self_attn.query", "cross_attn.key", "mlp_0", "mlp_1"):
            assert f"dec_blocks.cross_0.{part}.weight" in got, part
    if preset == "crello_canvasvae":
        assert "blocks.seq2seq_0.conditional.weight" in got
    assert not any(n.startswith(("encoder_cvae.", "decoder_cvae.",
                                 "prior.", "prior_head.", "length_fc."))
                   for n in got)


@pytest.fixture(scope="module")
def setup():
    """Per baseline: the port's initial weights (flax-named numpy) and the
    JAX model; the batch, masks and masked inputs (numpy)."""
    schema, targets, masks, modified = schema_inputs()
    inputs = dict(modified=modified, targets=targets, masks=masks)
    weights = {name: {k: np.array(v) for k, v in params_to_jax(init_params(
        getattr(port_baselines, name)(ranks.tiny_schema(), **SIZES), 0)
        .state_dict()).items()} for name in NAMES}
    models = {name: getattr(jax_baselines, name)(
        schema=schema, attention_impl="xla", **SIZES) for name in NAMES}
    return dict(schema=schema, inputs=inputs, weights=weights, models=models)


@pytest.fixture(scope="module", autouse=True)
def spawned(setup):
    """The 2 ranks' steps, started when the module starts (the spawn runs
    while the other tests do): a future of each rank's ``{name:
    result}``."""
    cases = [(name, setup["weights"][name], setup["inputs"])
             for name in NAMES]
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(mesh.spawn, ranks.baseline_step_worker, 2,
                          (2, 2, cases, LR, L2, SIZES, ELEM_CHUNK),
                          timeout=ranks.TIMEOUT_S, cpu=True)


@pytest.fixture(scope="module")
def rank_results(spawned):
    return spawned.result()


@pytest.fixture(scope="module")
def alone(setup):
    """The port's step of each baseline in this process."""
    return {name: ranks.baseline_step(
                None, ranks.tiny_schema(), name, setup["weights"][name],
                setup["inputs"], LR, L2, SIZES,
                ELEM_CHUNK if name == NAMES[0] else None)
            for name in NAMES}


def _jax_step(setup, name, model_parallel):
    """JAX's step of ``name`` on ``make_mesh(8, model_parallel)``: the
    whole parameters after it and the loss.  Compiled at XLA's lowest
    optimisation level, which halves LayoutVAE's compile."""
    schema, inputs = setup["schema"], setup["inputs"]
    model = setup["models"][name]
    m = jax_mesh.make_mesh(8, model_parallel=model_parallel)
    variables = jax_mesh.shard_params(traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in setup["weights"][name].items()},
        sep="/"), m)
    modified, targets, masks = (jax_mesh.shard_batch(to_jax(inputs[k]), m)
                                for k in ("modified", "targets", "masks"))
    key = jax.random.PRNGKey(0)

    def loss_fn(v):
        outputs, aux = jax_mfp.apply_model(
            model, v, modified, targets, masks, deterministic=False,
            rngs={"dropout": key, "vae": key})
        return (_jax_loss(schema, targets, outputs, masks, aux)
                + L2 * jax_optim.l2_penalty(v))

    tx = optax.chain(jax_optim.clip_by_per_leaf_norm(1.0), optax.sgd(LR))
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_cvae, "jax", zero_normal_jax())
        loss, grads = jax.jit(jax.value_and_grad(loss_fn), compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True})(variables)
    updates, _ = tx.update(grads, tx.init(variables), variables)
    return flat_params(optax.apply_updates(variables, updates)), float(loss)


def _assert_close(got, want, rtol, atol):
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_tensor_parallel_step_matches_alone(rank_results, alone, name):
    first, second = (r[name] for r in rank_results)
    assert set(first["params"]) == set(second["params"])
    for k, v in first["params"].items():
        np.testing.assert_array_equal(second["params"][k], v, err_msg=k)
    assert any(".query." in n for n in first["split"])
    want = alone[name]
    assert not want["split"]
    np.testing.assert_allclose(first["loss"], want["loss"], rtol=1e-5)
    _assert_close(first["params"], want["params"], 0, 1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_tensor_parallel_step_matches_jax_mesh(setup, rank_results, name):
    want_params, want_loss = _jax_step(setup, name, 2)
    got = rank_results[0][name]
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-4)
    _assert_close(got["params"], want_params, 2e-4, 1e-5)


def test_tensor_parallel_autoreg_elem_matches_alone(rank_results, alone):
    want = alone["AutoReg"]["eval"]
    assert want
    for rank in rank_results:
        got = rank["AutoReg"]["eval"]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
