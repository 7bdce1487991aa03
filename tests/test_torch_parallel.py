"""The port on more than one device, held to the JAX package's mesh.

* ``partition_spec`` gives JAX's layout for every parameter of crello and
  rico Ours-EXP and crello_flat at M = 2 and 4.
* One training step (rico, ``tests/test_parallel.py``'s setup with dropout
  0, SGD with the per-tensor clip as in JAX's mesh tests, L2 on), from the
  same weights (through ``convert.py``), batch and draws: the port on 2
  and 4 CPU ranks under gloo, data-parallel and tensor-parallel (one data
  rank by M = 2 and 4 model ranks), against the port's single-process
  step, against each other, and against JAX's ``make_mesh(8)`` and
  ``make_mesh(8, model_parallel=M)`` steps at JAX's tolerances there
  (loss 1e-4 relative; parameters 2e-4 relative + 1e-5).  The port's
  layouts agree with one another to 1e-5 (loss) and 1e-6 (parameters),
  and every rank ends with the same parameters, bit for bit.
* The clip on split parameters takes the whole tensor's norm: a split
  leaf whose whole gradient has norm > 1 is clipped to norm 1, though each
  of its shards has norm < 1.
* A tensor-parallel ``evaluate_task`` gives the single-device sums to
  1e-5.
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

from flexdm_tpu.data import split_device_batch  # noqa: E402
from flexdm_tpu.models import mfp as jax_mfp  # noqa: E402
from flexdm_tpu.ops import rng as jax_rng  # noqa: E402
from flexdm_tpu.parallel import mesh as jax_mesh  # noqa: E402
from flexdm_tpu.train import optim as jax_optim  # noqa: E402
from flexdm_tpu.train import trainer as jax_trainer  # noqa: E402
from flexdm_tpu_torch.config import TrainConfig as PortConfig  # noqa: E402
from flexdm_tpu_torch.convert import init_params, params_to_jax  # noqa: E402
from flexdm_tpu_torch.data import DatasetSpec as PortSpec  # noqa: E402
from flexdm_tpu_torch.models import masking as port_masking  # noqa: E402
from flexdm_tpu_torch.models import mfp as port_mfp  # noqa: E402
from flexdm_tpu_torch.parallel import mesh  # noqa: E402
from flexdm_tpu_torch.train.trainer import check_config  # noqa: E402
from tests import _torch_ranks as ranks  # noqa: E402
from tests._torch_parity import (  # noqa: E402
    assert_partition_specs_match_jax,
    flat_params,
)

LR, L2, B = 1e-2, 1e-2, 16
METHOD = "elem_pos_attr"
SIZES = dict(latent_dim=32, num_blocks=1, num_heads=4, dropout=0.0)
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
PRESETS = ("crello_ours_exp", "rico_ours_exp", "crello_flat")


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("preset", PRESETS)
def test_partition_spec_matches_jax(request, preset, model_size):
    """Every parameter at the preset's published widths: the port's spec
    of its torch name and shape is JAX's spec of the flax leaf (reversed
    for a Dense kernel, which the port stores transposed)."""
    with open(os.path.join(CONFIGS, preset + ".json")) as f:
        args = json.load(f)
    dataset = args["dataset_name"]
    assert assert_partition_specs_match_jax(
        args, request.getfixturevalue(f"{dataset}_spec"),
        request.getfixturevalue(f"{dataset}_dir"), model_size)


def test_split_attention_needs_whole_heads(crello_dir):
    """A rank's slice of the query features must be whole heads."""
    model = port_mfp.MFPModel(PortSpec("crello", crello_dir).schema,
                              latent_dim=32, num_blocks=1, num_heads=4)
    grid = mesh.Grid(0, 8, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide num_heads 4"):
        mesh.shard_params(model, grid)


def test_model_parallel_needs_num_devices():
    """JAX's ``make_mesh(None, M)`` takes every device; the port's
    ``num_devices=None`` is one process without a group, so ``M > 1``
    there is refused before anything is written."""
    with pytest.raises(ValueError, match="needs --num_devices"):
        check_config(PortConfig(model_parallel=2))
    with pytest.raises(ValueError, match="must divide --num_devices 3"):
        check_config(PortConfig(num_devices=3, model_parallel=2))


def _jax_step_draws(schema, batch, base_key, n_tasks):
    """The draws JAX's ``make_train_step`` makes at step 0 (besides the
    fused uniforms, which the test passes in), as numpy."""

    @jax.jit
    def draw(base_key):
        key = jax.random.fold_in(base_key, 0)
        k_task, _, k_mask, _, _, _ = jax.random.split(key, 6)
        k_random, k_elem = jax.random.split(k_mask)
        values = {}
        for i, column in enumerate(schema.modeled):
            if not column.is_sequence:
                continue
            x = batch[column.name]
            k = jax.random.fold_in(k_random, i)
            if column.is_categorical:
                values[column.name] = jax_rng.randint(
                    k, x.shape, 0, column.input_dim, x.dtype)
            else:
                values[column.name] = 0.1 * jax_rng.normal(
                    k, x.shape, dtype=x.dtype)
        gumbel = jax.random.gumbel(k_task, (B, n_tasks), jnp.float32)
        return gumbel, jax.random.uniform(k_elem, (B,)), values

    gumbel, element, values = jax.device_get(draw(base_key))
    return (np.array(gumbel), np.array(element),
            {k: np.array(v) for k, v in values.items()})


@pytest.fixture(scope="module")
def setup(rico_spec, rico_dir):
    """The batch, the port's initial weights (flax-named numpy), the
    step's draws (numpy, global batch) and the JAX model and key."""
    schema = rico_spec.schema
    batch = {k: np.asarray(v) for k, v in split_device_batch(
        next(iter(rico_spec.make_dataset("train", batch_size=B)))).items()}
    port_model = init_params(port_mfp.MFPModel(
        PortSpec("rico", rico_dir).schema, **SIZES), 0)
    weights = {k: np.array(v)
               for k, v in params_to_jax(port_model.state_dict()).items()}
    jax_model = jax_mfp.MFPModel(schema, attention_impl="xla", **SIZES)
    task_config = jax_mfp.make_task_config(schema, METHOD)
    uniforms = np.random.default_rng(0).random(
        port_masking.train_draw_shape(schema, B)).astype(np.float32)
    base_key = jax.random.PRNGKey(5)
    gumbel, element, values = _jax_step_draws(
        schema, {k: jnp.asarray(v) for k, v in batch.items()}, base_key,
        len(task_config.task_probs))
    tasks = port_masking.sample_tasks(torch.from_numpy(gumbel),
                                      task_config.task_probs)
    assert len(set(tasks.tolist())) > 1
    draws = {"tasks": tasks.numpy(), "uniforms": uniforms,
             "element": element, "values": values, "shuffle": None}
    return dict(batch=batch, weights=weights, draws=draws,
                jax_model=jax_model, task_config=task_config,
                uniforms=uniforms, base_key=base_key)


def _jax_step(setup, model_parallel=None):
    """JAX's step on ``make_mesh(8, model_parallel)``: whole parameters
    after it and the loss."""
    params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in setup["weights"].items()}, sep="/")
    tx = optax.chain(jax_optim.clip_by_per_leaf_norm(1.0), optax.sgd(LR))
    state = jax_trainer.TrainState(params=params, opt_state=tx.init(params),
                                   step=jnp.asarray(0))
    m = jax_mesh.make_mesh(8, model_parallel=model_parallel or 1)
    state = jax_mesh.shard_state(state, m)
    batch = jax_mesh.shard_batch(
        {k: jnp.asarray(v) for k, v in setup["batch"].items()}, m)
    step = jax.jit(jax_trainer.make_train_step(
        setup["jax_model"], setup["task_config"], tx, L2))
    new_state, metrics = step(state, batch, setup["base_key"],
                              jnp.asarray(setup["uniforms"]))
    return flat_params(new_state.params), float(metrics["loss"])


@pytest.fixture(scope="module")
def steps(setup, rico_dir):
    """``"jax"``: JAX's step on the mesh per ``model_parallel`` 1, 2, 4;
    ``"port"``: ``{(world, model_parallel): [each rank's result]}`` from 2
    and 4 CPU ranks, ``(1, 1)`` the port's single-process step and
    ``"eval"`` its single-process eval sums.  The ranks run while JAX
    compiles."""
    pos = tuple(PortSpec("rico", rico_dir).schema.attribute_groups["pos"])
    args = (setup["weights"], setup["batch"], setup["draws"], METHOD, LR,
            L2, SIZES)
    layouts = {world: (1, world) for world in (2, 4)}
    with ThreadPoolExecutor(2) as pool:
        spawned = {world: pool.submit(
            mesh.spawn, ranks.step_worker, world,
            (world, layouts[world], rico_dir, "rico") + args + (
                ("pos", pos),),
            timeout=ranks.TIMEOUT_S, cpu=True) for world in layouts}
        jax_out = {m: _jax_step(setup, m) for m in (1, 2, 4)}
        port = {}
        for world, future in spawned.items():
            for i, m in enumerate(layouts[world]):
                port[world, m] = [r[i] for r in future.result()]
    single = PortSpec("rico", rico_dir, 16)
    port[1, 1] = [ranks.step_on_grid(None, single, *args)]
    port["eval"] = ranks.task_sums(
        ranks.build(single, setup["weights"], SIZES),
        single.make_dataset("test", batch_size=16), "pos", ("pos", pos))
    return {"jax": jax_out, "port": port}


@pytest.fixture(scope="module")
def jax_steps(steps):
    return steps["jax"]


@pytest.fixture(scope="module")
def port_steps(steps):
    return steps["port"]


def _assert_ranks_agree(results):
    first = results[0]["params"]
    for other in results[1:]:
        assert set(other["params"]) == set(first)
        for k in first:
            np.testing.assert_array_equal(other["params"][k], first[k],
                                          err_msg=k)


def _assert_close(got, want, rtol, atol):
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_matches_single_process(port_steps, world):
    results = port_steps[world, 1]
    _assert_ranks_agree(results)
    single = port_steps[1, 1][0]
    assert set(results[0]["metrics"]) == set(single["metrics"])
    for k, v in single["metrics"].items():  # losses, num/den sums, scores
        np.testing.assert_allclose(results[0]["metrics"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _assert_close(results[0]["params"], single["params"], 0, 1e-6)
    assert not results[0]["split"]


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_matches_jax_mesh(port_steps, jax_steps, world):
    want_params, want_loss = jax_steps[1]
    got = port_steps[world, 1][0]
    np.testing.assert_allclose(got["metrics"]["loss"], want_loss, rtol=1e-4)
    _assert_close(got["params"], want_params, 2e-4, 1e-5)


@pytest.mark.parametrize("model_parallel", [2, 4])
def test_tensor_parallel_matches_data_parallel(port_steps, model_parallel):
    """One data rank by M model ranks against M data ranks: the same step
    in another layout; M = 4 puts one head on each rank."""
    results = port_steps[model_parallel, model_parallel]
    _assert_ranks_agree(results)
    assert any(".attn.query." in n for n in results[0]["split"])
    assert any(n.startswith("decoder.decoder_") for n in results[0]["split"])
    assert any(n.startswith("encoder.input_") for n in results[0]["split"])
    dp = port_steps[model_parallel, 1][0]
    np.testing.assert_allclose(results[0]["metrics"]["loss"],
                               dp["metrics"]["loss"], rtol=1e-5)
    _assert_close(results[0]["params"], dp["params"], 0, 1e-6)


@pytest.mark.parametrize("model_parallel", [2, 4])
def test_tensor_parallel_matches_jax_mesh(port_steps, jax_steps,
                                          model_parallel):
    want_params, want_loss = jax_steps[model_parallel]
    got = port_steps[model_parallel, model_parallel][0]
    np.testing.assert_allclose(got["metrics"]["loss"], want_loss, rtol=1e-4)
    _assert_close(got["params"], want_params, 2e-4, 1e-5)


def test_clip_takes_the_whole_tensors_norm(port_steps, setup):
    """A split leaf whose whole gradient has norm > 1: its SGD update is
    ``lr`` times the gradient clipped to norm 1, though no shard alone
    reaches norm 1 (a per-shard clip would have left it as it was)."""
    got = port_steps[2, 2][0]
    bound = []
    for name in got["split"]:
        *modules, leaf = name.split(".")
        kernel = leaf == "weight"
        key = "/".join(["params", *modules, "kernel" if kernel else leaf])
        delta = (got["params"][key] - setup["weights"][key]) / LR
        if kernel:  # the port's (out, in) layout
            delta = delta.T
        dim = mesh.split_dim(mesh.partition_spec(name, delta.shape, 2))
        shards = np.split(delta, 2, axis=dim)
        if abs(np.linalg.norm(delta) - 1.0) < 1e-4 and all(
                np.linalg.norm(h) < 0.999 for h in shards):
            bound.append(name)
    assert bound, "no split leaf was clipped by its whole norm"


@pytest.mark.parametrize("model_parallel", [2, 4])
def test_tensor_parallel_eval_matches_single_device(port_steps,
                                                    model_parallel):
    got = port_steps[model_parallel, model_parallel][0]["eval"]
    want = port_steps["eval"]
    assert set(got) == set(want) and want
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
