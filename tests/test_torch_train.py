"""The port's training step and trainer against the JAX package.

* One whole step through ``flexdm_tpu.train.trainer.make_train_step``
  (dropout 0, the same weights through ``convert.py``, the same draws):
  loss and every metric within 1e-5 relative; every clipped gradient leaf
  (read from Adam's first moment, ``mu = 0.1 * g``; each leaf has norm
  <= 1) within 5e-6, a bound set by the attention key biases, whose exact
  gradient is 0 and whose computed one is float32 round-off of a few 1e-6
  in either package; the updated parameters within 1e-6 where |g| > 1e-3 in
  both packages.  Where |g| is tiny the first keras-Adam step is about
  +-lr whatever g is, so a sign flip of a near-zero gradient moves a
  parameter by up to 2 lr: the bound used there is 2 lr + 1e-6.
* Validation scores that do not change with the batch size (the JAX
  package's ``test_val_scores_invariant_to_batch_size``).
* The same step for rico Ours-EXP (``sort_flag`` live) and crello_flat
  (the shuffle uniforms JAX drew handed to the port).
* A CPU ``train()`` of 2 epochs whose ``best`` the port's engine serves,
  one epoch of the rico and flat presets, and the CLI's refusals
  (``--dtype float16``: no kernel instance computes in it).
"""

import json
import logging
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from flexdm_tpu.models import mfp as jax_mfp  # noqa: E402
from flexdm_tpu.ops import rng as jax_rng  # noqa: E402
from flexdm_tpu.train import optim as jax_optim  # noqa: E402
from flexdm_tpu.train import trainer as jax_trainer  # noqa: E402
from flexdm_tpu_torch import cli  # noqa: E402
from flexdm_tpu_torch.convert import init_params, params_to_jax  # noqa: E402
from flexdm_tpu_torch.models import masking as port_masking  # noqa: E402
from flexdm_tpu_torch.models import mfp as port_mfp  # noqa: E402
from flexdm_tpu_torch.serve import InferenceEngine, _jsonable  # noqa: E402
from flexdm_tpu_torch.train import optim as port_optim  # noqa: E402
from flexdm_tpu_torch.train import trainer as port_trainer  # noqa: E402
from tests._torch_parity import flat_params, numpy_batch, to_jax, to_torch  # noqa: E402

LR, L2 = 1e-4, 1e-2
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
METHOD = "random_elem_type_pos_attr_img_txt"  # every task of crello


def _jax_step_draws(schema, batch, base_key, n_tasks):
    """The draws ``make_train_step`` makes at step 0 (besides the fused
    uniforms, which the test passes in), as numpy."""

    @jax.jit
    def draw(base_key):
        key = jax.random.fold_in(base_key, 0)
        k_task, k_shuffle, k_mask, _, _, _ = jax.random.split(key, 6)
        k_random, k_elem = jax.random.split(k_mask)
        b = batch["length"].shape[0]
        values = {}
        for i, column in enumerate(schema.modeled):
            if not column.is_sequence:
                continue
            x = batch[column.name]
            k = jax.random.fold_in(k_random, i)
            if column.is_categorical:  # train=True: the fast_rng draws
                values[column.name] = jax_rng.randint(
                    k, x.shape, 0, column.input_dim, x.dtype)
            else:
                values[column.name] = 0.1 * jax_rng.normal(
                    k, x.shape, dtype=x.dtype)
        gumbel = jax.random.gumbel(k_task, (b, n_tasks), jnp.float32)
        shuffle = jax.random.uniform(k_shuffle, (b, schema.max_length))
        return gumbel, jax.random.uniform(k_elem, (b,)), values, shuffle

    gumbel, element, values, shuffle = jax.device_get(draw(base_key))
    return (np.array(gumbel), np.array(element),
            {k: np.array(v) for k, v in values.items()}, np.array(shuffle))


def test_train_step_matches_jax(crello_spec):
    _check_step_matches_jax(crello_spec, METHOD)


def test_train_step_matches_jax_rico_pos_sort(rico_spec):
    """rico Ours-EXP's step: ``sort_flag`` live for the pos-task rows."""
    _check_step_matches_jax(rico_spec, "elem_pos_attr", min_pos_rows=2)


def test_train_step_matches_jax_flat(crello_spec):
    """crello_flat's step: elements shuffled by the drawn uniforms, S * F
    tokens."""
    _check_step_matches_jax(crello_spec, METHOD, seq_type="flat",
                            input_dtype="shuffled_set")


def test_train_step_matches_jax_canvas_without_l2(crello_spec, caplog):
    """``context='canvas'`` with ``l2=0``: the canvas heads are in no loss
    term, so they get a zero gradient and stay as they are, as in JAX; the
    step logs their names."""
    schema = crello_spec.schema
    canvas = tuple(f"/decoder_{c.name}/" for c in schema.valid_columns(True)
                   if not c.is_sequence)
    assert canvas
    with caplog.at_level(logging.INFO, logger=port_trainer.__name__):
        _check_step_matches_jax(crello_spec, METHOD, l2=0.0, unused=canvas,
                                context="canvas")
    logged = [r.getMessage() for r in caplog.records
              if r.name == port_trainer.__name__
              and r.getMessage().startswith("no gradient reaches")]
    assert len(logged) == 1
    for c in schema.valid_columns(True):
        if not c.is_sequence:
            assert f"decoder_{c.name}." in logged[0], (c.name, logged[0])


def _check_step_matches_jax(spec, method, min_pos_rows=0, l2=L2, unused=(),
                            **model_kwargs):
    """``unused``: name parts of the leaves the loss does not reach; their
    gradient is 0 and their parameters stay as they were, in both
    packages."""
    schema = spec.schema
    batch = numpy_batch(spec, 8)
    jax_model = jax_mfp.MFPModel(schema, latent_dim=32, num_blocks=2,
                                 num_heads=4, dropout=0.0,
                                 attention_impl="xla", **model_kwargs)
    # The port's keras initialisation, handed to JAX through convert.py.
    model = init_params(port_mfp.MFPModel(
        schema, latent_dim=32, num_blocks=2, num_heads=4, dropout=0.0,
        **model_kwargs), 0)
    initial = {k: np.array(v)
               for k, v in params_to_jax(model.state_dict()).items()}
    params = traverse_util.unflatten_dict({
        k: jnp.asarray(v) for k, v in initial.items()}, sep="/")
    task_config = jax_mfp.make_task_config(schema, method)
    tx = jax_optim.make_optimizer(LR, clipnorm=1.0)
    state = jax_trainer.TrainState(params=params, opt_state=tx.init(params),
                                   step=jnp.asarray(0))
    uniforms = np.random.default_rng(0).random(
        port_masking.train_draw_shape(schema, 8)).astype(np.float32)
    base_key = jax.random.PRNGKey(5)
    step = jax.jit(jax_trainer.make_train_step(jax_model, task_config, tx, l2))
    new_state, want = step(state, to_jax(batch), base_key,
                           jnp.asarray(uniforms))

    gumbel, element, values, shuffle = _jax_step_draws(
        schema, batch, base_key, len(task_config.task_probs))
    tasks = port_masking.sample_tasks(torch.from_numpy(gumbel),
                                      task_config.task_probs)
    assert len(set(tasks.tolist())) > 1
    pos = schema.task_names.index("pos")
    assert int((tasks == pos).sum()) >= min_pos_rows
    draws = port_masking.TrainDraws(
        tasks, torch.from_numpy(uniforms), torch.from_numpy(element),
        to_torch(values),
        shuffle=torch.from_numpy(shuffle) if model.draw_options()["shuffle"]
        else None,
    )
    adam = port_optim.KerasAdam(model.parameters(), LR)
    got = port_trainer.make_train_step(
        model, port_mfp.make_task_config(schema, method), adam, l2
    )(to_torch(batch), draws)

    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)

    names = [n for n, _ in model.named_parameters()]
    flat_mu = params_to_jax(dict(zip(names, adam.mu)))
    jax_mu = flat_params({"params": new_state.opt_state[1][0].mu["params"]})
    new_params = flat_params(new_state.params)
    port_params = params_to_jax(dict(model.named_parameters()))
    assert set(flat_mu) == set(jax_mu)
    assert all(any(part in name for name in jax_mu) for part in unused)
    for name in sorted(jax_mu):
        g, w = flat_mu[name] / 0.1, jax_mu[name] / 0.1
        assert np.abs(g - w).max() <= 5e-6, name
        if any(part in name for part in unused):
            assert not g.any() and not w.any(), f"{name} got a gradient"
            np.testing.assert_array_equal(port_params[name], initial[name])
            np.testing.assert_array_equal(new_params[name], initial[name])
            continue
        assert np.abs(g).max() > 0, f"{name} got no gradient"
        steady = (np.abs(g) > 1e-3) & (np.abs(w) > 1e-3)
        delta = np.abs(port_params[name] - new_params[name])
        assert delta[steady].max(initial=0) <= 1e-6, name
        assert delta.max() <= 2 * LR + 1e-6, name


@pytest.fixture(scope="module")
def small_model(crello_spec):
    return init_params(port_mfp.MFPModel(
        crello_spec.schema, latent_dim=32, num_blocks=2, num_heads=4), 0)


def test_val_scores_invariant_to_batch_size(crello_spec, small_model):
    """32 validation records batched 32 (exact), 48 (16 padded rows) and
    12 (12|12|8+4 padded): the same scores and losses."""
    schema = crello_spec.schema
    task_config = port_mfp.make_task_config(schema, "elem_pos_attr_img_txt")

    def run(batch_size):
        loader = crello_spec.make_dataset("val", batch_size=batch_size)
        return port_trainer.evaluate_split(
            small_model, loader, schema, task_config, seed=7, device="cpu")

    exact = run(32)
    for batch_size in (48, 12):
        other = run(batch_size)
        assert set(other) == set(exact)
        for k in exact:
            np.testing.assert_allclose(other[k], exact[k], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{batch_size}: {k}")


def test_train_on_cpu_then_serve(crello_dir, crello_spec, tmp_path):
    """``python -m flexdm_tpu_torch``'s main() for 2 epochs; the port's
    engine loads ``best`` and answers."""
    job = str(tmp_path / "job")
    cli.main([
        "--preset", "crello_ours_exp", "--data_dir", crello_dir,
        "--job-dir", job, "--num_epochs", "2", "--validation_freq", "1",
        "--batch_size", "16", "--latent_dim", "32", "--num_blocks", "2",
        "--device", "cpu",
    ])
    with open(os.path.join(job, "args.json")) as f:
        args = json.load(f)
    assert args["masking_method"] == "elem_pos_attr_img_txt"
    assert args["batch_size"] == 16 and args["device"] == "cpu"
    with open(os.path.join(job, "logs", "history.jsonl")) as f:
        history = [json.loads(line) for line in f]
    assert [h["epoch"] for h in history] == [1, 2]
    assert [h["step"] for h in history] == [6, 12]  # 96 records // 16
    for record in history:
        assert "val_total_score" in record
        assert all(math.isfinite(v) for v in record.values()
                   if isinstance(v, float))
    for name in ("best", "final"):
        assert os.path.exists(os.path.join(job, "checkpoints",
                                           f"{name}.torch.npz"))
    engine = InferenceEngine(job, batch_size=4, device="cpu")
    docs = _jsonable(crello_spec.unbatch(
        next(iter(crello_spec.make_dataset("test", batch_size=2)))))
    out = engine.predict(docs, task="pos")
    assert len(out) == 2
    assert [len(d["elements"]) for d in out] == [
        len(d["elements"]) for d in docs]


@pytest.mark.parametrize("preset,dataset", [
    ("rico_ours_exp", "rico"), ("crello_flat", "crello"),
])
def test_train_preset_on_cpu_then_serve(request, preset, dataset, tmp_path):
    """rico Ours-EXP (the pos-sort loss) and crello_flat (shuffled S * F
    tokens) train for an epoch at tiny width; ``best`` answers a MaskGIT
    request."""
    data_dir = request.getfixturevalue(f"{dataset}_dir")
    spec = request.getfixturevalue(f"{dataset}_spec")
    job = str(tmp_path / "job")
    cli.main([
        "--preset", preset, "--data_dir", data_dir, "--job-dir", job,
        "--num_epochs", "1", "--batch_size", "16", "--latent_dim", "32",
        "--num_blocks", "2", "--device", "cpu", "--log_level", "WARNING",
    ])
    with open(os.path.join(job, "args.json")) as f:
        args = json.load(f)
    with open(os.path.join(CONFIGS, f"{preset}.json")) as f:
        assert args["masking_method"] == json.load(f)["masking_method"]
    with open(os.path.join(job, "logs", "history.jsonl")) as f:
        history = [json.loads(line) for line in f]
    assert [h["step"] for h in history] == [6]  # 96 records // 16
    assert all(math.isfinite(v) for v in history[0].values()
               if isinstance(v, float))
    assert "val_total_score" in history[0]
    engine = InferenceEngine(job, batch_size=4, device="cpu")
    docs = _jsonable(spec.unbatch(
        next(iter(spec.make_dataset("test", batch_size=2)))))
    out = engine.predict(docs, task="pos", num_iter=2)
    assert [len(d["elements"]) for d in out] == [
        len(d["elements"]) for d in docs]


def test_nan_stops_without_saving(crello_dir, tmp_path, monkeypatch):
    """A non-finite loss ends the run at the epoch's end with no
    checkpoint written."""
    real_init = port_trainer.init_params

    def nan_init(model, seed):
        model = real_init(model, seed)
        with torch.no_grad():
            next(model.parameters()).fill_(float("nan"))
        return model

    monkeypatch.setattr(port_trainer, "init_params", nan_init)
    from flexdm_tpu_torch.config import TrainConfig

    job = str(tmp_path / "job")
    results = port_trainer.train(TrainConfig(
        dataset_name="crello", data_dir=crello_dir, job_dir=job,
        latent_dim=32, num_blocks=1, num_heads=4, batch_size=32,
        num_epochs=3, validation_freq=1, device="cpu",
    ))
    assert results["stopped_on_nan"]
    assert len(results["history"]) == 1
    assert not os.path.exists(os.path.join(job, "checkpoints"))


@pytest.mark.parametrize("flags", [
    ["--attention_impl", "pallas"],
])
def test_cli_refuses_what_the_port_lacks(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="not in this port"):
        cli.main(["--dataset_name", "crello", "--data_dir", "d",
                  "--job-dir", str(tmp_path / "job"), *flags])
    assert not os.path.exists(tmp_path / "job")


@pytest.mark.parametrize("flags", [
    ["--num_devices", "2", "--model_parallel", "2", "--arch_type", "autoreg"],
    ["--num_devices", "4", "--model_parallel", "2",
     "--arch_type", "canvasvae"],
])
def test_check_config_accepts_baseline_tensor_parallelism(flags, tmp_path):
    """A baseline trains tensor-parallel, as the oneshot model does: the
    CLI's flags pass ``check_config``."""
    from flexdm_tpu_torch.config import TrainConfig

    args = cli.make_parser().parse_args(
        ["--dataset_name", "crello", "--data_dir", "d",
         "--job-dir", str(tmp_path / "job"), *flags])
    port_trainer.check_config(TrainConfig(**{
        k: v for k, v in vars(args).items()
        if k in TrainConfig.__dataclass_fields__}))


@pytest.mark.parametrize("flags", [
    ["--dtype", "float64"], ["--dtype", "int8"],
    ["--dtype", "float16"],
])
def test_cli_refuses_unported_models(crello_dir, flags, tmp_path):
    with pytest.raises(NotImplementedError, match="not in this port"):
        cli.main(["--dataset_name", "crello", "--data_dir", crello_dir,
                  "--job-dir", str(tmp_path / "job"), "--device", "cpu",
                  *flags])
