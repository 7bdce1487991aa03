"""The port's bf16 compute (``dtype="bfloat16"``, ``--dtype bfloat16``)
against the JAX package's, on the CPU, with the same weights.

* Decoder outputs of ``MFPModel(dtype="bfloat16")`` for crello (context
  None, ``id``, ``canvas``), crello_flat and rico, against JAX run two
  ways, op by op (not jitted: XLA's fusion may keep bf16 intermediates
  in float32): (a) as it runs on the CPU (``attention_impl="xla"``, which
  rounds the scores and probabilities to bf16): the port's mean |difference| is
  no larger than JAX-bf16's own from JAX-float32, and its largest at most
  twice JAX-bf16's largest from JAX-float32; (b) with the Pallas kernels in
  interpret mode (patched in here only), whose float32-inside semantics the
  port follows: every output within one bf16 ulp plus 2^-8 of the output's
  largest magnitude, and a mean |difference| under a quarter of (a)'s
  bf16-vs-float32 one.
* The residual stream's dtype after the encoder and after the blocks is
  JAX's per configuration (bf16 for the Ours-EXP presets, float32 where a
  float32 task token or position embedding enters).
* One training step against JAX's ``make_train_step`` with the Pallas
  kernels (bf16, dropout 0, the same draws): loss and metrics within 1e-2
  relative; every clipped gradient leaf within 10% (L2) of JAX's bf16 one
  and no farther from JAX's float32 step than JAX's bf16 step is;
  parameters, gradients and Adam moments float32.
* Ten steps of bf16 track ten float32 steps from the same init within 5%.
* MaskGIT (``num_iter=3``) and the eval harness on a bf16 job against
  JAX's, and the CLI's ``--dtype bfloat16`` job served from its
  ``args.json``; ``--dtype float16`` is refused.
"""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from flexdm_tpu.evaluation import harness as jax_harness  # noqa: E402
from flexdm_tpu.models import encoder as jax_encoder  # noqa: E402
from flexdm_tpu.models import mfp as jax_mfp  # noqa: E402
from flexdm_tpu.models import transformer as jax_transformer  # noqa: E402
from flexdm_tpu.models.masking import preprocess_for_test  # noqa: E402
from flexdm_tpu.ops import attention as jax_attn  # noqa: E402
from flexdm_tpu.train import optim as jax_optim  # noqa: E402
from flexdm_tpu.train import trainer as jax_trainer  # noqa: E402
from flexdm_tpu_torch import cli  # noqa: E402
from flexdm_tpu_torch.config import TrainConfig, build_model  # noqa: E402
from flexdm_tpu_torch.convert import init_params, params_to_jax  # noqa: E402
from flexdm_tpu_torch.data import DatasetSpec as PortSpec  # noqa: E402
from flexdm_tpu_torch.demo import load_model  # noqa: E402
from flexdm_tpu_torch.evaluation import harness  # noqa: E402
from flexdm_tpu_torch.models import masking as port_masking  # noqa: E402
from flexdm_tpu_torch.models import mfp as port_mfp  # noqa: E402
from flexdm_tpu_torch.serve import InferenceEngine, _jsonable  # noqa: E402
from flexdm_tpu_torch.train import optim as port_optim  # noqa: E402
from flexdm_tpu_torch.train import trainer as port_trainer  # noqa: E402
from tests._torch_parity import (  # noqa: E402
    flat_params,
    model_pair,
    numpy_batch,
    random_masks,
    to_jax,
    to_torch,
)
from tests.test_torch_attention_bf16 import assert_bf16_close  # noqa: E402
from tests.test_torch_train import _jax_step_draws  # noqa: E402

SIZES = dict(latent_dim=32, num_blocks=2, num_heads=4)
FLAT = dict(seq_type="flat", input_dtype="shuffled_set")
CONFIGS = {  # name: (dataset, model kwargs, residual dtype after the encoder)
    "crello": ("crello", {}, torch.bfloat16),
    "crello-id": ("crello", dict(context="id"), torch.float32),
    "crello-canvas": ("crello", dict(context="canvas"), torch.bfloat16),
    "crello-flat": ("crello", FLAT, torch.float32),
    "rico": ("rico", {}, torch.bfloat16),
}
BF16 = "bfloat16"
LR, L2 = 1e-4, 1e-2


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX models' attention through the Pallas kernels in interpret
    mode (their CPU form), for models built with
    ``attention_impl="pallas"``."""
    monkeypatch.setattr(jax_transformer, "dot_product_attention",
                        functools.partial(jax_attn.dot_product_attention,
                                          interpret=True))


def _inputs(spec, n=4, seed=0):
    """A masked test batch as the eval forward sees it (numpy)."""
    batch = numpy_batch(spec, n)
    masks = random_masks(spec.schema, batch, seed)
    return {k: np.asarray(v) for k, v in preprocess_for_test(
        to_jax(batch), spec.schema, to_jax(masks)).items()}


def _jax_model(schema, impl="xla", **kwargs):
    return jax_mfp.MFPModel(schema, attention_impl=impl, **SIZES, **kwargs)


def _flat(outputs):
    """Every output as one float32 vector (sorted by name)."""
    return np.concatenate([np.asarray(
        v.detach().float() if isinstance(v, torch.Tensor)
        else jnp.asarray(v, jnp.float32)).ravel()
        for _, v in sorted(outputs.items())])


_PAIRS = {}


def _pair(request, name):
    """``(schema, inputs, JAX bf16 model, params, port bf16 model)`` of a
    configuration, made once per process."""
    if name not in _PAIRS:
        dataset, kwargs, _ = CONFIGS[name]
        spec = request.getfixturevalue(f"{dataset}_spec")
        inputs = _inputs(spec)
        _PAIRS[name] = (spec.schema, inputs) + model_pair(
            spec.schema, to_jax(inputs), dtype=BF16, **kwargs)
    return _PAIRS[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bf16_model_matches_jax(request, pallas_interpret, name):
    kwargs = CONFIGS[name][1]
    schema, inputs, jax_b, params, port = _pair(request, name)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    want32 = _jax_model(schema, **kwargs).apply(params, to_jax(inputs))
    want_xla = jax_b.apply(params, to_jax(inputs))
    want_pallas = _jax_model(schema, "pallas", dtype=BF16, **kwargs).apply(
        params, to_jax(inputs))
    with torch.no_grad():
        got = port(to_torch(inputs))
    assert set(got) == set(want_xla)
    for k, v in got.items():
        assert v.dtype == torch.bfloat16, k
        assert want_xla[k].dtype == want_pallas[k].dtype == jnp.bfloat16, k
        assert_bf16_close(v, np.asarray(want_pallas[k], np.float32), k)
    g, x, p, f = (_flat(t) for t in (got, want_xla, want_pallas, want32))
    bf16_vs_f32 = np.abs(x - f)
    assert np.abs(g - x).mean() <= bf16_vs_f32.mean()
    assert np.abs(g - x).max() <= 2 * bf16_vs_f32.max()
    assert np.abs(g - p).mean() <= 0.25 * bf16_vs_f32.mean()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_residual_stream_dtype_matches_jax(request, name):
    """bf16 through the blocks where JAX's promotion keeps bf16 (the
    Ours-EXP presets, the canvas token of categorical canvas columns);
    float32 where the float32 task token or position embedding enters."""
    _, kwargs, dtype = CONFIGS[name]
    schema, inputs, _, params, port = _pair(request, name)
    flat = kwargs.get("seq_type") == "flat"
    encoder = jax_encoder.Encoder(
        schema, latent_dim=SIZES["latent_dim"],
        context=kwargs.get("context"),
        input_dtype=kwargs.get("input_dtype", "set"),
        fusion="flat" if flat else "add", dtype=BF16)
    seq, mask = encoder.apply({"params": params["params"]["encoder"]},
                              to_jax(inputs))
    blocks = jax_transformer.Blocks(
        latent_dim=SIZES["latent_dim"], num_blocks=SIZES["num_blocks"],
        num_heads=SIZES["num_heads"], attention_impl="xla", dtype=BF16)
    h = blocks.apply({"params": params["params"]["blocks"]}, seq, mask)
    with torch.no_grad():
        port_seq, port_mask = port.encoder(to_torch(inputs))
        port_h = port.blocks(port_seq, port_mask)
    assert port_seq.dtype == dtype
    assert str(seq.dtype) == str(port_seq.dtype).split(".")[-1]
    assert str(h.dtype) == str(port_h.dtype).split(".")[-1]


def test_train_step_matches_jax_in_bf16(crello_spec, pallas_interpret):
    """One step of ``make_train_step`` at ``dtype="bfloat16"`` (dropout 0,
    the same draws, JAX's attention through the Pallas kernels): loss and
    metrics within 1e-2 relative.  Each clipped gradient leaf (L2 over the
    leaf) is within 10% of JAX's bf16 one, and no farther from JAX's
    float32 step than JAX's bf16 step is (+25%, + 2^-8 of the leaf); the
    attention key biases, whose gradient is 0 in exact arithmetic and
    rounding noise in both packages, only the latter.  Everything the
    optimizer holds is float32."""
    schema = crello_spec.schema
    method = "random_elem_type_pos_attr_img_txt"
    batch = numpy_batch(crello_spec, 8)
    jax_model = _jax_model(schema, "pallas", dropout=0.0, dtype=BF16)
    model = init_params(port_mfp.MFPModel(schema, dropout=0.0, dtype=BF16,
                                          **SIZES), 0)
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
    step = jax.jit(jax_trainer.make_train_step(jax_model, task_config, tx, L2))
    new_state, want = step(state, to_jax(batch), base_key,
                           jnp.asarray(uniforms))
    gumbel, element, values, _ = _jax_step_draws(
        schema, batch, base_key, len(task_config.task_probs))
    draws = port_masking.TrainDraws(
        port_masking.sample_tasks(torch.from_numpy(gumbel),
                                  task_config.task_probs),
        torch.from_numpy(uniforms), torch.from_numpy(element),
        to_torch(values))
    adam = port_optim.KerasAdam(model.parameters(), LR)
    got = port_trainer.make_train_step(
        model, port_mfp.make_task_config(schema, method), adam, L2
    )(to_torch(batch), draws)
    assert set(got) == set(want)
    for name in sorted(want):
        assert got[name].dtype == torch.float32, name
        np.testing.assert_allclose(got[name].item(), float(want[name]),
                                   rtol=1e-2, atol=1e-6, err_msg=name)
    for tensor in (*model.parameters(), *adam.mu, *adam.nu):
        assert tensor.dtype == torch.float32
    names = [n for n, _ in model.named_parameters()]
    port_mu = params_to_jax(dict(zip(names, adam.mu)))
    jax_mu = flat_params({"params": new_state.opt_state[1][0].mu["params"]})
    assert set(port_mu) == set(jax_mu)
    jax32 = _jax_model(schema, dropout=0.0)
    step32 = jax.jit(jax_trainer.make_train_step(jax32, task_config, tx, L2))
    state32, _ = step32(state, to_jax(batch), base_key, jnp.asarray(uniforms))
    mu32 = flat_params({"params": state32.opt_state[1][0].mu["params"]})
    for name in sorted(jax_mu):
        g, w, f = port_mu[name] / 0.1, jax_mu[name] / 0.1, mu32[name] / 0.1
        assert np.linalg.norm(g - f) <= (1.25 * np.linalg.norm(w - f)
                                         + 2 ** -8 * np.linalg.norm(f)), name
        if "/key/bias" not in name:  # exactly 0 in exact arithmetic
            assert np.linalg.norm(g - w) <= 0.1 * np.linalg.norm(w), name


def _losses(spec, dtype, steps=10):
    """``steps`` port training steps of a tiny rico model from seed 0, on
    one batch of 16, draws and dropout from one seeded generator; rico
    Ours-EXP's tasks, so the pos-sort loss runs on bf16 logits."""
    schema = spec.schema
    batch = to_torch(numpy_batch(spec, 16))
    model = init_params(port_mfp.MFPModel(schema, dtype=dtype, latent_dim=32,
                                          num_blocks=1, num_heads=4), 0)
    task_config = port_mfp.make_task_config(schema, "elem_pos_attr")
    adam = port_optim.KerasAdam(model.parameters(), 1e-3)
    step = port_trainer.make_train_step(model, task_config, adam, 1e-2)
    generator = torch.Generator().manual_seed(7)
    losses = []
    for _ in range(steps):
        draws = port_masking.draw_train(schema, 16, task_config.task_probs,
                                        generator)
        draws.dropout = generator
        losses.append(step(batch, draws)["loss"].item())
    return losses, model, adam


def test_bf16_training_tracks_float32(rico_spec):
    """The port's counterpart of the JAX package's slow
    ``test_bf16_training_tracks_f32``: the same init, data and draws, the
    bf16 losses within 5% of the float32 ones at every one of 10 steps;
    parameters and Adam moments stay float32."""
    f32, _, _ = _losses(rico_spec, None)
    bf16, model, adam = _losses(rico_spec, BF16)
    assert all(np.isfinite(bf16))
    assert bf16[-1] < bf16[0] and f32[-1] < f32[0]
    for a, b in zip(f32, bf16):
        assert abs(a - b) / abs(a) < 0.05, (a, b)
    for tensor in (*model.parameters(), *adam.mu, *adam.nu):
        assert tensor.dtype == torch.float32


def _near_ties(rounds, outputs, masks, columns):
    """Per document, the masked categorical fields whose confidence lies
    within one bf16 ulp of its round's threshold, or whose top two logits
    lie within one ulp: where the two packages may commit otherwise."""
    near = np.zeros(next(iter(masks.values())).shape[0], int)
    for r in rounds:
        thr = r["threshold"].float()[:, None]
        for conf in r["confidence"].values():
            conf = conf.float()
            gap = (conf - thr).abs()
            near += ((conf > 0) & (gap > 0) & (gap <= 2 ** -7 * thr)).sum(
                1).numpy()
    for c in columns:
        top = outputs[c.name].float().topk(2, -1).values
        tie = (top[..., 0] - top[..., 1]) <= 2 ** -7 * top[..., 0].abs()
        near += (tie.any(-1) & masks[c.name]).sum(1).numpy()
    return near


def test_maskgit_matches_jax_in_bf16(crello_spec, pallas_interpret):
    """MaskGIT (3 rounds) of a bf16 model, decoder heads x8: the committed
    fields equal JAX's (Pallas kernels) on every document without a near
    tie (counted), and on most documents."""
    from tests.test_torch_maskgit import _peaky

    schema = crello_spec.schema
    batch = numpy_batch(crello_spec, 6)
    _, params, port = _peaky(schema, batch, num_blocks=1, dtype=BF16)
    jax_model = jax_mfp.MFPModel(schema, attention_impl="pallas",
                                 latent_dim=32, num_blocks=1, num_heads=4,
                                 dtype=BF16)
    masks = random_masks(schema, batch, seed=3, p=0.5)
    want = jax_mfp.forward_eval(jax_model, params, to_jax(batch),
                                to_jax(masks), num_iter=3)
    rounds = []
    got = port_mfp.forward_eval(port, to_torch(batch), to_torch(masks),
                                num_iter=3, rounds=rounds)
    assert all(r["threshold"].dtype == torch.bfloat16 for r in rounds)
    columns = [c for c in schema.sequence_columns if c.is_categorical]
    near = _near_ties(rounds, got, to_torch(masks), columns)
    differ = np.zeros(6, bool)
    for c in columns:
        m = masks[c.name]
        same = (got[c.name].argmax(-1).numpy()
                == np.asarray(want[c.name]).argmax(-1))
        differ |= (~same.all(-1) & m).any(1)
    assert not (differ & (near == 0)).any(), (differ, near)
    assert differ.sum() <= 3, (differ, near)


@pytest.fixture(scope="module")
def bf16_job(crello_dir, tmp_path_factory):
    """``python -m flexdm_tpu_torch --preset crello_ours_exp --dtype
    bfloat16`` for one epoch at tiny width, on the CPU."""
    job = str(tmp_path_factory.mktemp("bf16") / "job")
    cli.main([
        "--preset", "crello_ours_exp", "--dtype", BF16, "--data_dir",
        crello_dir, "--job-dir", job, "--num_epochs", "1", "--batch_size",
        "16", "--latent_dim", "32", "--num_blocks", "2", "--device", "cpu",
        "--log_level", "WARNING",
    ])
    return job


def test_cli_trains_bf16_and_serves_it(bf16_job, crello_spec):
    """The job's ``args.json`` carries the dtype; ``load_model`` and the
    engine rebuild the bf16 model from it; the checkpoints are float32."""
    with open(os.path.join(bf16_job, "args.json")) as f:
        assert json.load(f)["dtype"] == BF16
    with open(os.path.join(bf16_job, "logs", "history.jsonl")) as f:
        history = [json.loads(line) for line in f]
    assert np.isfinite(history[-1]["loss"])
    model, _ = load_model(bf16_job, device="cpu")
    assert model.dtype == BF16
    saved = np.load(os.path.join(bf16_job, "checkpoints", "best.torch.npz"))
    assert {saved[k].dtype for k in saved.files} == {np.dtype(np.float32)}
    engine = InferenceEngine(bf16_job, batch_size=4, device="cpu")
    assert engine.model.dtype == BF16
    docs = _jsonable(crello_spec.unbatch(
        next(iter(crello_spec.make_dataset("test", batch_size=3)))))
    out = engine.predict(docs, task="pos", num_iter=3)
    assert [len(d["elements"]) for d in out] == [
        len(d["elements"]) for d in docs]
    assert all(isinstance(e["left"], float)
               for d in out for e in d["elements"])


@pytest.mark.parametrize("task_mode", ["elem", "pos"])
def test_eval_of_a_bf16_job_matches_jax(bf16_job, crello_spec, crello_dir,
                                        pallas_interpret, task_mode):
    """The harness on the CLI's bf16 job against JAX's ``evaluate_task`` on
    the same weights in bf16 (Pallas kernels): every score within 2e-2
    (a near-tie argmax in bf16 flips one field's hit)."""
    model, _ = load_model(bf16_job, device="cpu")
    flat = params_to_jax(model.state_dict())
    params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    jax_model = jax_mfp.MFPModel(  # the CLI's 8 heads
        crello_spec.schema, latent_dim=32, num_blocks=2, num_heads=8,
        attention_impl="pallas", dtype=BF16)
    groups = crello_spec.schema.attribute_groups
    group = (task_mode, groups[task_mode]) if task_mode in groups else None
    want = jax_harness.evaluate_task(
        jax_model, params, crello_spec.make_dataset("test", batch_size=8),
        task_mode, group)
    got = harness.evaluate_task(
        model, PortSpec("crello", crello_dir, 8).make_dataset(
            "test", batch_size=8), task_mode, group)
    assert want and set(got) == set(want)
    for k in sorted(want):
        assert abs(got[k] - want[k]) <= 2e-2, (k, got[k], want[k])


def test_float16_is_refused(crello_dir, crello_spec):
    with pytest.raises(NotImplementedError, match="not in this port"):
        build_model(TrainConfig(dtype="float16", latent_dim=32),
                    crello_spec.schema)
    with pytest.raises(NotImplementedError, match="not in this port"):
        port_mfp.MFPModel(crello_spec.schema, dtype="float16")
