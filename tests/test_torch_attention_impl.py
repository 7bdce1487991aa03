"""``attention_impl`` in the port, against the JAX package on the CPU.

* ``dot_product_attention(impl="xla")`` is the plain version, bit for bit
  (and so is ``auto`` on a CPU tensor); ``impl="pallas"`` on a CPU tensor
  and an unknown ``impl`` raise.
* The port's ``MFPModel`` and BART (causal self-attention and
  cross-attention in its decoder), each built by ``build_model`` with
  ``attention_impl="xla"``, give JAX's ``build_model`` outputs with
  ``xla`` and with ``pallas`` (the Pallas kernels in interpret mode, their
  CPU form), on the same weights moved through ``convert.py``, within
  1e-5 (abs).  BART's decode commits argmaxes: each leads its runner-up by
  at least 1e-3 in JAX's outputs, so a near tie cannot pass as a match.
* The training CLI takes ``--attention_impl xla --device cpu`` and records
  it in ``args.json``; serving, the demo and the eval harness rebuild it
  from there; the eval CLI's flag overrides it; an ``args.json`` without
  the field reads as ``auto``.
* Head dims: the kernels' plan (tile width, padded copy or not) for every
  Dh from 1 to 128 in both dtypes, and the wide kernels' for Dh 129 to
  1024; every Dh >= 1 accepted where the kernels would run (a card,
  ``auto`` or ``pallas``) at the training CLI, the eval CLI and the
  server's load of ``args.json`` (Dh 0 refused), as JAX runs every Dh;
  the crello Ours-EXP model at ``latent_dim`` 128 and 384 over 8 heads
  (Dh 16 and 48), 256 over one head (Dh 256) and 272 over two (Dh 136)
  against JAX's.
"""

import functools
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from flexdm_tpu.models import transformer as jax_transformer  # noqa: E402
from flexdm_tpu.ops import attention as jax_attn  # noqa: E402
from flexdm_tpu.train import trainer as jax_trainer  # noqa: E402
from flexdm_tpu_torch import cli, demo  # noqa: E402
from flexdm_tpu_torch.config import TrainConfig, build_model  # noqa: E402
from flexdm_tpu_torch.convert import (  # noqa: E402
    init_params,
    load_jax_params,
    params_to_jax,
    save_weights,
)
from flexdm_tpu_torch.evaluation import harness  # noqa: E402
from flexdm_tpu_torch.models import mfp as port_mfp  # noqa: E402
from flexdm_tpu_torch.models.transformer import (  # noqa: E402
    MultiHeadAttention,
)
from flexdm_tpu_torch.ops import attention as port_attn  # noqa: E402
from flexdm_tpu_torch.serve import InferenceEngine  # noqa: E402
from tests._torch_baselines import (  # noqa: E402
    MARGIN,
    _argmax_margins,
    _unflatten,
    schema_inputs,
)
from tests._torch_parity import (  # noqa: E402
    numpy_batch,
    random_masks,
    to_jax,
    to_numpy,
    to_torch,
)

TOL = dict(rtol=0, atol=1e-5)
TINY = ["--latent_dim", "32", "--num_blocks", "1", "--batch_size", "16",
        "--validation_freq", "1", "--num_epochs", "1", "--device", "cpu",
        "--log_level", "WARNING"]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX's attention through the Pallas kernels in interpret mode, for
    models built with ``attention_impl="pallas"``."""
    monkeypatch.setattr(jax_transformer, "dot_product_attention",
                        functools.partial(jax_attn.dot_product_attention,
                                          interpret=True))


def _qkv(dtype, b=2, h=2, s=9, dh=32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, dh),
                                                    np.float32)).to(dtype)
               for _ in range(3))
    mask = torch.from_numpy(rng.random((b, s)) < 0.7)
    mask[:, 0] = True
    return q, k, v, mask


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xla_is_the_plain_version(dtype, causal):
    q, k, v, mask = _qkv(dtype)
    bias = port_attn.key_bias(mask, q.shape[0], q.shape[2], q.device)
    want = port_attn.attention_reference(q, k, v, bias, causal)
    for impl in ("xla", "auto"):
        got = port_attn.dot_product_attention(q, k, v, mask, causal,
                                              impl=impl)
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_pallas_on_a_cpu_tensor_raises():
    q, k, v, mask = _qkv(torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        port_attn.dot_product_attention(q, k, v, mask, impl="pallas")


def test_unknown_impl_raises(crello_spec):
    q, k, v, mask = _qkv(torch.float32)
    with pytest.raises(ValueError, match="attention impl 'flash'"):
        port_attn.dot_product_attention(q, k, v, mask, impl="flash")
    with pytest.raises(ValueError, match="attention impl 'flash'"):
        MultiHeadAttention(32, 4, attention_impl="flash")
    with pytest.raises(ValueError, match="attention impl 'flash'"):
        build_model(TrainConfig(latent_dim=32, num_blocks=1, num_heads=4,
                                attention_impl="flash"), crello_spec.schema)


def _impls(model):
    return {m.attention_impl for m in model.modules()
            if isinstance(m, MultiHeadAttention)}


def _jax_params(flat):
    """Flat flax parameters as the tree JAX's ``apply`` takes."""
    return {"params": _unflatten({k: jax.numpy.asarray(v)
                                  for k, v in flat.items()})}


def _configs(impl, **kwargs):
    """The same job as a port and a JAX ``TrainConfig``."""
    sizes = dict(latent_dim=32, num_blocks=2, num_heads=4, dropout=0.0,
                 attention_impl=impl)
    sizes.update(kwargs)
    return TrainConfig(**sizes), jax_trainer.TrainConfig(**sizes)


def test_mfp_model_matches_jax_xla_and_pallas(crello_spec, pallas_interpret):
    schema = crello_spec.schema
    batch = numpy_batch(crello_spec, 4)
    masks = random_masks(schema, batch)
    port_config, _ = _configs("xla")
    port_model = init_params(build_model(port_config, schema), 0).eval()
    assert _impls(port_model) == {"xla"}
    inputs = {k: np.asarray(v) for k, v in port_mfp.preprocess_for_test(
        to_torch(batch), schema, to_torch(masks)).items()}
    with torch.no_grad():
        got = to_numpy(port_model(to_torch(inputs)))
    params = _jax_params(params_to_jax(port_model.state_dict()))
    for impl in ("xla", "pallas"):
        jax_model = jax_trainer.build_model(_configs(impl)[1], schema)
        want = to_numpy(jax.jit(jax_model.apply)(params, to_jax(inputs)))
        assert set(got) == set(want)
        for k in sorted(want):
            np.testing.assert_allclose(got[k], want[k], **TOL,
                                       err_msg=f"{impl}: {k}")


def test_bart_matches_jax_xla_and_pallas(pallas_interpret):
    schema, x, masks, modified = schema_inputs()
    bart = dict(arch_type="bart_autoreg", latent_dim=16, num_heads=2)
    port_config, _ = _configs("xla", **bart)
    flat = params_to_jax(init_params(build_model(port_config, schema),
                                     0).state_dict())
    port_model = load_jax_params(build_model(port_config, schema), flat)
    assert _impls(port_model) == {"xla"}
    with torch.no_grad():
        got, _ = port_mfp.apply_model(port_model.eval(), to_torch(modified),
                                      to_torch(x), to_torch(masks), True)
    got = to_numpy(got)
    params = _jax_params(flat)
    for impl in ("xla", "pallas"):
        jax_model = jax_trainer.build_model(_configs(impl, **bart)[1],
                                            schema)
        want, _ = jax.jit(lambda p: jax_model.apply(
            p, to_jax(modified), to_jax(x), to_jax(masks), True))(params)
        want = to_numpy(want)
        assert _argmax_margins(schema, want, masks,
                               schema.max_length - 1) >= MARGIN
        assert set(got) == set(want)
        for k in sorted(want):
            np.testing.assert_allclose(got[k], want[k], **TOL,
                                       err_msg=f"{impl}: {k}")


@pytest.fixture(scope="module")
def xla_job(crello_dir, tmp_path_factory):
    job = str(tmp_path_factory.mktemp("impl") / "job")
    cli.main(["--preset", "crello_ours_exp", "--data_dir", crello_dir,
              "--job-dir", job, "--attention_impl", "xla", *TINY])
    return job


def test_cli_records_the_impl(xla_job):
    with open(os.path.join(xla_job, "args.json")) as f:
        assert json.load(f)["attention_impl"] == "xla"
    assert os.path.exists(os.path.join(xla_job, "checkpoints",
                                       "best.torch.npz"))


def test_serve_and_demo_rebuild_the_impl(xla_job):
    engine = InferenceEngine(xla_job, batch_size=2, device="cpu")
    assert _impls(engine.model) == {"xla"}
    model, _ = demo.load_model(xla_job, device="cpu")
    assert _impls(model) == {"xla"}
    model, _ = demo.load_model(xla_job, device="cpu", attention_impl="auto")
    assert _impls(model) == {"auto"}


def test_eval_cli_rebuilds_and_overrides_the_impl(xla_job, monkeypatch):
    built = []

    def recording(*args, **kwargs):
        model, spec = load(*args, **kwargs)
        built.append(_impls(model))
        return model, spec

    load = demo.load_model
    monkeypatch.setattr(demo, "load_model", recording)
    argv = ["--job-dir", xla_job, "--device", "cpu", "--task_mode", "pos",
            "--batch_size", "8"]
    recorded = harness.main(argv)
    overridden = harness.main(argv + ["--attention_impl", "auto"])
    assert built == [{"xla"}, {"auto"}]
    assert recorded == overridden  # on the CPU both are the plain version


def test_old_args_json_reads_as_auto(xla_job, tmp_path):
    job = tmp_path / "old"
    os.makedirs(job / "checkpoints")
    with open(os.path.join(xla_job, "args.json")) as f:
        args = json.load(f)
    del args["attention_impl"]
    (job / "args.json").write_text(json.dumps(args))
    assert TrainConfig.from_args(args).attention_impl == "auto"
    model, spec = demo.load_model(xla_job, device="cpu")
    save_weights(str(job / "checkpoints" / "best.torch.npz"), model)
    old, _ = demo.load_model(str(job), device="cpu")
    assert _impls(old) == {"auto"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_plan_for_every_head_dim(dtype):
    """Dh 1-32 on the 32-wide tiles, 33-64 on 64, 65-128 on 128; the row
    is Dh rounded up to 16 bytes (4 float32, 8 bf16 elements), copied with
    zero padding where that is not Dh."""
    per16 = 4 if dtype == torch.float32 else 8
    for dh in range(1, 129):
        plan = port_attn.head_dim_plan(dh, dtype)
        row = per16 * math.ceil(dh / per16)
        width = 32 if dh <= 32 else 64 if dh <= 64 else 128
        assert plan == (width, row, row != dh), dh
        assert plan.row <= plan.width
    pinned = {torch.float32: {16: (32, 16, False), 20: (32, 20, False),
                              25: (32, 28, True), 48: (64, 48, False),
                              96: (128, 96, False)},
              torch.bfloat16: {16: (32, 16, False), 20: (32, 24, True),
                               25: (32, 32, True), 48: (64, 48, False),
                               65: (128, 72, True)}}[dtype]
    for dh, want in pinned.items():
        assert port_attn.head_dim_plan(dh, dtype) == want, dh


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_plan_above_128_takes_the_wide_kernels(dtype):
    """Dh 129 to 1024 run on the wide kernels: the row is Dh rounded up to
    16 bytes (a padded copy where that is not Dh), the width the row
    rounded up to the wide forward's 256-column blocks; no upper limit."""
    per16 = 4 if dtype == torch.float32 else 8
    for dh in range(129, 1025):
        plan = port_attn.head_dim_plan(dh, dtype)
        row = per16 * math.ceil(dh / per16)
        assert plan == (256 * math.ceil(row / 256), row, row != dh), dh
        assert plan.wide and plan.row <= plan.width
    for dh in range(1, 129):
        assert not port_attn.head_dim_plan(dh, dtype).wide, dh
    assert port_attn.head_dim_plan(129, dtype) == (
        (256, 132, True) if dtype == torch.float32 else (256, 136, True))
    assert port_attn.head_dim_plan(100_000, dtype).wide


def test_launch_counts_name_every_kernel():
    """``launch_counts`` reports the six narrow and the six wide instances,
    all 0 after ``reset_launch_counts``; a launch counts on its own name."""
    port_attn.reset_launch_counts()
    counts = port_attn.launch_counts()
    assert counts == dict.fromkeys(
        [f"{k}{w}{d}" for w in ("", "_wide") for d in ("", "_bf16")
         for k in ("fwd", "dq", "dkv")], 0)
    port_attn._count("BF16_WIDE_DKV_LAUNCHES")
    assert port_attn.launch_counts()["dkv_wide_bf16"] == 1
    assert sum(port_attn.launch_counts().values()) == 1
    port_attn.reset_launch_counts()
    assert not any(port_attn.launch_counts().values())


@pytest.mark.parametrize("dh", [0])
def test_head_dim_without_a_kernel_is_refused(dh):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="Dh >= 1"):
            port_attn.head_dim_plan(dh, dtype)
    for impl in ("auto", "pallas"):
        with pytest.raises(ValueError, match="Dh >= 1"):
            port_attn.check_head_dim(dh, impl, "cuda")
        with pytest.raises(ValueError, match="Dh >= 1"):
            port_attn.check_head_dim(dh, impl, "cuda:0")
    port_attn.check_head_dim(dh, "xla", "cuda")  # the plain version
    port_attn.check_head_dim(dh, "auto", "cpu")


@pytest.mark.parametrize("dh", [129, 256])
def test_head_dim_above_128_is_accepted_on_the_card(dh):
    """The wide kernels take it: ``auto`` and ``pallas`` on a card pass the
    check, as ``xla`` and the CPU do."""
    for impl in ("auto", "pallas", "xla"):
        for device in ("cuda", "cuda:0", "cpu"):
            if impl != "pallas" or device != "cpu":
                port_attn.check_head_dim(dh, impl, device)


def test_head_dim_256_matches_jax():
    """Dh 256 (``--latent_dim 2048`` over 8 heads): the port's attention
    on the CPU (the plain version) and its gradients give JAX's ``auto``
    (XLA off the TPU) and its Pallas kernels in interpret mode."""
    q, k, v, mask = _qkv(torch.float32, dh=256)
    do = torch.from_numpy(np.random.default_rng(1).standard_normal(
        q.shape, np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = port_attn.dot_product_attention(*leaves, mask)
    got = [out, *torch.autograd.grad(out, leaves, do)]
    for impl in ("auto", "pallas"):
        def f(q, k, v, impl=impl):
            return jax_attn.dot_product_attention(
                q, k, v, jax.numpy.asarray(mask.numpy()), impl=impl,
                interpret=True)

        want, vjp = jax.vjp(f, *(jax.numpy.asarray(t.numpy())
                                 for t in (q, k, v)))
        for g, w, name in zip(got, [want, *vjp(jax.numpy.asarray(
                do.numpy()))], ("O", "dq", "dk", "dv")):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=2e-5, atol=2e-5,
                                       err_msg=f"{impl} {name}")


def _wide_job(root, latent_dim=2048):
    """A job whose ``args.json`` has Dh = latent_dim / 8 above 128."""
    os.makedirs(root / "checkpoints")
    args = dict(TrainConfig(latent_dim=latent_dim).to_json(),
                data_dir=str(root / "missing"))
    (root / "args.json").write_text(json.dumps(args))
    return str(root)


def test_cli_accepts_a_wide_head_dim(crello_dir, tmp_path, monkeypatch):
    """``--latent_dim 2048`` (Dh 256) on a card: the training CLI's check
    passes and the run starts (stopped here where it would write the job);
    the eval CLI and the server take such a job with ``auto`` and
    ``pallas`` and stop where they read its data."""
    from flexdm_tpu_torch.train import trainer as port_trainer

    started = []
    monkeypatch.setattr(port_trainer, "_train",
                        lambda config, grid=None: started.append(config))
    job = tmp_path / "job"
    for impl in ("auto", "pallas"):
        cli.main(["--preset", "crello_ours_exp", "--data_dir", crello_dir,
                  "--job-dir", str(job), "--latent_dim", "2048",
                  "--attention_impl", impl])
    assert [(c.head_dim, c.attention_impl, c.device) for c in started] == [
        (256, "auto", "cuda"), (256, "pallas", "cuda")]
    assert not job.exists()
    wide = _wide_job(tmp_path / "wide")
    evaluated = []
    monkeypatch.setattr(harness, "_evaluate",
                        lambda args: evaluated.append(args) or {})
    harness.main(["--job-dir", wide])
    harness.main(["--job-dir", wide, "--attention_impl", "pallas"])
    assert [a.attention_impl for a in evaluated] == [None, "pallas"]
    with pytest.raises(ValueError, match="vocabulary.json"):
        InferenceEngine(wide)
    with pytest.raises(ValueError, match="vocabulary.json"):
        demo.load_model(wide)
    for impl in (None, "auto", "pallas", "xla"):
        config = demo.load_config(wide, impl, "cuda")
        assert config.head_dim == 256
        assert config.attention_impl == (impl or "auto")


def _check_model_at_head_dim(crello_spec, latent_dim, num_heads):
    """crello Ours-EXP over ``num_heads`` heads at ``latent_dim``: the
    port's model (the plain attention on the CPU) against JAX's with
    ``xla`` and with the Pallas kernels in interpret mode, on the same
    weights."""
    schema = crello_spec.schema
    batch = numpy_batch(crello_spec, 4)
    masks = random_masks(schema, batch)
    port_config, _ = _configs("auto", latent_dim=latent_dim,
                              num_heads=num_heads)
    assert port_config.head_dim == latent_dim // num_heads
    port_model = init_params(build_model(port_config, schema), 0).eval()
    inputs = {k: np.asarray(v) for k, v in port_mfp.preprocess_for_test(
        to_torch(batch), schema, to_torch(masks)).items()}
    with torch.no_grad():
        got = to_numpy(port_model(to_torch(inputs)))
    params = _jax_params(params_to_jax(port_model.state_dict()))
    for impl in ("xla", "pallas"):
        jax_model = jax_trainer.build_model(
            _configs(impl, latent_dim=latent_dim, num_heads=num_heads)[1],
            schema)
        want = to_numpy(jax.jit(jax_model.apply)(params, to_jax(inputs)))
        assert set(got) == set(want)
        for k in sorted(want):
            np.testing.assert_allclose(got[k], want[k], **TOL,
                                       err_msg=f"{impl}: {k}")


@pytest.mark.parametrize("latent_dim,num_heads", [(256, 1), (272, 2)])
def test_mfp_model_matches_jax_at_wide_head_dims(crello_spec,
                                                 pallas_interpret,
                                                 latent_dim, num_heads):
    """Dh 256 (one head at ``latent_dim`` 256) and Dh 136 (two heads at
    272), which the wide kernels run on a card."""
    _check_model_at_head_dim(crello_spec, latent_dim, num_heads)


@pytest.mark.parametrize("latent_dim", [128, 384])
def test_mfp_model_matches_jax_at_head_dims(crello_spec, pallas_interpret,
                                            latent_dim):
    """crello Ours-EXP at widths no preset has, over its 8 heads: Dh 16
    and 48, the head dims of ``--latent_dim 128`` and ``384``."""
    _check_model_at_head_dim(crello_spec, latent_dim, 8)
