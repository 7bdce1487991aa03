"""The port's ``last`` checkpoint, ``--resume``, ``--checkpoint_every`` and
``--weights`` on the CPU.

* Device mode: 2 epochs, then ``--resume`` to 4, equals an uninterrupted
  4-epoch run bitwise: ``history.jsonl`` (but for the wall times), the
  final weights, and in ``last`` the weights, the Adam moments and count,
  the step, the generator state and the best-score watermark.
* Host mode follows JAX's restart semantics (``flexdm_tpu/train/
  trainer.py:573-582``): the resumed run starts from the state ``last``
  holds and the loader restarts its shuffle at its first epoch.
* The watermark lives in ``last``: after a fresh run in a reused job dir,
  a resumed run saves ``best`` again (the stale-watermark sequence that a
  max over ``history.jsonl`` gets wrong).
* A NaN epoch leaves the earlier ``last`` (and ``best``, ``final``) as
  they were; ``--checkpoint_every`` 0 / N / default write ``last`` where
  JAX does.
* ``--weights`` from a port ``best`` gives the first step the same loss as
  the weights loaded by hand, from a JAX-exported file it starts from
  JAX's parameters, and a directory raises an error that names
  ``tools/export_torch_weights.py``.
* The CLI accepts ``--resume``, ``--weights``, ``--checkpoint_every``,
  ``--enable_profile`` and ``--input_mode``, with ``device`` the default.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from flexdm_tpu.data import split_device_batch as jax_split  # noqa: E402
from flexdm_tpu.train import trainer as jax_trainer  # noqa: E402
from flexdm_tpu_torch import cli  # noqa: E402
from flexdm_tpu_torch.config import TrainConfig, build_model  # noqa: E402
from flexdm_tpu_torch.convert import init_params, load_weights, \
    params_to_jax  # noqa: E402
from flexdm_tpu_torch.data import DatasetSpec  # noqa: E402
from flexdm_tpu_torch.data.pipeline import DataLoader, DeviceDataCache  # noqa: E402
from flexdm_tpu_torch.models import make_task_config  # noqa: E402
from flexdm_tpu_torch.models.masking import draw_train  # noqa: E402
from flexdm_tpu_torch.train import trainer as port_trainer  # noqa: E402
from flexdm_tpu_torch.train.checkpoint import checkpoint_path  # noqa: E402
from flexdm_tpu_torch.train.optim import KerasAdam  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from export_torch_weights import flatten_params  # noqa: E402

BATCH = 32  # 96 train records: 3 steps an epoch
STEPS = 3


def _config(data_dir, job, **kw):
    base = dict(dataset_name="crello", data_dir=data_dir, job_dir=str(job),
                latent_dim=16, num_blocks=1, num_heads=2, batch_size=BATCH,
                validation_freq=1, masking_method="elem_pos_attr_img_txt",
                seed=0, device="cpu")
    return TrainConfig(**{**base, **kw})


def _history(job):
    with open(os.path.join(job, "logs", "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _assert_same_arrays(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _copy_params(model):
    return {k: v.copy() for k, v in params_to_jax(model.state_dict()).items()}


def _no_wall_time(history):
    return [{k: v for k, v in h.items() if k != "wall_time"}
            for h in history]


def _first_step(monkeypatch):
    """Patch the trainer to record the weights its first step starts from
    and that step's loss."""
    seen = {}
    real_step = port_trainer.make_train_step

    def capture(model, *args, **kwargs):
        step = real_step(model, *args, **kwargs)

        def run(batch, draws):
            if "params" not in seen:
                seen["params"] = _copy_params(model)
            metrics = step(batch, draws)
            seen.setdefault("loss", metrics["loss"].item())
            return metrics

        return run

    monkeypatch.setattr(port_trainer, "make_train_step", capture)
    return seen


def test_resume_in_device_mode_is_exact(crello_dir, tmp_path):
    part, whole = tmp_path / "part", tmp_path / "whole"
    port_trainer.train(_config(crello_dir, part, num_epochs=2))
    resumed = port_trainer.train(_config(crello_dir, part, num_epochs=4,
                                         resume=True))
    assert [h["epoch"] for h in resumed["history"]] == [3, 4]
    port_trainer.train(_config(crello_dir, whole, num_epochs=4))

    assert _no_wall_time(_history(part)) == _no_wall_time(_history(whole))
    for name in ("last", "final", "best"):
        _assert_same_arrays(_arrays(checkpoint_path(str(part), name)),
                            _arrays(checkpoint_path(str(whole), name)))
    last = _arrays(checkpoint_path(str(part), "last"))
    assert int(last["step"]) == int(last["adam/count"]) == 4 * STEPS
    assert any(k.startswith("adam/mu/params/") for k in last)
    assert last["generator"].dtype == np.uint8


def test_resume_in_host_mode_restarts_the_loader(crello_dir, tmp_path,
                                                 monkeypatch):
    """As in JAX: the resumed run restores ``last`` and its loader starts
    again at its first shuffle, so epoch 3 takes epoch 1's batches."""
    orders = []
    real = DataLoader._make_batch

    def spy(self, indices):
        if self.split == "train":
            orders[-1].append(np.array(indices))
        return real(self, indices)

    monkeypatch.setattr(DataLoader, "_make_batch", spy)
    job = tmp_path / "job"
    orders.append([])
    port_trainer.train(_config(crello_dir, job, num_epochs=2,
                               input_mode="host"))
    saved = _arrays(checkpoint_path(str(job), "last"))

    seen = _first_step(monkeypatch)
    orders.append([])
    resumed = port_trainer.train(_config(crello_dir, job, num_epochs=4,
                                         resume=True, input_mode="host"))
    assert [(h["epoch"], h["step"]) for h in resumed["history"]] == [
        (3, 3 * STEPS), (4, 4 * STEPS)]
    _assert_same_arrays(seen["params"], {k: v for k, v in saved.items()
                                         if k.startswith("params/")})
    # The prefetch thread may have made batches past the last step.
    first, second = orders
    assert len(first) >= 2 * STEPS and len(second) >= 2 * STEPS
    for a, b in zip(first[:2 * STEPS], second[:2 * STEPS]):
        np.testing.assert_array_equal(a, b)
    loader_order = np.random.default_rng(0).permutation(96)[:BATCH]
    np.testing.assert_array_equal(np.sort(second[0]), np.sort(loader_order))


def _scripted_scores(monkeypatch, scores):
    """``evaluate_split`` returns the next of ``scores`` on the val split."""
    def fake(model, loader, schema, task_config, seed, device, grid=None):
        return {"total_score": scores.pop(0) if loader.split == "val"
                else 0.0}

    monkeypatch.setattr(port_trainer, "evaluate_split", fake)


def test_watermark_comes_from_last_not_history(crello_dir, tmp_path,
                                               monkeypatch):
    """VERDICT.md's stale-watermark sequence: run A reaches 0.9 in a job
    dir; run B starts fresh there (0.1, 0.2) and stops; B resumed scores
    0.3, better than B's best, and saves ``best`` again."""
    job = tmp_path / "job"
    _scripted_scores(monkeypatch, [0.9])
    port_trainer.train(_config(crello_dir, job, num_epochs=1))
    _scripted_scores(monkeypatch, [0.1, 0.2])
    port_trainer.train(_config(crello_dir, job, num_epochs=2))
    best = _arrays(checkpoint_path(str(job), "best"))
    _scripted_scores(monkeypatch, [0.3])
    resumed = port_trainer.train(_config(crello_dir, job, num_epochs=3,
                                         resume=True))
    assert max(h["val_total_score"] for h in _history(job)) == 0.9
    assert resumed["history"][0]["checkpointed"] is True
    assert resumed["best_val_total_score"] == 0.3
    assert any(not np.array_equal(v, best[k]) for k, v in _arrays(
        checkpoint_path(str(job), "best")).items())


def test_nan_epoch_leaves_last_intact(crello_dir, tmp_path, monkeypatch):
    job = tmp_path / "job"
    port_trainer.train(_config(crello_dir, job, num_epochs=2))
    files = {}
    for name in ("last", "best", "final"):
        with open(checkpoint_path(str(job), name), "rb") as f:
            files[name] = f.read()
    real_step = port_trainer.make_train_step

    def poisoned(model, *args, **kwargs):
        step = real_step(model, *args, **kwargs)

        def run(batch, draws):
            metrics = step(batch, draws)
            with torch.no_grad():
                next(model.parameters()).fill_(float("nan"))
            return metrics

        return run

    monkeypatch.setattr(port_trainer, "make_train_step", poisoned)
    results = port_trainer.train(_config(crello_dir, job, num_epochs=4,
                                         resume=True))
    assert results["stopped_on_nan"]
    assert [h["epoch"] for h in results["history"]] == [3]
    for name, content in files.items():
        with open(checkpoint_path(str(job), name), "rb") as f:
            assert f.read() == content, name


@pytest.mark.parametrize("every,validation_freq,want", [
    (None, 1, [1, 2, 3, 3]),  # default: every validation_freq epochs
    (0, 1, [3]),  # only at the end
    (2, 1, [2, 3]),
])
def test_checkpoint_every(crello_dir, tmp_path, monkeypatch, every,
                          validation_freq, want):
    saved = []
    real = port_trainer.save_last

    def spy(job_dir, model, optimizer, step, generator, best_score,
            primary=True):
        saved.append(step // STEPS)
        return real(job_dir, model, optimizer, step, generator, best_score,
                    primary)

    monkeypatch.setattr(port_trainer, "save_last", spy)
    port_trainer.train(_config(crello_dir, tmp_path / "job", num_epochs=3,
                               checkpoint_every=every,
                               validation_freq=validation_freq))
    assert saved == want


def test_weights_from_a_port_checkpoint(crello_dir, tmp_path, monkeypatch):
    source = tmp_path / "source"
    port_trainer.train(_config(crello_dir, source, num_epochs=1))
    weights = checkpoint_path(str(source), "best")
    seen = _first_step(monkeypatch)
    config = _config(crello_dir, tmp_path / "job", num_epochs=1,
                     weights=weights)
    port_trainer.train(config)
    _assert_same_arrays(seen["params"], _arrays(weights))

    # The same first step by hand, from the weights through load_weights.
    spec = DatasetSpec("crello", crello_dir, BATCH)
    model = load_weights(weights, init_params(
        build_model(config, spec.schema), 123))
    task_config = make_task_config(spec.schema, config.masking_method)
    step = port_trainer.make_train_step(
        model, task_config, KerasAdam(model.parameters(), 1e-4), config.l2)
    loader = spec.make_dataset("train", batch_size=BATCH, shuffle=True,
                               repeat=True, seed=0, drop_remainder=True)
    cache = DeviceDataCache(loader, "cpu")
    generator = torch.Generator().manual_seed(config.seed)
    draws = draw_train(spec.schema, BATCH, task_config.task_probs, generator,
                       **model.draw_options())
    draws.dropout = generator
    indices = torch.from_numpy(cache.epoch_indices(BATCH, 0, 1)[0])
    assert step(cache.gather(indices), draws)["loss"].item() == seen["loss"]


def test_weights_from_a_jax_export(crello_dir, crello_spec, tmp_path,
                                   monkeypatch):
    config = _config(crello_dir, tmp_path / "job", num_epochs=1)
    jax_config = jax_trainer.TrainConfig(**{
        k: v for k, v in config.to_json().items()
        if k in jax_trainer.TrainConfig.__dataclass_fields__})
    jax_model = jax_trainer.build_model(jax_config, crello_spec.schema)
    sample = jax_split(next(iter(crello_spec.make_dataset("val",
                                                           batch_size=4))))
    params = jax.jit(lambda: jax_trainer.init_params(jax_model, sample, 7))()
    path = str(tmp_path / "jax.torch.npz")
    with open(path, "wb") as f:
        np.savez(f, **flatten_params(params))
    seen = _first_step(monkeypatch)
    config.weights = path
    port_trainer.train(config)
    _assert_same_arrays(seen["params"], flatten_params(params))


def test_weights_directory_names_the_export_tool(crello_dir, tmp_path):
    with pytest.raises(ValueError, match="tools/export_torch_weights.py"):
        cli.main(["--preset", "crello_ours_exp", "--data_dir", crello_dir,
                  "--job-dir", str(tmp_path / "job"), "--device", "cpu",
                  "--weights", str(tmp_path)])
    assert not os.path.exists(tmp_path / "job")


@pytest.mark.parametrize("flags,field,value", [
    ([], "input_mode", "device"),
    (["--input_mode", "host"], "input_mode", "host"),
    (["--resume"], "resume", True),
    (["--weights", "w.torch.npz"], "weights", "w.torch.npz"),
    (["--checkpoint_every", "5"], "checkpoint_every", 5),
    (["--enable_profile"], "enable_profile", True),
])
def test_cli_accepts_the_trainer_flags(flags, field, value, tmp_path,
                                       monkeypatch):
    configs = []

    def fake_train(config):
        configs.append(config)
        return {"test_metrics": {}}

    monkeypatch.setattr(port_trainer, "train", fake_train)
    cli.main(["--dataset_name", "crello", "--data_dir", "d", "--job-dir",
              str(tmp_path / "job"), "--device", "cpu", *flags])
    assert getattr(configs[0], field) == value
