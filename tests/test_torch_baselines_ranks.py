"""The baselines on two ranks, on the CPU (gloo), at a tiny size (D=16,
1 block, batch 32, one epoch on the crello fixture, dropout on): two data
ranks, and one data rank by two model ranks (tensor-parallel).

``train()`` in host mode on 2 data ranks gives the single-process history
(training loss and scores, validation and test) to 1e-5 relative, and both
ranks end with the same parameters, bit for bit.  Every rank draws the
global batch's task draws, AutoReg's and BART's element shuffle, dropout
and the VAE noise (CanvasVAE's ``Head``, LayoutVAE's per-element
posteriors and priors) and keeps its rows, so any draw that is not
batch-first, or that a rank draws for its own rows only, breaks one of the
two.  Tensor-parallel, both model ranks draw the same (whole) batch's
draws; the split parameters are gathered whole at the end.  Every spawned
group has a hard time limit.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flexdm_tpu_torch.config import TrainConfig  # noqa: E402
from flexdm_tpu_torch.parallel import mesh  # noqa: E402
from flexdm_tpu_torch.train import trainer  # noqa: E402
from tests import _torch_ranks as ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ["crello_canvasvae", "crello_layoutvae", "crello_autoreg",
           "crello_bart"]


def _config(preset, data_dir, job):
    with open(os.path.join(ROOT, "configs", f"{preset}.json")) as f:
        values = json.load(f)
    values.update(data_dir=data_dir, job_dir=str(job), latent_dim=16,
                  num_blocks=1, batch_size=32, num_epochs=1,
                  validation_freq=1, input_mode="host", device="cpu")
    return TrainConfig(**{k: v for k, v in values.items()
                          if k in TrainConfig.__dataclass_fields__})


def _history(job):
    with open(os.path.join(job, "logs", "history.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def alone(crello_dir, tmp_path_factory):
    """Each preset's history alone, trained once for both layouts."""
    runs = {}

    def run(preset):
        if preset not in runs:
            job = tmp_path_factory.mktemp(f"{preset}_alone")
            runs[preset] = trainer.train(_config(preset, crello_dir, job))
        return runs[preset]

    return run


def _trains_as_alone(preset, model_parallel, crello_dir, tmp_path, alone):
    want = alone(preset)
    job = tmp_path / "ranks"
    params = mesh.spawn(ranks.train_worker, 2,
                        (2, model_parallel, _config(preset, crello_dir, job)),
                        timeout=ranks.TIMEOUT_S, cpu=True)
    assert set(params[0]) == set(params[1])
    for k, v in params[0].items():
        np.testing.assert_array_equal(params[1][k], v, err_msg=k)
    got = _history(str(job))
    assert [h["step"] for h in got] == [h["step"] for h in want["history"]] \
        == [3]
    for a, b in zip(got, want["history"]):
        assert set(a) == set(b)
        for k, v in b.items():
            if k != "wall_time" and isinstance(v, float):
                np.testing.assert_allclose(a[k], v, rtol=1e-5, err_msg=k)
    assert want["test_metrics"]


@pytest.mark.parametrize("preset", PRESETS)
def test_baseline_trains_on_two_data_ranks(preset, crello_dir, tmp_path,
                                           alone):
    _trains_as_alone(preset, 1, crello_dir, tmp_path, alone)


@pytest.mark.parametrize("preset", PRESETS)
def test_baseline_trains_tensor_parallel(preset, crello_dir, tmp_path,
                                         alone):
    _trains_as_alone(preset, 2, crello_dir, tmp_path, alone)
