"""The baselines on two data ranks, on the CPU (gloo), at a tiny size (D=16,
1 block, batch 32, one epoch on the crello fixture, dropout on).

``train()`` in host mode on 2 data ranks gives the single-process history
(training loss and scores, validation and test) to 1e-5 relative, and both
ranks end with the same parameters, bit for bit.  Every rank draws the
global batch's task draws, AutoReg's and BART's element shuffle, dropout
and the VAE noise (CanvasVAE's ``Head``, LayoutVAE's per-element
posteriors and priors) and keeps its rows, so any draw that is not
batch-first, or that a rank draws for its own rows only, breaks one of the
two.  Every spawned group has a hard time limit.
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


@pytest.mark.parametrize("preset", PRESETS)
def test_baseline_trains_on_two_data_ranks(preset, crello_dir, tmp_path):
    alone = trainer.train(_config(preset, crello_dir, tmp_path / "alone"))
    job = tmp_path / "ranks"
    params = mesh.spawn(ranks.train_worker, 2,
                        (2, 1, _config(preset, crello_dir, job)),
                        timeout=ranks.TIMEOUT_S, cpu=True)
    assert set(params[0]) == set(params[1])
    for k, v in params[0].items():
        np.testing.assert_array_equal(params[1][k], v, err_msg=k)
    got, want = _history(str(job)), alone["history"]
    assert [h["step"] for h in got] == [h["step"] for h in want] == [3]
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k, v in b.items():
            if k != "wall_time" and isinstance(v, float):
                np.testing.assert_allclose(a[k], v, rtol=1e-5, err_msg=k)
    assert alone["test_metrics"]
