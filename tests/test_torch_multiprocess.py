"""The port's entry points on more than one rank, on the CPU (gloo).

* ``python -m flexdm_tpu_torch --num_devices 2 --device cpu`` (and with
  ``--model_parallel 2``) trains a tiny crello job: in host mode its
  history is the single-process run's to 1e-5, rank 0 alone writes the
  job's files, and ``args.json`` records the grid.
* The ranks of a data-parallel and of a tensor-parallel run end with the
  same parameters, bit for bit.
* ``--resume`` on 1 rank continues a 2-rank job's ``last``, and on 2 ranks
  a 1-rank job's, as the same resume on the job's own layout does.
* ``python -m flexdm_tpu_torch.evaluation --num_devices 2 --device cpu``
  gives the 1-rank scores.
* ``--dtype bfloat16`` with ``remat`` trains tensor-parallel.

Every spawned group has a hard time limit.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flexdm_tpu_torch import cli  # noqa: E402
from flexdm_tpu_torch.config import TrainConfig  # noqa: E402
from flexdm_tpu_torch.evaluation import harness  # noqa: E402
from flexdm_tpu_torch.parallel import mesh  # noqa: E402
from flexdm_tpu_torch.train import trainer  # noqa: E402
from flexdm_tpu_torch.train.checkpoint import checkpoint_path  # noqa: E402
from tests import _torch_ranks as ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--latent_dim", "32", "--num_blocks", "1", "--batch_size", "16",
        "--validation_freq", "1", "--device", "cpu"]


def _config(data_dir, job, **kwargs):
    base = dict(dataset_name="crello", data_dir=data_dir, job_dir=str(job),
                latent_dim=32, num_blocks=1, batch_size=16, num_epochs=1,
                validation_freq=1, input_mode="host", device="cpu")
    base.update(kwargs)
    return TrainConfig(**base)


def _cli(module, args, timeout=ranks.TIMEOUT_S):
    return subprocess.run(
        [sys.executable, "-m", module, *args], cwd=ROOT, timeout=timeout,
        capture_output=True, text=True, check=True).stdout


def _history(job):
    with open(os.path.join(job, "logs", "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def _assert_histories_close(got, want):
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want]
    for a, b in zip(got, want):
        for k, v in b.items():
            if k != "wall_time" and isinstance(v, float):
                np.testing.assert_allclose(a[k], v, rtol=1e-5, err_msg=k)


def _preset(data_dir, job):
    return ["--preset", "crello_ours_exp", "--data_dir", data_dir,
            "--job-dir", job, "--num_epochs", "1", "--input_mode", "host",
            *TINY]


@pytest.fixture(scope="module")
def single_job(crello_dir, tmp_path_factory):
    job = str(tmp_path_factory.mktemp("single") / "job")
    cli.main(_preset(crello_dir, job))
    return job


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_cli_trains_on_two_cpu_ranks(crello_dir, single_job, tmp_path,
                                     model_parallel):
    job = str(tmp_path / "job")
    out = _cli("flexdm_tpu_torch", _preset(crello_dir, job) + [
        "--num_devices", "2", "--model_parallel", str(model_parallel)])
    assert out.count("test metrics:") == 1
    _assert_histories_close(_history(job), _history(single_job))
    with open(os.path.join(job, "args.json")) as f:
        args = json.load(f)
    assert (args["num_devices"], args["model_parallel"]) == (2,
                                                             model_parallel)
    for name in ("best", "final", "last"):
        assert os.path.exists(checkpoint_path(job, name))
    names = os.listdir(os.path.join(job, "checkpoints"))
    assert not [n for n in names if n.endswith(".tmp")]


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_ranks_end_with_the_same_parameters(crello_dir, tmp_path,
                                            model_parallel):
    """Device mode (the split spread over the data ranks when there are
    two), dropout on: every rank's whole parameters after training."""
    config = _config(crello_dir, tmp_path / "job", input_mode="device",
                     num_epochs=1)
    params = mesh.spawn(ranks.train_worker, 2, (2, model_parallel, config),
                        timeout=ranks.TIMEOUT_S, cpu=True)
    assert set(params[0]) == set(params[1])
    for k, v in params[0].items():
        np.testing.assert_array_equal(params[1][k], v, err_msg=k)


@pytest.fixture(scope="module")
def resumed_reference(crello_dir, tmp_path_factory):
    """A 1-process job of 1 epoch resumed on 1 process for a second."""
    job = tmp_path_factory.mktemp("reference") / "job"
    trainer.train(_config(crello_dir, job))
    trainer.train(_config(crello_dir, job, num_epochs=2, resume=True))
    return str(job)


@pytest.mark.parametrize("first, then", [(2, None), (None, 2)])
def test_resume_across_rank_counts(crello_dir, resumed_reference, tmp_path,
                                   first, then):
    """A job's ``last`` continues on another number of ranks as on its
    own: ``first`` ranks for an epoch, then ``then`` for a second (None:
    one process)."""
    job = tmp_path / "job"
    trainer.train(_config(crello_dir, job, num_devices=first))
    resumed = trainer.train(_config(crello_dir, job, num_devices=then,
                                    num_epochs=2, resume=True))
    assert [h["epoch"] for h in resumed["history"]] == [2]
    _assert_histories_close(_history(str(job)), _history(resumed_reference))


def test_eval_cli_on_two_cpu_ranks(single_job, tmp_path):
    args = ["--job-dir", single_job, "--task_mode", "all_feat",
            "--batch_size", "16", "--device", "cpu"]
    want = harness.main(args)
    csv_path = str(tmp_path / "scores.csv")
    _cli("flexdm_tpu_torch.evaluation",
         args + ["--num_devices", "2", "--result_csv", csv_path])
    with open(csv_path) as f:
        keys, values = list(csv.reader(f))
    assert keys == list(want)
    np.testing.assert_allclose([float(v) for v in values],
                               list(want.values()), atol=1e-4)


def test_bf16_and_remat_on_two_ranks(crello_dir, tmp_path):
    """``--dtype bfloat16`` with ``remat`` on one data rank by two model
    ranks: the row-parallel sums are taken in bf16 on each rank, so the
    loss is the single process's within one bf16 ulp (2^-7) relative."""
    kwargs = dict(dtype="bfloat16", remat=True)
    alone = trainer.train(_config(crello_dir, tmp_path / "alone", **kwargs))
    ranks_run = trainer.train(_config(crello_dir, tmp_path / "ranks",
                                      num_devices=2, model_parallel=2,
                                      **kwargs))
    np.testing.assert_allclose(ranks_run["history"][0]["loss"],
                               alone["history"][0]["loss"], rtol=2**-7)
    with open(os.path.join(tmp_path / "ranks", "args.json")) as f:
        assert json.load(f)["dtype"] == "bfloat16"
