"""A run over more than one node, on the CPU: two "nodes" on one host.

Each node is a process with the variables ``torchrun --nnodes 2
--node_rank r --nproc_per_node 1`` sets (``tests/_torch_node_worker.py``):
it runs ``python -m flexdm_tpu_torch``'s ``main`` with ``--num_devices 2``
(default ``--input_mode device``) on a tiny crello job, then the eval
CLI's with ``--task_mode all_feat --num_devices 2``.  The bars are the
JAX package's (``tests/test_multiprocess.py``):

* ``from_env`` makes a grid of 2 hosts, this node's ``host_id`` its rank;
  device mode falls back to host mode with a warning;
* the two ranks' histories and test metrics are bitwise equal (JAX: rtol
  1e-6);
* the run is, within 1e-5 relative, a one-process run fed the same global
  batches (node 0's rows, then node 1's, at each step), and its last loss
  within 20% of the plain one-process run's;
* only rank 0 writes ``args.json``, ``history.jsonl`` and checkpoints;
* eval on two nodes streams, and its sums are within 2e-5 relative of the
  harness alone.

The nodes run once for the module, with a hard time limit; the reference
runs go on in this process meanwhile.
"""

import csv
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flexdm_tpu_torch.config import TrainConfig  # noqa: E402
from flexdm_tpu_torch.demo import load_model  # noqa: E402
from flexdm_tpu_torch.evaluation import harness  # noqa: E402
from flexdm_tpu_torch.parallel import mesh  # noqa: E402
from flexdm_tpu_torch.train import trainer  # noqa: E402
from tests import _torch_node_worker as nodes  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES = 2
TIMEOUT_S = 120  # the two nodes' hard limit
# JAX's run length and learning rate (tests/_multiproc_worker.py), on the
# crello preset at a tiny width.
SIZES = dict(latent_dim=32, num_blocks=1, batch_size=16, num_epochs=3,
             validation_freq=1, learning_rate=1e-3)
EVAL_BATCH = 16


def _train_argv(data_dir, job):
    argv = ["--preset", "crello_ours_exp", "--data_dir", data_dir,
            "--job-dir", job, "--device", "cpu", "--log_level", "WARNING",
            "--num_devices", str(NODES)]
    for k, v in SIZES.items():
        argv += [f"--{k}", str(v)]
    return argv


def _specs(data_dir, tmp):
    eval_port = nodes.free_port()
    return [{"train_argv": _train_argv(data_dir, str(tmp / f"job_{r}")),
             "eval_argv": ["--job-dir", str(tmp / "job_0"), "--task_mode",
                           "all_feat", "--batch_size", str(EVAL_BATCH),
                           "--device", "cpu", "--num_devices", str(NODES),
                           "--result_csv", str(tmp / f"scores_{r}.csv")],
             "eval_port": eval_port, "out": str(tmp / f"node_{r}.json")}
            for r in range(NODES)]


def _config(data_dir, job, **kwargs):
    """The nodes' job (the preset and ``SIZES``) in one process."""
    with open(os.path.join(ROOT, "configs", "crello_ours_exp.json")) as f:
        preset = json.load(f)
    return TrainConfig(**dict(preset, data_dir=data_dir, job_dir=str(job),
                              device="cpu", **SIZES, **kwargs))


@pytest.fixture(scope="module")
def runs(crello_dir, tmp_path_factory):
    """The two nodes, and meanwhile in this process: the one-process run
    fed the nodes' global batches (host mode), the plain one-process run
    and the eval harness alone on node 0's job."""
    tmp = tmp_path_factory.mktemp("nodes")
    specs = _specs(crello_dir, tmp)
    procs = nodes.start_nodes(specs, str(tmp))
    try:
        with nodes.hosts_as_one(NODES):
            same = trainer.train(_config(crello_dir, tmp / "same",
                                         input_mode="host"))
        plain = trainer.train(_config(crello_dir, tmp / "plain"))
    except BaseException:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    ran = nodes.wait_nodes(procs, specs, TIMEOUT_S)
    model, spec = load_model(str(tmp / "job_0"), batch_size=EVAL_BATCH,
                             device="cpu")
    loader = spec.make_dataset("test", batch_size=EVAL_BATCH)
    alone = {name: harness.task_sums(model, loader, name, (name, keys),
                                     resident=False)
             for name, keys in spec.schema.attribute_groups.items()
             if name != "type"}
    return dict(tmp=tmp, nodes=ran, same=same, plain=plain, alone=alone)


def _floats(record):
    return {k: v for k, v in record.items()
            if isinstance(v, float) and k != "wall_time"}


def test_from_env_makes_a_grid_of_two_hosts(runs):
    for r, node in enumerate(runs["nodes"]):
        assert (node["rank"], node["world_size"]) == (r, NODES)
        assert (node["num_hosts"], node["host_id"]) == (NODES, r)


def test_device_mode_falls_back_to_host_mode(runs):
    for node in runs["nodes"]:
        assert any("input_mode='device' is one host's" in line
                   for line in node["warnings"]), node["warnings"]


def test_ranks_are_bitwise_equal(runs):
    a, b = (node["result"] for node in runs["nodes"])
    assert len(a["history"]) == SIZES["num_epochs"]
    assert [_floats(h) for h in a["history"]] == [
        _floats(h) for h in b["history"]]
    assert a["test_metrics"] == b["test_metrics"]
    assert a["best_val_total_score"] == b["best_val_total_score"]


def test_matches_one_process_on_the_same_global_batches(runs):
    got, want = runs["nodes"][0]["result"], runs["same"]
    assert [h["step"] for h in got["history"]] == [
        h["step"] for h in want["history"]]
    for g, w in zip(got["history"], want["history"]):
        g, w = _floats(g), _floats(w)
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    for k, v in want["test_metrics"].items():
        np.testing.assert_allclose(got["test_metrics"][k], v, rtol=1e-5,
                                   err_msg=k)


def test_loss_near_the_plain_one_process_run(runs):
    got = runs["nodes"][0]["result"]["history"][-1]["loss"]
    want = runs["plain"]["history"][-1]["loss"]
    assert abs(got - want) / want < 0.2, (got, want)


def test_only_rank_0_writes(runs):
    tmp = runs["tmp"]
    for name in ("args.json", os.path.join("logs", "history.jsonl"),
                 "checkpoints"):
        assert os.path.exists(tmp / "job_0" / name), name
        assert not os.path.exists(tmp / "job_1" / name), name
    for name in ("best", "final", "last"):
        assert os.path.exists(trainer.checkpoint_path(str(tmp / "job_0"),
                                                      name))
    assert os.path.exists(tmp / "scores_0.csv")
    assert not os.path.exists(tmp / "scores_1.csv")


def test_eval_streams_and_matches_alone(runs):
    alone = runs["alone"]
    for node in runs["nodes"]:
        assert sorted(node["streamed"]) == sorted(alone)
        assert set(node["sums"]) == set(alone)
        for task, want in alone.items():
            got = node["sums"][task]
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=2e-5,
                                           err_msg=f"{task} {k}")
    assert runs["nodes"][0]["sums"] == runs["nodes"][1]["sums"]
    final = runs["nodes"][0]["eval_final"]
    assert runs["nodes"][1]["eval_final"] is None
    with open(runs["tmp"] / "scores_0.csv") as f:
        keys, values = list(csv.reader(f))
    assert keys == list(final)
    np.testing.assert_allclose([float(v) for v in values],
                               list(final.values()), rtol=0, atol=0)


def test_model_parallel_across_one_rank_nodes_raises(monkeypatch):
    """A model group may not cross nodes: ``--model_parallel 2`` on nodes
    of one rank each raises before joining any group."""
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="ranks of a node"):
        mesh.from_env(2, "cpu")
