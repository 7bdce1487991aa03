"""One "node" of a run over more than one node (not a pytest module).

    python tests/_torch_node_worker.py SPEC.json

The parent sets the variables ``torchrun --nnodes N --node_rank r
--nproc_per_node 1`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK=0``,
``LOCAL_WORLD_SIZE=1``, ``MASTER_ADDR``, ``MASTER_PORT``) and ``NODE_T0``,
its clock when it started this process.  The worker runs the training
CLI's ``main`` on ``SPEC["train_argv"]`` (``--num_devices N``: it joins the
group the variables describe) and then, on ``SPEC["eval_port"]``, the eval
CLI's ``main`` on ``SPEC["eval_argv"]``, both under ``SPEC["backend"]``
(``gloo`` for several nodes on one card: the training CLI's call of
``trainer.train`` gets it as a keyword).  It records what this rank saw
and writes it to ``SPEC["out"]`` as JSON: the grid's ``num_hosts`` and
``host_id``, the trainer's warnings, the trainer's return value on this
rank (rank 0's alone leaves the CLI), each training step's ms (the card
synchronised around it), the seconds from ``NODE_T0`` to the group joined
and to the first step, the attention kernels' launches in training, the
eval tasks' sums over the data ranks, whether each task streamed, and
rank 0's scores.  It imports no JAX: the card's smoke run starts it too.

:func:`start_nodes` and :func:`wait_nodes` start and collect such nodes;
:func:`hosts_as_one` gives a one-process run the nodes' global batches.
"""

import contextlib
import functools
import json
import logging
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from flexdm_tpu_torch import cli  # noqa: E402
from flexdm_tpu_torch.data import DatasetSpec  # noqa: E402
from flexdm_tpu_torch.evaluation import harness  # noqa: E402
from flexdm_tpu_torch.ops import attention as attn  # noqa: E402
from flexdm_tpu_torch.train import trainer  # noqa: E402


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_nodes(specs, root):
    """One worker process per spec (node ``r`` runs ``specs[r]``, written
    to ``root``), joined at a free port of this host; returns them."""
    port = free_port()
    procs = []
    for r, spec in enumerate(specs):
        path = os.path.join(root, f"node_spec_{r}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(len(specs)),
                   LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   NODE_T0=repr(time.time()))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def wait_nodes(procs, specs, timeout):
    """Each node's record (its ``out`` file), after all have ended within
    ``timeout`` seconds; a node still running then is killed, and a node
    that failed raises with the end of its output."""
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"node {r} exited with {p.returncode}:\n"
                               f"{log[-4000:]}")
    nodes = []
    for spec in specs:
        with open(spec["out"]) as f:
            nodes.append(json.load(f))
    return nodes


class HostsAsOne:
    """The nodes' train loaders as one: each batch is node 0's rows, then
    node 1's, ... (the global batch the nodes train on)."""

    num_hosts = 1

    def __init__(self, loaders):
        self.loaders = loaders
        self.global_num_records = loaders[0].global_num_records

    def __iter__(self):
        for parts in zip(*self.loaders):
            yield {k: np.concatenate([p[k] for p in parts])
                   if isinstance(v, np.ndarray) else v
                   for k, v in parts[0].items()}


@contextlib.contextmanager
def recorded_sums():
    """While entered, every ``harness.task_sums`` call's result goes into
    the dict it yields, under its task mode."""
    real, sums = harness.task_sums, {}

    def recording(model, loader, task_mode, *args, **kwargs):
        sums[task_mode] = real(model, loader, task_mode, *args, **kwargs)
        return sums[task_mode]

    harness.task_sums = recording
    try:
        yield sums
    finally:
        harness.task_sums = real


@contextlib.contextmanager
def hosts_as_one(nodes):
    """While entered, ``DatasetSpec.make_dataset("train", ...)`` gives the
    loaders of ``nodes`` nodes (a ``1 / nodes`` slice of the batch each) as
    one :class:`HostsAsOne`: a one-process run in host mode then trains on
    the nodes' global batches."""
    make_dataset = DatasetSpec.make_dataset

    def as_one(self, split, **kwargs):
        if split != "train":
            return make_dataset(self, split, **kwargs)
        kwargs["batch_size"] //= nodes
        return HostsAsOne([make_dataset(self, split, **dict(
            kwargs, num_hosts=nodes, host_id=h)) for h in range(nodes)])

    DatasetSpec.make_dataset = as_one
    try:
        yield
    finally:
        DatasetSpec.make_dataset = make_dataset


class Records(logging.Handler):
    def __init__(self, level):
        super().__init__(level)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _since_start():
    return time.time() - float(os.environ["NODE_T0"])


def main(spec_path):
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec.get("threads", 2))
    out = {"rank": int(os.environ["RANK"]), "import_s": _since_start(),
           "step_ms": []}
    warnings = Records(logging.WARNING)
    logging.getLogger("flexdm_tpu_torch").addHandler(warnings)
    streamed = Records(logging.INFO)
    logging.getLogger(harness.__name__).addHandler(streamed)
    logging.getLogger(harness.__name__).setLevel(logging.INFO)

    real_train, real_step = trainer._train, trainer.make_train_step
    entry = trainer.train

    def recording_train(config, grid=None):
        out.update(joined_s=_since_start(), num_hosts=grid.num_hosts,
                   host_id=grid.host_id, world_size=grid.world_size)
        out["result"] = real_train(config, grid)
        return out["result"]

    def timed_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def timed(batch, draws):
            cuda = batch["length"].is_cuda
            if cuda:
                torch.cuda.synchronize()
            if "first_step_s" not in out:
                out["first_step_s"] = _since_start()
            t0 = time.perf_counter()
            metrics = step(batch, draws)
            if cuda:
                torch.cuda.synchronize()
            out["step_ms"].append(1000 * (time.perf_counter() - t0))
            return metrics

        return timed

    trainer._train, trainer.make_train_step = recording_train, timed_step
    # The CLI calls trainer.train(config); the spec's backend goes in here.
    trainer.train = functools.partial(entry, backend=spec.get("backend"))
    try:
        cli.main(spec["train_argv"])
    finally:
        trainer._train, trainer.make_train_step = real_train, real_step
        trainer.train = entry
    out["warnings"] = warnings.lines
    out["launches"] = attn.launch_counts()

    if spec.get("eval_argv"):
        os.environ["MASTER_PORT"] = str(spec["eval_port"])
        t0 = time.perf_counter()
        with recorded_sums() as sums:
            out["eval_final"] = harness.main(spec["eval_argv"],
                                             backend=spec.get("backend"))
        out["eval_s"] = time.perf_counter() - t0
        out["sums"] = sums
        out["streamed"] = [line.split()[1].rstrip(":")
                           for line in streamed.lines if "streaming" in line]
    with open(spec["out"], "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
