"""Rank workers of the port's multi-device tests (not a pytest module).

Spawned by ``flexdm_tpu_torch.parallel.mesh.spawn``, so this module
imports no JAX: each worker builds the port's model from the weights it is
given, takes one training step on its rows of the global batch with the
draws it is given, and returns numpy arrays (the whole parameters after
the step, gathered over the model group) to the test.
"""

import torch

from flexdm_tpu_torch.convert import load_jax_params, params_to_jax
from flexdm_tpu_torch.data import DatasetSpec
from flexdm_tpu_torch.data.schema import (
    CATEGORICAL,
    NUMERICAL,
    ColumnSpec,
    LossCondition,
    Schema,
)
from flexdm_tpu_torch.evaluation.harness import evaluate_all, task_sums
from flexdm_tpu_torch.models import baselines, losses, mfp
from flexdm_tpu_torch.models.masking import TrainDraws
from flexdm_tpu_torch.parallel import mesh
from flexdm_tpu_torch.train.optim import clip_by_per_leaf_norm, l2_penalty
from flexdm_tpu_torch.train.trainer import global_metrics, make_train_step

TIMEOUT_S = 240  # every spawned group's hard limit


class SGD:
    """``p -= lr * g``: a step linear in the gradients, so two layouts'
    parameters differ by ``lr`` times their gradients' round-off (keras
    Adam turns a sign flip of a gradient that is 0 in exact arithmetic
    into a step of ``lr``), as the JAX package's mesh tests use
    ``optax.sgd``."""

    def __init__(self, params, lr):
        self.params = list(params)
        self.lr = lr

    @torch.no_grad()
    def step(self, grads):
        torch._foreach_add_(self.params, list(grads), alpha=-self.lr)


def build(spec, weights, model_kwargs):
    model = mfp.MFPModel(spec.schema, **model_kwargs)
    return load_jax_params(model, weights)


def draws_of(draws, rows):
    """A :class:`TrainDraws` of rows ``rows`` from the numpy draws."""
    t = {k: (None if v is None else
             {c: torch.from_numpy(x) for c, x in v.items()}
             if isinstance(v, dict) else torch.from_numpy(v))
         for k, v in draws.items()}
    return TrainDraws(t["tasks"], t["uniforms"], t["element"], t["values"],
                      shuffle=t["shuffle"]).rows(rows)


def step_on_grid(grid, spec, weights, batch, draws, method, lr, l2,
                 model_kwargs, eval_task=None):
    """One SGD step of the port on ``grid`` (None: in this process
    alone); returns this rank's view:
    the global metrics, the whole parameters after the step, each split
    parameter's name and, with ``eval_task`` (name, columns), the test
    split's sums before the step."""
    model = build(spec, weights, model_kwargs)
    b = batch["length"].shape[0]
    rows = slice(0, b)
    if grid is not None:
        mesh.shard_params(model, grid)
        rows = grid.rows(b)
    out = {"split": sorted(n for n, p in model.named_parameters()
                           if getattr(p, "tp_split", None) is not None)}
    if eval_task is not None:
        loader = spec.make_dataset("test", batch_size=16)
        out["eval"] = task_sums(model, loader, eval_task[0], eval_task,
                                grid=grid)
    task_config = mfp.make_task_config(spec.schema, method)
    step = make_train_step(model, task_config, SGD(model.parameters(), lr),
                           l2, grid)
    metrics = step({k: torch.from_numpy(v[rows]) for k, v in batch.items()},
                   draws_of(draws, rows))
    out["metrics"] = ({k: float(v) for k, v in metrics.items()}
                      if grid is None else global_metrics(
                          metrics, grid, b, len(spec.schema.columns)))
    out["params"] = params_to_jax(mesh.gather_params(model))
    return out


def tiny_schema(max_length=6):
    """The port's copy of ``tests/test_masking.py``'s ``tiny_schema``."""
    return Schema("crello", (
        ColumnSpec("length", CATEGORICAL, (1,), False, input_dim=max_length),
        ColumnSpec("type", CATEGORICAL, (1,), True, input_dim=3,
                   primary_label=0),
        ColumnSpec("left", CATEGORICAL, (1,), True, input_dim=8),
        ColumnSpec("width", CATEGORICAL, (1,), True, input_dim=8),
        ColumnSpec("top", CATEGORICAL, (1,), True, input_dim=8),
        ColumnSpec("height", CATEGORICAL, (1,), True, input_dim=8),
        ColumnSpec("emb", NUMERICAL, (4,), True,
                   loss_condition=LossCondition("type", (False, True, False))),
    ), max_length=max_length)


class RecordsLoader:
    """The rows of a numpy batch as a split: the records and batch size
    the resident harness reads."""

    def __init__(self, batch, batch_size):
        self.batch_size = batch_size
        self.num_records = len(batch["length"])
        self._batch = batch

    def _record(self, i):
        return {k: v[i] for k, v in self._batch.items()}


def baseline_step(grid, schema, name, weights, inputs, lr, l2,
                  model_kwargs, elem_chunk=None):
    """One SGD step of the baseline ``name`` (a class of
    :mod:`flexdm_tpu_torch.models.baselines`) on ``grid`` (None: alone):
    its training branch on ``inputs`` (numpy ``modified``, ``targets``,
    ``masks``) without VAE noise, the ``*_loss`` terms and L2 added, the
    per-tensor clip; returns the loss, the whole parameters after the
    step and the split parameters' names and, with ``elem_chunk``, the
    ``elem`` sums over the targets' records, ``elem_chunk`` replicas a
    chunk, before the step."""
    model = load_jax_params(getattr(baselines, name)(schema, **model_kwargs),
                            weights)
    if grid is not None:
        mesh.shard_params(model, grid)
    out = {"split": sorted(n for n, p in model.named_parameters()
                           if getattr(p, "tp_split", None) is not None)}
    if elem_chunk is not None:
        out["eval"] = task_sums(model, RecordsLoader(inputs["targets"], 4),
                                "elem", None, elem_chunk=elem_chunk,
                                grid=grid)
    t = {k: {c: torch.from_numpy(v.copy()) for c, v in d.items()}
         for k, d in inputs.items()}
    outputs, aux = mfp.apply_model(model, t["modified"], t["targets"],
                                   t["masks"], deterministic=False)
    loss, _ = losses.compute_mfp_loss(schema, t["targets"], outputs,
                                      t["masks"])
    for k, v in aux.items():
        if k.endswith("_loss"):
            loss = loss + v
    loss = loss + l2 * l2_penalty(model)
    params = list(model.parameters())
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        params, torch.autograd.grad(loss, params, allow_unused=True))]
    clip_by_per_leaf_norm(grads, 1.0, params)
    SGD(params, lr).step(grads)
    out["loss"] = loss.item()
    out["params"] = params_to_jax(mesh.gather_params(model))
    return out


def baseline_step_worker(rank, store, world, model_parallel, cases, lr, l2,
                         model_kwargs, elem_chunk):
    """Rank ``rank`` of ``world`` CPU ranks in a grid of
    ``model_parallel`` model ranks: :func:`baseline_step` of each
    ``(name, weights, inputs)`` of ``cases`` on :func:`tiny_schema`,
    ``{name: result}``; the first case also scores ``elem``."""
    grid = mesh.init_grid(rank, world, model_parallel, "cpu", "gloo", store)
    try:
        return {name: baseline_step(grid, tiny_schema(), name, weights,
                                    inputs, lr, l2, model_kwargs,
                                    elem_chunk if i == 0 else None)
                for i, (name, weights, inputs) in enumerate(cases)}
    finally:
        mesh.teardown()


def step_worker(rank, store, world, layouts, data_dir, dataset, weights,
                batch, draws, method, lr, l2, model_kwargs, eval_task):
    """Rank ``rank`` of ``world`` CPU ranks: :func:`step_on_grid` on a
    grid of each ``model_parallel`` in ``layouts``, in turn."""
    spec = DatasetSpec(dataset, data_dir, 16)
    grid = mesh.init_grid(rank, world, layouts[0], "cpu", "gloo", store)
    try:
        results = []
        for i, m in enumerate(layouts):
            g = grid if i == 0 else mesh.new_grid(m, "cpu")
            results.append(step_on_grid(
                g, spec, weights, batch, draws, method, lr, l2,
                model_kwargs, eval_task if m > 1 else None))
        return results
    finally:
        mesh.teardown()


def eval_worker(rank, store, world, data_dir, dataset, weights,
                model_kwargs, tasks, batch_sizes):
    """``{(task, batch size): sums}`` of the test split on ``world`` CPU
    data ranks; ``tasks`` are ``(name, group)`` pairs."""
    spec = DatasetSpec(dataset, data_dir, 16)
    grid = mesh.init_grid(rank, world, 1, "cpu", "gloo", store)
    try:
        model = build(spec, weights, model_kwargs)
        return {(name, b): task_sums(
                    model, spec.make_dataset("test", batch_size=b), name,
                    group, grid=grid)
                for name, group in tasks for b in batch_sizes}
    finally:
        mesh.teardown()


def evaluate_all_worker(rank, store, world, data_dir, dataset, weights,
                        model_kwargs, modes, batch_size):
    """``[(scores, records decoded)]`` of ``evaluate_all`` for each task
    mode of ``modes`` over the test split on ``world`` CPU data ranks."""
    spec = DatasetSpec(dataset, data_dir, 16)
    decode = spec.decode_record
    decoded = []

    def counted(payload):
        decoded.append(payload)
        return decode(payload)

    spec.decode_record = counted
    grid = mesh.init_grid(rank, world, 1, "cpu", "gloo", store)
    try:
        model = build(spec, weights, model_kwargs)
        out = []
        for mode in modes:
            decoded.clear()
            out.append((evaluate_all(model, spec, mode, batch_size,
                                     grid=grid), len(decoded)))
        return out
    finally:
        mesh.teardown()


def train_worker(rank, store, world, model_parallel, config):
    """Rank ``rank``'s ``train()`` loop (``config`` without
    ``num_devices``: the grid is made here); returns the whole parameters
    this rank ends with."""
    from flexdm_tpu_torch.train import trainer

    models = []
    shard = mesh.shard_params

    def keep(model, grid, optimizer=None):
        models.append(model)
        shard(model, grid, optimizer)

    mesh.shard_params = keep
    grid = mesh.init_grid(rank, world, model_parallel, "cpu", "gloo", store)
    try:
        trainer._train(config, grid)
        return params_to_jax(mesh.gather_params(models[0]))
    finally:
        mesh.teardown()
