"""Training loop (PyTorch): one eager step per batch, epochs on the host.

Counterpart of ``flexdm_tpu/train/trainer.py`` on one device, for the
oneshot model and the four baselines.  A step draws its task ids, MLM
uniforms, element picks, replacement values, dropout masks and, where the
model needs them, the shuffle uniforms, the element-wise noise and a VAE
baseline's reparameterisation normals from one ``torch.Generator`` on the
device, masks the batch per task, runs the model (attention through the
CUDA kernels on a card), adds the baseline's auxiliary losses and the L2
penalty,
back-propagates, clips each gradient to norm 1 and takes a keras-Adam
step.

Protocol as in the JAX trainer:

* **Input.**  ``input_mode='device'`` (the default) uploads the whole
  train split once (:class:`~..data.pipeline.DeviceDataCache`); an epoch
  uploads its ``(steps, B)`` index block once and gathers each step's
  batch on the device, the JAX device mode's records in its order.
  ``'host'`` streams the host ``DataLoader``'s batches
  (``drop_remainder``) through a :class:`~..data.pipeline.Prefetcher`
  thread; on a card that thread pins each batch and copies it on a side
  stream (:class:`PinnedCopy`).  The draws stay on the main thread, in
  step order, so neither mode's prefetching changes a result.
* **Checkpoints.**  ``best`` by max ``val_total_score`` (validation every
  ``validation_freq`` epochs, on the same randomly masked objective with
  exact num/den scores); ``final`` at the end; ``last`` (weights, Adam
  state, step, generator state, best-score watermark) every
  ``checkpoint_every`` epochs and at the end.  ``resume`` restores
  ``last`` and restarts at epoch ``1 + step // steps_per_epoch``; in host
  mode the loader restarts its shuffle, as JAX's does.  ``weights``
  warm-starts the parameters from a ``*.torch.npz`` weight file.
* **Stop.**  When the loss or a parameter is not finite at an epoch's end,
  the run stops with nothing saved, so the earlier ``last`` stays
  restorable.
* **Logs.**  ``args.json`` and ``logs/history.jsonl`` in the job dir,
  TensorBoard scalars in ``logs/`` and, with ``enable_profile``, a
  ``torch.profiler`` trace of the epochs in ``logs/trace``.

Validation draws come per record (:func:`~..models.masking.record_draws`),
so its scores do not change with the batch size or the padding of the last
batch.

**More than one device** (``config.num_devices``; the grid, the batch
placement and the partition rules are :mod:`..parallel.mesh`'s).
:func:`train` spawns the ranks (or, under ``torchrun``, joins the group)
and every rank runs the same loop on its rows of each global batch:

* every rank draws the global batch's task draws, dropout masks and VAE
  normals from the one seeded generator and keeps its rows
  (:class:`~..ops.rng.BatchRows`), so the generators stay in lockstep and
  a data-parallel step equals the single-process step of the same global
  batch;
* the gradient is the mean over the data ranks, one all-reduce of a flat
  bucket a step, before the per-tensor clip; tensor-parallel ranks keep
  their slices of the split parameters and of their Adam moments;
* the device mode spreads the split over the data ranks (JAX's mesh mode:
  a stratified, device-aligned shuffle); the host mode gives each node a
  1-in-``num_hosts`` record stride and its slice of the global batch, and
  every rank runs the steps the global record count gives
  (:func:`_steps_per_epoch`);
* the epoch's metrics and the validation and test sums are summed over the
  data ranks as (Σnum, Σden) and loss sums, so every rank holds the same
  scores and agrees on writing ``best``;
* only rank 0 writes ``args.json``, ``history.jsonl``, TensorBoard and the
  profiler trace, and the checkpoints, gathered whole in the
  single-device format.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import math
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrainConfig, build_model
from ..convert import init_params, load_weights
from ..data import NUM_VALID_KEY, DatasetSpec, split_device_batch
from ..data.pipeline import DeviceDataCache, Prefetcher
from ..models import forward_train, make_task_config
from ..models.masking import draw_train, record_draws
from ..models.mfp import draw_options
from ..ops.attention import check_head_dim, check_impl
from ..ops.rng import BatchRows
from ..parallel import mesh
from ..utils.profiling import trace_context
from ..utils.tboard import SummaryWriter
from .checkpoint import checkpoint_path, load_last, save_checkpoint, \
    save_last
from .optim import KerasAdam, clip_by_per_leaf_norm, l2_penalty

logger = logging.getLogger(__name__)

CLIPNORM = 1.0


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (host-only entries dropped)."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in split_device_batch(batch).items()}


class PinnedCopy:
    """The host-to-card copy of a prefetched batch.

    :meth:`__call__` runs in the :class:`Prefetcher`'s worker: it pins the
    batch's arrays, copies them with ``non_blocking=True`` on a side
    stream and records an event after the copy.  :meth:`take` runs on the
    consumer's thread: the current stream waits for that event (a step
    never reads a half-copied batch) and each tensor is recorded on the
    current stream (the caching allocator does not hand its memory to a
    later copy while a step still reads it).  A batch's pinned buffers are
    kept until its copy's event has fired: they go when the next batch is
    taken, after a wait on that event.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._held = None  # (event, pinned arrays) of the last batch taken

    def __call__(self, host_batch):
        with torch.cuda.stream(self.stream):
            pinned = {k: torch.from_numpy(v).pin_memory()
                      for k, v in split_device_batch(host_batch).items()}
            batch = {k: v.to(self.device, non_blocking=True)
                     for k, v in pinned.items()}
            copied = torch.cuda.Event()
            copied.record(self.stream)
        return batch, copied, pinned

    def take(self, item) -> Dict[str, torch.Tensor]:
        batch, copied, pinned = item
        current = torch.cuda.current_stream(self.device)
        current.wait_event(copied)
        for tensor in batch.values():
            tensor.record_stream(current)
        if self._held is not None:
            self._held[0].synchronize()
        self._held = (copied, pinned)
        return batch


def take_rows(host_batch: Dict[str, Any], rows: slice) -> Dict[str, Any]:
    """Rows ``rows`` of every array of a host batch (the counters as they
    are)."""
    return {k: v[rows] if isinstance(v, np.ndarray) else v
            for k, v in host_batch.items()}


class HostBatches:
    """The host mode's device batches: the loader in a
    :class:`Prefetcher` thread, copied to ``device`` there (through
    :class:`PinnedCopy` on a card); ``close()`` stops the thread.
    ``rows``: only those rows of each batch are copied (a rank's)."""

    def __init__(self, loader, device, rows: Optional[slice] = None):
        device = torch.device(device)
        if device.type == "cuda":
            copy = PinnedCopy(device)
            transform, self._take = copy, copy.take
        else:
            transform = functools.partial(to_device, device=device)
            self._take = lambda batch: batch
        if rows is not None:
            loader = (take_rows(b, rows) for b in loader)
        self._prefetcher = Prefetcher(loader, depth=2, transform=transform)
        self._items = iter(self._prefetcher)

    def __next__(self) -> Dict[str, torch.Tensor]:
        return self._take(next(self._items))

    def close(self) -> None:
        self._prefetcher.close()


def make_train_step(model, task_config, optimizer: KerasAdam,
                    l2, grid: Optional[mesh.Grid] = None) -> Callable:
    """``step(batch, draws) -> metrics``: forward, L2, backward, per-tensor
    clip, keras Adam.  A parameter the loss does not reach (the canvas
    heads of a ``context='canvas'`` model under ``l2=0``) gets a zero
    gradient, as ``jax.grad`` gives it, so keras Adam leaves it as it is;
    the first step logs the names of such parameters.  On a ``grid``, the
    batch and draws are this rank's rows, the gradients are averaged over
    the data ranks before the clip, and the metrics are the rank's own
    (:func:`global_metrics` sums them)."""
    names = {id(p): n for n, p in model.named_parameters()}
    logged = []

    def train_step(batch, draws) -> Dict[str, torch.Tensor]:
        loss, metrics = forward_train(model, batch, draws, task_config,
                                      train=True)
        if l2:
            loss = loss + l2 * l2_penalty(model)
            metrics = dict(metrics, loss=loss)
        raw = torch.autograd.grad(loss, optimizer.params, allow_unused=True)
        if not logged:
            logged.append(True)
            unused = [names.get(id(p), "?")
                      for p, g in zip(optimizer.params, raw) if g is None]
            if unused:
                logger.info("no gradient reaches %s: held at zero",
                            ", ".join(unused))
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(optimizer.params, raw)]
        if grid is not None:
            grads = grid.mean_over_data(grads)
        clip_by_per_leaf_norm(grads, CLIPNORM, optimizer.params)
        optimizer.step(grads)
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def step_draws(model, schema, task_config, batch_size: int,
               generator: torch.Generator, rows: Optional[slice] = None):
    """A training step's draws: the global batch's task draws, dropout and
    VAE noise, all from ``generator``; with ``rows`` (a rank of a grid),
    this rank's rows of them."""
    draws = draw_train(schema, batch_size, task_config.task_probs, generator,
                       **draw_options(model))
    if rows is None:
        draws.dropout = draws.vae = generator
    else:
        draws = draws.rows(rows)
        draws.dropout = draws.vae = BatchRows(generator, rows, batch_size)
    return draws


def _scores(sums: Dict[str, float], num_columns: int) -> Dict[str, float]:
    """``{field}_score`` (Σnum / Σden, 1 where Σden is 0) of every field
    in ``sums`` and their ``total_score`` over ``num_columns`` columns."""
    out: Dict[str, float] = {}
    score_total = 0.0
    for k in list(sums):
        if k.endswith("_score_num"):
            field = k[: -len("_score_num")]
            den = sums[f"{field}_score_den"]
            score = 1.0 if den == 0 else sums[k] / den
            out[f"{field}_score"] = score
            score_total += score
    out["total_score"] = score_total / num_columns
    return out


def global_metrics(metrics: Dict[str, torch.Tensor], grid: mesh.Grid,
                   batch: int, num_columns: int) -> Dict[str, float]:
    """A step's metrics over the global batch from each rank's own (one
    all-reduce over the data ranks): the ``*_score_num`` / ``_den`` sums
    summed, the scores and ``total_score`` recomputed from them, the
    losses and any other term averaged (each is a mean over the rank's
    equal share of rows).  One data rank's are its own."""
    if grid.data_size == 1:
        return {k: float(v) for k, v in metrics.items()}
    names = sorted(metrics)
    values = grid.sum_over_data(
        torch.stack([metrics[k].float() for k in names]).tolist(), batch)
    divisor = grid.data_size if grid.splits(batch) else 1
    out = {k: v if k.endswith(("_score_num", "_score_den")) else v / divisor
           for k, v in zip(names, values)}
    out.update(_scores(out, num_columns))
    return out


@torch.no_grad()
def evaluate_split(model, loader, schema, task_config, seed: int,
                   device, grid: Optional[mesh.Grid] = None
                   ) -> Dict[str, float]:
    """The randomly masked objective over a split, with dataset-level
    num/den scores.  Padded batch tails are zeroed through
    ``sample_weight``; record ``i`` of the split is masked by the draws of
    ``(seed, i)`` whatever batch it is in.  On a ``grid``, each rank
    scores its rows of every batch and the sums are summed over the data
    ranks."""
    sums: Dict[str, float] = {}
    losses: Dict[str, float] = {}
    weights_total = 0
    b = loader.batch_size
    for host_batch in loader:
        b = host_batch["length"].shape[0]
        num_valid = host_batch.get(NUM_VALID_KEY, b)
        rows = slice(0, b) if grid is None else grid.rows(b)
        batch = to_device(take_rows(host_batch, rows), device)
        # Padded rows take the next indices; their weight is 0.
        draws = record_draws(
            schema, task_config.task_probs, seed,
            range(weights_total, weights_total + b)[rows],
            **draw_options(model),
        ).to(device)
        sample_weight = torch.zeros(b)
        sample_weight[:num_valid] = 1.0
        _, metrics = forward_train(model, batch, draws, task_config,
                                   train=False,
                                   sample_weight=sample_weight[rows].to(
                                       device))
        names = sorted(metrics)
        values = torch.stack([metrics[k] for k in names]).tolist()
        n = rows.stop - rows.start
        for k, v in zip(names, values):
            if k.endswith("_score_num") or k.endswith("_score_den"):
                sums[k] = sums.get(k, 0.0) + v
            elif k.endswith("_loss") or k == "loss":
                # The loss is a mean over the static batch with padded rows
                # zeroed: recover the sum, renormalise by real samples.
                losses[k] = losses.get(k, 0.0) + v * n
        weights_total += num_valid

    if grid is not None:
        keys = sorted(sums) + sorted(losses)
        totals = dict(zip(keys, grid.sum_over_data(
            [sums[k] for k in sorted(sums)]
            + [losses[k] for k in sorted(losses)], b)))
        sums = {k: totals[k] for k in sums}
        losses = {k: totals[k] for k in losses}
    out = _scores(sums, len(schema.columns))
    for k, v in losses.items():
        out[k] = v / max(weights_total, 1)
    return out


def _all_finite(model, grid: Optional[mesh.Grid] = None) -> bool:
    """Whether every parameter is finite (on every rank)."""
    finite = torch.stack([p.isfinite().all()
                          for p in model.parameters()]).all()
    if grid is not None:
        finite = finite.to(torch.int32)
        dist.all_reduce(finite, op=dist.ReduceOp.MIN)
    return bool(finite)


def _steps_per_epoch(train_loader, batch_size: int) -> int:
    """Steps every rank runs an epoch: the loader drops the remainder, and
    every host derives the count from the pre-shard record count (a host's
    shard may be one record short, and ranks that ran different numbers
    of steps would wait for each other's collectives forever)
    (flexdm_tpu/train/trainer.py:174-194).  ``batch_size`` is the host's
    batch."""
    num_hosts = max(train_loader.num_hosts, 1)
    return max(train_loader.global_num_records // num_hosts // batch_size,
               1)


def check_config(config: TrainConfig) -> None:
    """Refuse, before anything is written, a job the port cannot run."""
    check_impl(config.attention_impl, config.device)
    check_head_dim(config.head_dim, config.attention_impl, config.device)
    if config.input_mode not in ("device", "host"):
        raise ValueError(f"input_mode {config.input_mode!r}: 'device' or "
                         "'host'")
    if config.weights and os.path.isdir(config.weights):
        raise ValueError(
            f"--weights {config.weights} is a directory (a JAX orbax "
            "checkpoint?); the port reads a *.torch.npz weight file: write "
            "one with python tools/export_torch_weights.py --job-dir <job> "
            "--checkpoint <name>, then pass "
            "<job>/checkpoints/<name>.torch.npz")
    if config.num_devices is None:
        if config.model_parallel > 1:
            raise ValueError("--model_parallel needs --num_devices")
        return
    if config.num_devices < 1 or config.num_devices % config.model_parallel:
        raise ValueError(f"--model_parallel {config.model_parallel} must "
                         f"divide --num_devices {config.num_devices}")


def train(config: TrainConfig, devices=None,
          backend: Optional[str] = None) -> Dict[str, Any]:
    """A full training run; returns the history, the test metrics and the
    checkpoint paths (rank 0's on more than one device; None on the other
    ranks under ``torchrun``).

    ``config.num_devices`` None trains in this process without a process
    group.  ``num_devices`` N joins the group ``torchrun`` describes, or
    else runs N ranks (one in this process, more in spawned processes) in
    a ``(N / model_parallel, model_parallel)`` grid: rank ``r`` on
    ``devices[r]`` if given (several ranks may share one card under
    ``backend='gloo'``), else on the CPU (``config.device='cpu'``,
    ``gloo``) or on ``cuda:r`` (``nccl``)."""
    check_config(config)
    if config.num_devices is None:
        return _train(config)
    return mesh.run_ranks(_train, (config,), config.num_devices,
                          config.model_parallel, config.device, devices,
                          backend)


def _train(config: TrainConfig,
           grid: Optional[mesh.Grid] = None) -> Dict[str, Any]:
    """One rank's run (the only one without a ``grid``)."""
    primary = grid is None or grid.is_primary
    device = torch.device(config.device) if grid is None else grid.device
    os.makedirs(config.job_dir, exist_ok=True)
    if primary:
        with open(os.path.join(config.job_dir, "args.json"), "w") as f:
            json.dump(config.to_json(), f, indent=2)
    log_dir = os.path.join(config.job_dir, "logs")
    log_path = os.path.join(log_dir, "history.jsonl")
    os.makedirs(log_dir, exist_ok=True)
    spec = DatasetSpec(config.dataset_name, config.data_dir, config.batch_size)
    schema = spec.schema
    num_hosts, host_id = (1, 0) if grid is None else (grid.num_hosts,
                                                      grid.host_id)
    if config.batch_size % num_hosts:
        raise ValueError(f"global batch {config.batch_size} must divide "
                         f"over {num_hosts} hosts")
    host_batch = config.batch_size // num_hosts
    train_loader = spec.make_dataset(
        "train", batch_size=host_batch, shuffle=True, repeat=True,
        seed=config.seed, drop_remainder=True, num_hosts=num_hosts,
        host_id=host_id,
    )
    val_loader = spec.make_dataset("val")
    test_loader = spec.make_dataset("test")

    model = init_params(build_model(config, schema), config.seed).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    if primary:
        logger.info("model parameters: %d", n_params)
    if config.weights:
        logger.info("warm starting from %s", config.weights)
        load_weights(config.weights, model)
    task_config = make_task_config(schema, config.masking_method)
    optimizer = KerasAdam(model.parameters(), config.learning_rate)
    generator = torch.Generator(device).manual_seed(config.seed)
    # The validation and test masks come from seeds of their own.
    val_seed, test_seed = config.seed + 2**30, config.seed + 2**30 + 1

    steps_per_epoch = _steps_per_epoch(train_loader, host_batch)
    start_epoch, step, best_score = 1, 0, -math.inf
    if config.resume and os.path.exists(
            checkpoint_path(config.job_dir, "last")):
        step, best_score = load_last(config.job_dir, model, optimizer,
                                     generator)
        start_epoch = 1 + step // steps_per_epoch
        if primary:
            logger.info("resumed at step %d, epoch %d (best val_total_score "
                        "so far: %s)", step, start_epoch, best_score)
    if grid is not None:
        mesh.shard_params(model, grid, optimizer)
    train_step = make_train_step(model, task_config, optimizer, config.l2,
                                 grid=grid)

    rows = None if grid is None else grid.rows(config.batch_size)

    def take_step(batch):
        return train_step(batch, step_draws(model, schema, task_config,
                                            config.batch_size, generator,
                                            rows))

    input_mode = config.input_mode
    if input_mode == "device" and num_hosts > 1:
        logger.warning("input_mode='device' is one host's; a run over %d "
                       "hosts streams its batches (input_mode='host')",
                       num_hosts)
        input_mode = "host"
    if input_mode == "device":
        spread = grid is not None and grid.splits(config.batch_size)
        cache = DeviceDataCache(train_loader, device,
                                grid.data_size if spread else 1,
                                grid.data_rank if spread else 0)
        if cache.num_records < config.batch_size:
            raise ValueError(
                f"train split has {cache.num_records} records < batch size "
                f"{config.batch_size}; no full batch can be formed "
                "(drop_remainder semantics)")
        # A spread cache's columns of this rank are its local indices; a
        # whole one's are its rows of the global batch.
        columns = slice(None) if rows is None else rows

        def run_epoch(epoch):
            block = torch.from_numpy(cache.epoch_indices(
                config.batch_size, config.seed, epoch)[:, columns]).to(device)
            for indices in block:
                metrics = take_step(cache.gather(indices))
            return metrics
    else:
        def run_epoch(epoch):
            for _ in range(steps_per_epoch):
                metrics = take_step(next(host_batches))
            return metrics

    ckpt_every = (config.validation_freq if config.checkpoint_every is None
                  else config.checkpoint_every)
    history = []
    test_metrics: Dict[str, float] = {}
    stop = False
    with contextlib.ExitStack() as stack:
        tb_writer = SummaryWriter(log_dir) if primary else None
        if tb_writer is not None:
            stack.callback(tb_writer.close)
        if input_mode == "host" and start_epoch <= config.num_epochs:
            host_batches = HostBatches(
                train_loader, device,
                rows=None if grid is None else grid.host_rows(host_batch))
            stack.callback(host_batches.close)
        t_start = time.time()
        with trace_context(os.path.join(log_dir, "trace")
                           if config.enable_profile and primary else None):
            for epoch in range(start_epoch, config.num_epochs + 1):
                metrics = run_epoch(epoch)
                if grid is not None:
                    metrics = global_metrics(metrics, grid, config.batch_size,
                                             len(schema.columns))
                step += steps_per_epoch
                loss = float(metrics["loss"])
                if not (math.isfinite(loss) and _all_finite(model, grid)):
                    logger.error("non-finite loss or parameters in epoch %d; "
                                 "terminating without saving (the earlier "
                                 "'last' stays restorable)", epoch)
                    stop = True
                record = {
                    "epoch": epoch,
                    "step": step,
                    "loss": loss,
                    "total_score": float(metrics["total_score"]),
                    "wall_time": time.time() - t_start,
                }
                if not stop and (epoch % config.validation_freq == 0
                                 or epoch == config.num_epochs):
                    val = evaluate_split(model, val_loader, schema,
                                         task_config, val_seed, device,
                                         grid=grid)
                    record.update({f"val_{k}": v for k, v in val.items()})
                    if val["total_score"] > best_score:
                        best_score = val["total_score"]
                        save_checkpoint(config.job_dir, "best", model,
                                        primary=primary)
                        record["checkpointed"] = True
                history.append(record)
                if primary:
                    with open(log_path, "a") as f:
                        f.write(json.dumps(record) + "\n")
                    tb_writer.scalars(step, {k: v for k, v in record.items()
                                             if k not in ("epoch", "step")})
                    logger.info("epoch %d: %s", epoch, record)
                if not stop and ckpt_every and epoch % ckpt_every == 0:
                    save_last(config.job_dir, model, optimizer, step,
                              generator, best_score, primary=primary)
                if stop:
                    break

        if not stop:
            test_metrics = evaluate_split(model, test_loader, schema,
                                          task_config, test_seed, device,
                                          grid=grid)
            if primary:
                logger.info("test: %s", test_metrics)
            save_checkpoint(config.job_dir, "final", model, primary=primary)
            save_last(config.job_dir, model, optimizer, step, generator,
                      best_score, primary=primary)
            if primary:
                tb_writer.scalars(step, {f"test_{k}": v
                                         for k, v in test_metrics.items()})
    return {
        "history": history,
        "test_metrics": test_metrics,
        "best_val_total_score": best_score,
        "stopped_on_nan": stop,
        "checkpoints": {name: checkpoint_path(config.job_dir, name)
                        for name in ("best", "final", "last")},
        "num_params": n_params,
    }
