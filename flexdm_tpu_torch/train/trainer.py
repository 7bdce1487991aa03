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
batch.  Not in this port yet: more than one device.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import math
import os
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..config import TrainConfig, build_model
from ..convert import init_params, load_weights
from ..data import NUM_VALID_KEY, DatasetSpec, split_device_batch
from ..data.pipeline import DeviceDataCache, Prefetcher
from ..models import forward_train, make_task_config
from ..models.masking import draw_train, record_draws
from ..models.mfp import draw_options
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


class HostBatches:
    """The host mode's device batches: the loader in a
    :class:`Prefetcher` thread, copied to ``device`` there (through
    :class:`PinnedCopy` on a card); ``close()`` stops the thread."""

    def __init__(self, loader, device):
        device = torch.device(device)
        if device.type == "cuda":
            copy = PinnedCopy(device)
            transform, self._take = copy, copy.take
        else:
            transform = functools.partial(to_device, device=device)
            self._take = lambda batch: batch
        self._prefetcher = Prefetcher(loader, depth=2, transform=transform)
        self._items = iter(self._prefetcher)

    def __next__(self) -> Dict[str, torch.Tensor]:
        return self._take(next(self._items))

    def close(self) -> None:
        self._prefetcher.close()


def make_train_step(model, task_config, optimizer: KerasAdam,
                    l2) -> Callable:
    """``step(batch, draws) -> metrics``: forward, L2, backward, per-tensor
    clip, keras Adam.  A parameter the loss does not reach (the canvas
    heads of a ``context='canvas'`` model under ``l2=0``) gets a zero
    gradient, as ``jax.grad`` gives it, so keras Adam leaves it as it is;
    the first step logs the names of such parameters."""
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
        clip_by_per_leaf_norm(grads, CLIPNORM)
        optimizer.step(grads)
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


@torch.no_grad()
def evaluate_split(model, loader, schema, task_config, seed: int,
                   device) -> Dict[str, float]:
    """The randomly masked objective over a split, with dataset-level
    num/den scores.  Padded batch tails are zeroed through
    ``sample_weight``; record ``i`` of the split is masked by the draws of
    ``(seed, i)`` whatever batch it is in."""
    sums: Dict[str, float] = {}
    losses: Dict[str, float] = {}
    weights_total = 0
    for host_batch in loader:
        b = host_batch["length"].shape[0]
        num_valid = host_batch.get(NUM_VALID_KEY, b)
        batch = to_device(host_batch, device)
        # Padded rows take the next indices; their weight is 0.
        draws = record_draws(
            schema, task_config.task_probs, seed,
            range(weights_total, weights_total + b), **draw_options(model),
        ).to(device)
        sample_weight = torch.zeros(b, device=device)
        sample_weight[:num_valid] = 1.0
        _, metrics = forward_train(model, batch, draws, task_config,
                                   train=False, sample_weight=sample_weight)
        names = sorted(metrics)
        values = torch.stack([metrics[k] for k in names]).tolist()
        for k, v in zip(names, values):
            if k.endswith("_score_num") or k.endswith("_score_den"):
                sums[k] = sums.get(k, 0.0) + v
            elif k.endswith("_loss") or k == "loss":
                # The loss is a mean over the static batch with padded rows
                # zeroed: recover the sum, renormalise by real samples.
                losses[k] = losses.get(k, 0.0) + v * b
        weights_total += num_valid

    out: Dict[str, float] = {}
    score_total = 0.0
    for k in list(sums):
        if k.endswith("_score_num"):
            field = k[: -len("_score_num")]
            den = sums[f"{field}_score_den"]
            score = 1.0 if den == 0 else sums[k] / den
            out[f"{field}_score"] = score
            score_total += score
    out["total_score"] = score_total / len(schema.columns)
    for k, v in losses.items():
        out[k] = v / max(weights_total, 1)
    return out


def _all_finite(model) -> bool:
    return bool(torch.stack([p.isfinite().all() for p in model.parameters()])
                .all())


def train(config: TrainConfig) -> Dict[str, Any]:
    """A full training run; returns the history, the test metrics and the
    checkpoint paths."""
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
    device = torch.device(config.device)
    os.makedirs(config.job_dir, exist_ok=True)
    with open(os.path.join(config.job_dir, "args.json"), "w") as f:
        json.dump(config.to_json(), f, indent=2)
    log_dir = os.path.join(config.job_dir, "logs")
    log_path = os.path.join(log_dir, "history.jsonl")
    os.makedirs(log_dir, exist_ok=True)

    spec = DatasetSpec(config.dataset_name, config.data_dir, config.batch_size)
    schema = spec.schema
    train_loader = spec.make_dataset(
        "train", batch_size=config.batch_size, shuffle=True, repeat=True,
        seed=config.seed, drop_remainder=True,
    )
    val_loader = spec.make_dataset("val")
    test_loader = spec.make_dataset("test")

    model = init_params(build_model(config, schema), config.seed).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("model parameters: %d", n_params)
    if config.weights:
        logger.info("warm starting from %s", config.weights)
        load_weights(config.weights, model)
    task_config = make_task_config(schema, config.masking_method)
    optimizer = KerasAdam(model.parameters(), config.learning_rate)
    train_step = make_train_step(model, task_config, optimizer, config.l2)
    generator = torch.Generator(device).manual_seed(config.seed)
    # The validation and test masks come from seeds of their own.
    val_seed, test_seed = config.seed + 2**30, config.seed + 2**30 + 1

    steps_per_epoch = max(train_loader.num_records // config.batch_size, 1)
    start_epoch, step, best_score = 1, 0, -math.inf
    if config.resume and os.path.exists(
            checkpoint_path(config.job_dir, "last")):
        step, best_score = load_last(config.job_dir, model, optimizer,
                                     generator)
        start_epoch = 1 + step // steps_per_epoch
        logger.info("resumed at step %d, epoch %d (best val_total_score "
                    "so far: %s)", step, start_epoch, best_score)

    def take_step(batch):
        draws = draw_train(schema, config.batch_size, task_config.task_probs,
                           generator, **draw_options(model))
        draws.dropout = draws.vae = generator
        return train_step(batch, draws)

    if config.input_mode == "device":
        cache = DeviceDataCache(train_loader, device)
        if cache.num_records < config.batch_size:
            raise ValueError(
                f"train split has {cache.num_records} records < batch size "
                f"{config.batch_size}; no full batch can be formed "
                "(drop_remainder semantics)")

        def run_epoch(epoch):
            block = torch.from_numpy(cache.epoch_indices(
                config.batch_size, config.seed, epoch)).to(device)
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
        tb_writer = SummaryWriter(log_dir)
        stack.callback(tb_writer.close)
        if config.input_mode == "host" and start_epoch <= config.num_epochs:
            host_batches = HostBatches(train_loader, device)
            stack.callback(host_batches.close)
        t_start = time.time()
        with trace_context(os.path.join(log_dir, "trace")
                           if config.enable_profile else None):
            for epoch in range(start_epoch, config.num_epochs + 1):
                metrics = run_epoch(epoch)
                step += steps_per_epoch
                loss = float(metrics["loss"])
                if not (math.isfinite(loss) and _all_finite(model)):
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
                                         task_config, val_seed, device)
                    record.update({f"val_{k}": v for k, v in val.items()})
                    if val["total_score"] > best_score:
                        best_score = val["total_score"]
                        save_checkpoint(config.job_dir, "best", model)
                        record["checkpointed"] = True
                history.append(record)
                with open(log_path, "a") as f:
                    f.write(json.dumps(record) + "\n")
                tb_writer.scalars(step, {k: v for k, v in record.items()
                                         if k not in ("epoch", "step")})
                logger.info("epoch %d: %s", epoch, record)
                if not stop and ckpt_every and epoch % ckpt_every == 0:
                    save_last(config.job_dir, model, optimizer, step,
                              generator, best_score)
                if stop:
                    break

        if not stop:
            test_metrics = evaluate_split(model, test_loader, schema,
                                          task_config, test_seed, device)
            logger.info("test: %s", test_metrics)
            save_checkpoint(config.job_dir, "final", model)
            save_last(config.job_dir, model, optimizer, step, generator,
                      best_score)
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
