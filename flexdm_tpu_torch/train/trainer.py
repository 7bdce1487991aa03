"""Training loop (PyTorch): one eager step per batch, epochs on the host.

Counterpart of ``flexdm_tpu/train/trainer.py`` for the oneshot model on one
device.  A step draws its task ids, MLM uniforms, element picks,
replacement values, dropout masks and, where the model needs them, the
shuffle uniforms and the element-wise noise from one ``torch.Generator``
on the device, masks the batch per task, runs the model (attention
through the CUDA kernels on a card), adds the L2 penalty,
back-propagates, clips each gradient to norm 1 and takes a keras-Adam
step.

Protocol as in the JAX trainer: batches from the host ``DataLoader`` with
``drop_remainder``; validation every ``validation_freq`` epochs on the same
randomly masked objective with exact num/den scores; ``best`` by max
``val_total_score``; ``final`` at the end; ``args.json`` and
``logs/history.jsonl`` in the job dir; a stop, with nothing saved, when the
loss or a parameter is not finite at an epoch's end.

Validation draws come per record (:func:`~..models.masking.record_draws`),
so its scores do not change with the batch size or the padding of the last
batch.  Not in this port yet: ``--resume`` and the ``last`` checkpoint,
``--weights``, the device-resident dataset with scanned epochs, profiling,
TensorBoard, more than one device.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..config import TrainConfig, build_model
from ..convert import init_params
from ..data import NUM_VALID_KEY, DatasetSpec, split_device_batch
from ..models import forward_train, make_task_config
from ..models.masking import draw_train, record_draws
from .checkpoint import checkpoint_path, save_checkpoint
from .optim import KerasAdam, clip_by_per_leaf_norm, l2_penalty

logger = logging.getLogger(__name__)

CLIPNORM = 1.0


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (host-only entries dropped)."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in split_device_batch(batch).items()}


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
            range(weights_total, weights_total + b), **model.draw_options(),
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
    device = torch.device(config.device)
    os.makedirs(config.job_dir, exist_ok=True)
    with open(os.path.join(config.job_dir, "args.json"), "w") as f:
        json.dump(config.to_json(), f, indent=2)
    log_path = os.path.join(config.job_dir, "logs", "history.jsonl")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)

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
    task_config = make_task_config(schema, config.masking_method)
    optimizer = KerasAdam(model.parameters(), config.learning_rate)
    train_step = make_train_step(model, task_config, optimizer, config.l2)
    generator = torch.Generator(device).manual_seed(config.seed)
    # The validation and test masks come from seeds of their own.
    val_seed, test_seed = config.seed + 2**30, config.seed + 2**30 + 1

    steps_per_epoch = max(train_loader.num_records // config.batch_size, 1)
    batches = iter(train_loader)
    history = []
    best_score = -math.inf
    stop = False
    step = 0
    t_start = time.time()
    for epoch in range(1, config.num_epochs + 1):
        for _ in range(steps_per_epoch):
            batch = to_device(next(batches), device)
            draws = draw_train(schema, config.batch_size,
                               task_config.task_probs, generator,
                               **model.draw_options())
            draws.dropout = generator
            metrics = train_step(batch, draws)
            step += 1
        loss = float(metrics["loss"])
        if not (math.isfinite(loss) and _all_finite(model)):
            logger.error("non-finite loss or parameters in epoch %d; "
                         "terminating without saving", epoch)
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
            val = evaluate_split(model, val_loader, schema, task_config,
                                 val_seed, device)
            record.update({f"val_{k}": v for k, v in val.items()})
            if val["total_score"] > best_score:
                best_score = val["total_score"]
                save_checkpoint(config.job_dir, "best", model)
                record["checkpointed"] = True
        history.append(record)
        with open(log_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        logger.info("epoch %d: %s", epoch, record)
        if stop:
            break

    test_metrics: Dict[str, float] = {}
    if not stop:
        test_metrics = evaluate_split(model, test_loader, schema, task_config,
                                      test_seed, device)
        logger.info("test: %s", test_metrics)
        save_checkpoint(config.job_dir, "final", model)
    return {
        "history": history,
        "test_metrics": test_metrics,
        "best_val_total_score": best_score,
        "stopped_on_nan": stop,
        "checkpoints": {name: checkpoint_path(config.job_dir, name)
                        for name in ("best", "final")},
        "num_params": n_params,
    }
