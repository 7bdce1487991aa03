"""Masked-field objective and score accounting (PyTorch).

Counterpart of ``compute_mfp_loss`` in ``flexdm_tpu/models/losses.py``.
Per field:

* categorical: softmax cross-entropy; score = top-1 accuracy;
* numerical: MSE scaled by the channel count; score = ``0.5 (1 + cos)``.

Everything is weighted by the per-field mfp mask, the ``loss_condition``
validity gathered from the ground-truth conditioning column, the padding
mask and, where given, a per-sample ``sample_weight`` (which zeroes the
padded tail of an evaluation batch).  Losses sum over positions and
channels and average over the batch; scores are kept as exact
(numerator, denominator) sums.  Categorical columns whose vocabularies pad
to the same size are scored together in one (B, S, G, Vpad) bucket with
``-1e9`` logit padding, which leaves logsumexp, the label logit and the
argmax exact.

``sort_flag`` is the rico position protocol: for the flagged samples both
the ground truth and the (argmaxed) predictions are sorted element-wise
before scoring.  ``predict_context`` also scores the canvas columns that
have a prediction (a ``context='canvas'`` model's canvas heads), one
weight per document (its canvas mask times the ``loss_condition``,
losses.py:261-303); nothing in the trainer, the server or the evaluation
sets it, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..data.schema import Schema
from .masking import get_seq_mask
from .sorting import sort_inputs

Tensors = Dict[str, torch.Tensor]

VOCAB_LEVELS = (8, 16, 32, 64, 128, 256, 512, 1024)


def pad_vocab(v: int) -> int:
    for level in VOCAB_LEVELS:
        if v <= level:
            return level
    return v


def categorical_loss_and_score(labels: torch.Tensor, logits: torch.Tensor):
    """CE and top-1 hit per entry; a label outside the logits picks 0, as
    the JAX one-hot contraction does."""
    lse = torch.logsumexp(logits, dim=-1)
    inside = (labels >= 0) & (labels < logits.shape[-1])
    index = labels.clamp(0, logits.shape[-1] - 1).long()[..., None]
    picked = torch.where(inside, logits.gather(-1, index)[..., 0],
                         torch.zeros_like(lse))
    hit = (logits.argmax(-1) == labels).to(torch.float32)
    return lse - picked, hit


def continuous_loss_and_score(y_true: torch.Tensor, y_pred: torch.Tensor):
    """Per (B, S): MSE over channels and ``0.5 (1 + cos)``."""
    mse = (y_true - y_pred).square().mean(-1)

    def l2norm(x):
        return x * torch.rsqrt(x.square().sum(-1, keepdim=True).clamp_min(1e-12))

    cos = (l2norm(y_true) * l2norm(y_pred)).sum(-1)
    return mse, 0.5 * cos + 0.5


def _apply_sorting(schema: Schema, y_true: Tensors, y_pred: Tensors,
                   sort_flag: torch.Tensor, ignore_sort: Optional[str]):
    """Per sample, the sorted element order where ``sort_flag`` (B,) is
    set.  ``ignore_sort``: ``"gt"`` leaves the ground truth unsorted,
    ``"pred"`` the predictions."""
    if ignore_sort not in ("gt", "pred", None):
        raise ValueError(f"ignore_sort {ignore_sort!r}")
    y_true_sort = y_true if ignore_sort == "gt" else sort_inputs(y_true, schema)
    # The predictions are ordered by the ground-truth lengths; that entry is
    # for the ordering only and never reaches the returned predictions.
    orig_length = y_pred.get("length")
    y_pred = dict(y_pred, length=y_true["length"])
    y_pred_sort = (y_pred if ignore_sort == "pred"
                   else sort_inputs(y_pred, schema, from_logits=True))
    new_true: Tensors = {}
    new_pred: Tensors = {}
    for name in y_true:
        if name not in schema or schema[name].demo_only:
            continue
        column = schema[name]
        if column.is_sequence:
            flag = sort_flag[:, None, None]
            new_true[name] = torch.where(flag, y_true_sort[name], y_true[name])
            pflag = flag[..., None] if column.is_categorical else flag
            new_pred[name] = torch.where(pflag, y_pred_sort[name],
                                         y_pred[name])
        else:
            new_true[name] = y_true[name]
            if name == "length":
                if orig_length is not None:
                    new_pred[name] = orig_length
            elif name in y_pred:
                new_pred[name] = y_pred[name]
    return new_true, new_pred


def compute_mfp_loss(schema: Schema, y_true: Tensors, y_pred: Tensors,
                     masks: Tensors, sort_flag: Optional[torch.Tensor] = None,
                     ignore_sort: Optional[str] = None,
                     sample_weight: Optional[torch.Tensor] = None,
                     predict_context: bool = False,
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and the metrics ``{field}_loss``, ``{field}_score``,
    ``{field}_score_num``, ``{field}_score_den``, ``total_score`` and
    ``loss`` (all 0-dim tensors).  ``sort_flag`` (B,) bool: score those
    samples on sorted elements (see :func:`_apply_sorting`);
    ``predict_context``: score the predicted canvas columns too."""
    if sort_flag is not None:
        y_true, y_pred = _apply_sorting(schema, y_true, y_pred, sort_flag,
                                        ignore_sort)
    seq_mask = get_seq_mask(y_true["length"], schema.max_length)
    S = seq_mask.shape[1]
    seq_w = seq_mask.to(torch.float32)[..., None]  # (B, S, 1)
    modeled = [c for c in schema.columns if c.is_sequence and not c.demo_only]

    def field_weight(column):
        """mfp mask x loss_condition x padding -> (B, S, 1)."""
        w = masks[column.name][..., None].to(torch.float32)
        if column.loss_condition is not None:
            cond = column.loss_condition
            table = torch.tensor(cond.mask, dtype=torch.float32,
                                 device=w.device)
            # Clamped like a jnp gather.
            ids = y_true[cond.key].long().clamp(0, len(cond.mask) - 1)
            w = w * table[ids]
        return w * seq_w

    col_loss: Tensors = {}
    col_score: Tensors = {}
    col_den: Tensors = {}
    loss_vec = torch.zeros(seq_mask.shape[0], dtype=torch.float32,
                           device=seq_mask.device)

    buckets: Dict[int, list] = {}
    for column in modeled:
        if column.is_categorical:
            buckets.setdefault(pad_vocab(column.input_dim), []).append(column)
    for pad_v, cols in sorted(buckets.items()):
        logits, labels, weights = [], [], []
        for c in cols:
            pred = y_pred[c.name][:, :S].to(torch.float32)  # (B, S, C, V)
            logits.append(F.pad(pred, (0, pad_v - pred.shape[-1]),
                                value=-1e9))
            labels.append(y_true[c.name].to(torch.int32))
            weights.append(field_weight(c).expand(labels[-1].shape))
        ce, hit = categorical_loss_and_score(
            torch.cat(labels, 2), torch.cat(logits, 2)
        )
        w_g = torch.cat(weights, 2)  # (B, S, G)
        ce_w = ce * w_g
        loss_vec = loss_vec + ce_w.reshape(ce_w.shape[0], -1).sum(1)
        offset = 0
        for c, lab in zip(cols, labels):
            sl = slice(offset, offset + lab.shape[2])
            col_loss[c.name] = ce_w[:, :, sl]
            col_score[c.name] = hit[:, :, sl] * w_g[:, :, sl]
            col_den[c.name] = w_g[:, :, sl]
            offset += lab.shape[2]

    for column in modeled:
        if column.is_categorical:
            continue
        name = column.name
        mse, score = continuous_loss_and_score(
            y_true[name], y_pred[name][:, :S].to(torch.float32)
        )
        w = field_weight(column)
        col_loss[name] = mse[..., None] * float(column.shape[-1]) * w
        col_score[name] = score[..., None] * w
        col_den[name] = w
        loss_vec = loss_vec + col_loss[name].reshape(mse.shape[0], -1).sum(1)

    canvas_cols = []
    if predict_context:
        canvas_cols = [c for c in schema.columns
                       if not c.is_sequence and not c.demo_only
                       and c.name in y_pred]
    for column in canvas_cols:
        name = column.name
        w = masks[name].to(torch.float32).reshape(-1)  # (B,)
        if column.loss_condition is not None:
            # The condition key is a canvas column too: its channel 0.
            cond = column.loss_condition
            table = torch.tensor(cond.mask, dtype=torch.float32,
                                 device=w.device)
            ids = y_true[cond.key].reshape(w.shape[0], -1)[:, 0].long()
            w = w * table[ids.clamp(0, len(cond.mask) - 1)]
        pred = y_pred[name].to(torch.float32)
        if column.is_categorical:
            ce, hit = categorical_loss_and_score(y_true[name], pred)
            wc = w.reshape((-1,) + (1,) * (ce.dim() - 1)).expand(ce.shape)
            col_loss[name], col_score[name], col_den[name] = \
                wc * ce, wc * hit, wc
        else:
            mse, score = continuous_loss_and_score(y_true[name], pred)
            col_loss[name] = mse * float(column.shape[-1]) * w
            col_score[name], col_den[name] = score * w, w
        loss_vec = loss_vec + col_loss[name].reshape(w.shape[0], -1).sum(1)

    sw = None if sample_weight is None else sample_weight.to(torch.float32)
    if sw is not None:
        loss_vec = loss_vec * sw
    loss = loss_vec.mean()

    def per_sample(x):  # (B, S, C) -> (B,)
        v = x.reshape(x.shape[0], -1).sum(1)
        return v * sw if sw is not None else v

    total = torch.zeros((), dtype=torch.float32, device=loss.device)
    metrics: Dict[str, torch.Tensor] = {}
    for column in modeled + canvas_cols:
        name = column.name
        num = per_sample(col_score[name]).sum()
        den = per_sample(col_den[name]).sum()
        score = torch.where(den == 0.0, torch.ones_like(num), num / den)
        total = total + score
        metrics[f"{name}_loss"] = per_sample(col_loss[name]).mean()
        metrics[f"{name}_score"] = score
        metrics[f"{name}_score_num"] = num
        metrics[f"{name}_score_den"] = den
    # The reference divides by the FULL column count, demo columns included.
    metrics["total_score"] = total / len(schema.columns)
    metrics["loss"] = loss
    return loss, metrics
