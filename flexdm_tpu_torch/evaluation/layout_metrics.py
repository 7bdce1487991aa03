"""Layout-quality metrics: alignment, overlap, gridmap accuracy and mIoU
(PyTorch).

Counterpart of ``flexdm_tpu/evaluation/layout_metrics.py`` (the
reference's ``BeautyLayer`` and ``LayoutMetricLayer``), as tensor
functions on any device:

* :func:`alignment_overlap_scores`: the alignment and overlap num/den sums
  of a batch (lower is better); documents with fewer than two elements
  are left out;
* :func:`compute_gridmaps`: each document painted on a
  ``(top bins, left bins)`` label map, later elements over earlier ones
  (an argmax over the element axis, as in JAX);
* :func:`layout_acc_miou`: per-document pixel accuracy and mean IoU of two
  label maps, from a confusion matrix built by one ``index_put_`` with
  accumulation;
* :func:`layout_metrics`: the mean accuracy and mIoU of the ground truth's
  maps against the prediction's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..data.schema import Schema
from ..models.masking import get_seq_mask

Tensors = Dict[str, torch.Tensor]

GEOMETRY = ("left", "top", "width", "height")


def _geometry(example: Tensors, from_logits: bool) -> Tensors:
    out = {}
    for key in GEOMETRY:
        x = example[key]
        if from_logits and x.dim() == 4:
            x = x.argmax(-1)
        out[key] = x[..., 0].to(torch.int32)  # (B, S)
    return out


def alignment_overlap_scores(example: Tensors, mask: torch.Tensor,
                             schema: Schema,
                             from_logits: bool = True) -> Tensors:
    """Alignment and overlap num/den sums over a batch
    (layout_metrics.py:41-107).  ``mask`` is the (B, S) validity mask."""
    geo = _geometry(example, from_logits)
    s = mask.shape[1]
    count = mask.to(torch.float32).sum(-1)  # (B,)
    valid_doc = count > 1.0
    num_valid = valid_doc.to(torch.float32).sum()
    data = {k: geo[k].to(torch.float32) / float(schema[k].input_dim - 1)
            for k in GEOMETRY}
    eye = torch.eye(s, dtype=torch.bool, device=mask.device)[None]
    pair_valid = mask[:, None, :] & mask[:, :, None]
    invalid = eye | ~pair_valid

    # Alignment: the least distance between any of the left / centre /
    # right (top / middle / bottom) lines of two elements, -log(1 - d).
    diffs = []
    for start_key, interval_key in (("left", "width"), ("top", "height")):
        for i in range(3):
            h = data[start_key] + data[interval_key] * (i / 2.0)  # (B, S)
            d = (h[:, :, None] - h[:, None, :]).abs()
            d = torch.where(invalid, torch.ones_like(d), d).amin(-1)
            diffs.append(-torch.log((1.0 - d).clamp_min(1e-12)))
    diff = torch.stack(diffs, -1).amin(-1)  # (B, S)
    diff = torch.where(torch.isfinite(diff), diff, torch.zeros_like(diff))
    alignment = (diff * mask).sum(-1) / count.clamp_min(1.0)
    alignment = torch.where(valid_doc, alignment, torch.zeros_like(alignment))

    # Overlap: the sum over ordered pairs of intersection / own area.
    right = data["left"] + data["width"]
    bottom = data["top"] + data["height"]
    l1, t1 = data["left"][..., None], data["top"][..., None]
    r1, b1 = right[..., None], bottom[..., None]
    l2, t2 = data["left"][:, None, :], data["top"][:, None, :]
    r2, b2 = right[:, None, :], bottom[:, None, :]
    a1 = (r1 - l1) * (b1 - t1)
    lmax, tmax = torch.maximum(l1, l2), torch.maximum(t1, t2)
    rmin, bmin = torch.minimum(r1, r2), torch.minimum(b1, b2)
    overlap_cond = (lmax < rmin) & (tmax < bmin) & ~eye
    zero = torch.zeros((), device=mask.device)
    ai = torch.where(overlap_cond, (rmin - lmax) * (bmin - tmax), zero)
    ai = torch.where(a1 > 0.0, ai / a1.clamp_min(1e-12), zero)
    ai = torch.where(pair_valid, ai, zero)
    overlap = ai.sum((-2, -1)) / count.clamp_min(1.0)
    overlap = torch.where(valid_doc, overlap, zero)
    return {
        "alignment_num": alignment.sum(),
        "alignment_den": num_valid,
        "overlap_num": overlap.sum(),
        "overlap_den": num_valid,
    }


def _primary_label_name(schema: Schema) -> str:
    for c in schema.columns:
        if c.primary_label is not None:
            return c.name
    raise ValueError("schema has no primary_label column")


def compute_gridmaps(example: Tensors, mask: torch.Tensor, schema: Schema,
                     from_logits: bool,
                     label_name: Optional[str] = None) -> torch.Tensor:
    """``(B, top bins, left bins)`` label maps (layout_metrics.py:110-155):
    each valid, non-empty box painted with its label over
    ``[top, min(top + height, Y - 1)] x [left, min(left + width, X - 1)]``,
    later elements over earlier ones; the rest is the primary label's
    default (or 0)."""
    label_name = label_name or _primary_label_name(schema)
    xsize = schema["left"].input_dim
    ysize = schema["top"].input_dim
    default = schema[label_name].primary_label or 0
    geo = _geometry(example, from_logits)
    labels = example[label_name]
    if from_logits and labels.dim() == 4:
        labels = labels.argmax(-1)
    labels = labels[..., 0].to(torch.int32)  # (B, S)

    left, top = geo["left"], geo["top"]
    right = torch.clamp(left + geo["width"], max=xsize - 1)
    bottom = torch.clamp(top + geo["height"], max=ysize - 1)
    nonempty = (top < bottom) & (left < right) & mask  # (B, S)
    device = mask.device
    ys = torch.arange(ysize, device=device)[None, None, :, None]
    xs = torch.arange(xsize, device=device)[None, None, None, :]

    def edge(t):
        return t[:, :, None, None]

    cover = ((ys >= edge(top)) & (ys <= edge(bottom))
             & (xs >= edge(left)) & (xs <= edge(right))
             & edge(nonempty))  # (B, S, Y, X)
    s = mask.shape[1]
    order = torch.arange(1, s + 1, device=device)[None, :, None, None]
    # The last covering element: the largest order (ties cannot happen).
    last = torch.where(cover, order, torch.zeros_like(order)).argmax(1)
    covered = cover.any(1)
    painted = labels.gather(1, last.reshape(last.shape[0], -1)).reshape(
        last.shape)
    return torch.where(covered, painted, torch.full_like(painted, default))


def layout_acc_miou(map_true: torch.Tensor, map_pred: torch.Tensor,
                    label_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-document pixel accuracy and the mean IoU over the labels
    present in either map (layout_metrics.py:158-181)."""
    b = map_true.shape[0]
    n = map_true[0].numel()
    b_idx = torch.arange(b, device=map_true.device).repeat_interleave(n)
    confusion = torch.zeros((b, label_size, label_size), dtype=torch.float32,
                            device=map_true.device)
    confusion.index_put_(
        (b_idx, map_pred.reshape(-1).long(), map_true.reshape(-1).long()),
        torch.ones((), device=map_true.device).expand(b * n),
        accumulate=True)
    inter = confusion.diagonal(dim1=1, dim2=2)  # (B, L)
    union = confusion.sum(1) + confusion.sum(2) - inter
    acc = inter.sum(1) / confusion.sum((1, 2))
    weight = (union > 0).to(torch.float32)
    iou = inter / (union + 1e-9)
    miou = (weight * iou).sum(1) / weight.sum(1).clamp_min(1.0)
    return acc, miou


def layout_metrics(y_true: Tensors, y_pred: Tensors, schema: Schema,
                   from_logits: bool = True,
                   use_true_length: bool = False) -> Tensors:
    """``layout_acc`` and ``layout_miou``: the means over the batch of
    :func:`layout_acc_miou` of the ground truth's maps against the
    prediction's (layout_metrics.py:191-215).  The prediction's mask is
    the ground truth's with ``use_true_length`` or without a predicted
    ``length``, else that of its (argmaxed) length."""
    label_name = _primary_label_name(schema)
    s = schema.max_length
    mask_true = get_seq_mask(y_true["length"], s)
    if use_true_length or "length" not in y_pred:
        mask_pred = mask_true
    else:
        mask_pred = get_seq_mask(
            y_pred["length"], s,
            from_logits=from_logits and y_pred["length"].dim() > 2)
    map_true = compute_gridmaps(y_true, mask_true, schema, False, label_name)
    map_pred = compute_gridmaps(y_pred, mask_pred, schema, from_logits,
                                label_name)
    acc, miou = layout_acc_miou(map_true, map_pred,
                                schema[label_name].input_dim)
    return {"layout_acc": acc.mean(), "layout_miou": miou.mean()}
