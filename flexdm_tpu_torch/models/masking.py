"""Test-path masking: the task layer the serving path runs.

Counterpart of the test-path half of ``flexdm_tpu/models/masking.py``:
sequence masks, ``[MASK]``/``[NULL]`` token writes, padding filtering,
element selection, ``preprocess_for_test`` and the ground-truth merge.
The conventions are the JAX package's (and the reference's): categorical
``[MASK]``/``[NULL]`` ids are ``input_dim``/``input_dim + 1``, numerical
sentinels are the all-channel ``MASK_VALUE``/``NULL_VALUE``.

The one random draw (``select_single_element``) takes its uniforms as an
argument, so a caller decides the generator and a test can hand both
packages the same numbers.  The training-path maskings (MLM corruption,
per-sample task mux) are not in this port yet.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from flexdm_tpu.data.schema import MASK_VALUE, NULL_VALUE, ColumnSpec, Schema

Tensors = Dict[str, torch.Tensor]


def get_seq_mask(length: torch.Tensor, max_length: int,
                 from_logits: bool = False) -> torch.Tensor:
    """(B,) or (B, 1) zero-based length -> (B, S) validity mask."""
    if from_logits:
        length = length.argmax(-1)
    length = length.reshape(-1) + 1
    positions = torch.arange(max_length, device=length.device)
    return positions[None, :] < length[:, None]


def one_hot(ids: torch.Tensor, num_classes: int,
            dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: ids outside ``[0, num_classes)`` give a zero row
    (no device-side bounds assertion)."""
    classes = torch.arange(num_classes, device=ids.device)
    return (ids[..., None] == classes).to(dtype)


def apply_token(x: torch.Tensor, column: ColumnSpec, mask: torch.Tensor,
                token_type: str) -> torch.Tensor:
    """Write the [MASK] or [NULL] token where ``mask`` (B, S) is True;
    ``x`` is (B, S, C)."""
    if token_type == "masked":
        token = column.mask_token_id if column.is_categorical else MASK_VALUE
    elif token_type == "unused":
        token = column.null_token_id if column.is_categorical else NULL_VALUE
    else:
        raise ValueError(f"token_type {token_type!r} not in this port")
    return x.masked_fill(mask[..., None], token)


@functools.lru_cache(maxsize=None)
def _bool_table(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.bool, device=device)


def filter_padding(inputs: Tensors, schema: Schema,
                   seq_mask: torch.Tensor) -> Tensors:
    """[NULL] on padded slots and on slots the column's ``loss_condition``
    rules out (e.g. a text element's image embedding)."""
    out: Tensors = {}
    unused = ~seq_mask
    for column in schema.modeled:
        x = inputs[column.name]
        if not column.is_sequence:
            out[column.name] = x
            continue
        invalid = unused
        if column.loss_condition is not None:
            cond = column.loss_condition
            table = _bool_table(cond.mask, x.device)
            # Clamped like a jnp gather, so a [MASK]/[NULL] id reads the
            # last entry instead of faulting.
            ids = inputs[cond.key][..., 0].long().clamp(0, len(cond.mask) - 1)
            invalid = ~table[ids] | unused
        out[column.name] = apply_token(x, column, invalid, "unused")
    return out


def get_initial_masks(schema: Schema, seq_mask: torch.Tensor) -> Tensors:
    """All-False element masks; all-True canvas masks."""
    b = seq_mask.shape[0]
    return {
        c.name: torch.zeros_like(seq_mask) if c.is_sequence
        else torch.ones(b, dtype=torch.bool, device=seq_mask.device)
        for c in schema.modeled
    }


def select_single_element(seq_mask: torch.Tensor,
                          u: Optional[torch.Tensor] = None,
                          select_last: bool = False) -> torch.Tensor:
    """One-hot (B, S) mask of one valid element per sample: element
    ``floor(u * length)`` for the uniforms ``u`` (B,), or the last one."""
    length = seq_mask.to(torch.float32).sum(1)
    if select_last:
        index = (length - 1.0).to(torch.int32)
    else:
        if u is None:
            raise ValueError("select_single_element needs the uniforms u")
        index = (u.to(seq_mask.device) * length).to(torch.int32)
    return one_hot(index, seq_mask.shape[1], torch.bool) & (length > 0)[:, None]


def preprocess_for_test(inputs: Tensors, schema: Schema, masks: Tensors,
                        tasks: Optional[torch.Tensor] = None) -> Tensors:
    """Apply externally supplied masks; adds the ``task`` column."""
    seq_mask = get_seq_mask(inputs["length"], schema.max_length)
    filtered = filter_padding(inputs, schema, seq_mask)
    modified: Tensors = {}
    for column in schema.modeled:
        x = filtered[column.name]
        modified[column.name] = (
            apply_token(x, column, masks[column.name], "masked")
            if column.is_sequence else x
        )
    if tasks is None:
        tasks = torch.zeros(
            inputs["length"].shape[0], dtype=torch.int32, device=seq_mask.device
        )
    modified["task"] = tasks[:, None]
    return modified


def merge_inputs_and_prediction(inputs: Tensors, schema: Schema,
                                masks: Tensors, prediction: Tensors) -> Tensors:
    """Ground truth wherever a field was NOT masked (categorical ground
    truth as one-hot, to match the logits)."""
    out = dict(prediction)
    for column in schema.columns:
        name = column.name
        if column.demo_only:
            if name in inputs:
                out[name] = inputs[name]
        elif not column.is_sequence:
            out[name] = inputs[name]
        elif name not in masks:
            continue
        elif column.is_categorical:
            gt = one_hot(inputs[name], column.input_dim, prediction[name].dtype)
            out[name] = torch.where(
                masks[name][:, :, None, None], prediction[name], gt
            )
        else:
            out[name] = torch.where(
                masks[name][..., None], prediction[name], inputs[name]
            )
    return out
