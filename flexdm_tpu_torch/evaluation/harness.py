"""Task masks from the evaluation harness.

Counterpart of ``_group_masks`` and ``task_id_for_mode`` in
``flexdm_tpu/evaluation/harness.py``; the scoring harness itself is not in
this port yet.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..data.schema import Schema
from ..models.masking import get_initial_masks, get_seq_mask


def _group_masks(schema: Schema, batch, group_keys) -> Dict[str, torch.Tensor]:
    """Mask every valid element of the columns in ``group_keys``."""
    seq_mask = get_seq_mask(batch["length"], schema.max_length)
    masks = get_initial_masks(schema, seq_mask)
    for key in group_keys:
        masks[key] = seq_mask
    return masks


def task_id_for_mode(schema: Schema, task_mode: str) -> int:
    """Task-conditioning id of a task mode (``schema.task_names`` order)."""
    return schema.task_names.index(task_mode)
