"""Load a trained job and build task masks.

Counterpart of ``load_model`` and ``build_task_masks`` in
``flexdm_tpu/demo.py``; the SVG/HTML demo renderer is not in this port
yet.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from .config import TrainConfig, build_model
from .convert import load_weights
from .data import DatasetSpec
from .evaluation.harness import _group_masks
from .models.masking import (
    get_initial_masks,
    get_seq_mask,
    one_hot,
    select_single_element,
)


def load_model(job_dir: str, checkpoint: str = "best", batch_size: int = 8,
               device="cuda"):
    """Rebuild a job's model from ``args.json`` and its port weights file;
    returns ``(model, spec)`` with the model on ``device`` in eval mode."""
    with open(os.path.join(job_dir, "args.json")) as f:
        config = TrainConfig.from_args(json.load(f))
    spec = DatasetSpec(config.dataset_name, config.data_dir, batch_size)
    model = build_model(config, spec.schema)
    load_weights(
        os.path.join(job_dir, "checkpoints", f"{checkpoint}.torch.npz"), model
    )
    return model.to(device).eval(), spec


def build_task_masks(schema, batch, task: str,
                     generator: Optional[torch.Generator] = None,
                     element: Optional[torch.Tensor] = None):
    """Masks for a task: ``elem`` masks one element per document, a group
    task masks its fields across all elements.

    ``element`` (elem only): a (B,) int tensor of element indices to mask
    instead of a random draw, intersected with the valid elements.  The
    random draw takes its uniforms from ``generator`` (a CPU generator;
    seed 0 when None).
    """
    seq_mask = get_seq_mask(batch["length"], schema.max_length)
    if task != "elem":
        return _group_masks(schema, batch, schema.attribute_groups[task])
    masks = get_initial_masks(schema, seq_mask)
    if element is not None:
        selected = one_hot(element, schema.max_length, torch.bool) & seq_mask
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        u = torch.rand(seq_mask.shape[0], generator=generator)
        selected = select_single_element(seq_mask, u)
    for c in schema.modeled:
        if c.is_sequence:
            masks[c.name] = selected
    return masks
