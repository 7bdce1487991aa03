"""The task layer: test-path and train-path masking.

Counterpart of ``flexdm_tpu/models/masking.py``: sequence masks,
``[MASK]``/``[NULL]``/random token writes, padding filtering, element
selection, ``preprocess_for_test`` and the ground-truth merge (the serving
path), and the MLM corruption ``random_masking``, ``sample_tasks`` and the
per-sample task mux ``preprocess_for_train`` (the training path).  The
conventions are the JAX package's (and the reference's): categorical
``[MASK]``/``[NULL]`` ids are ``input_dim``/``input_dim + 1``, numerical
sentinels are the all-channel ``MASK_VALUE``/``NULL_VALUE``; of the 15% of
fields selected for MLM, 80% are masked, 10% replaced by a random token
and 10% left unchanged.

Every random draw is an argument (task ids, the fused ``(B, 3, n_seq, S)``
uniforms, the element-pick uniforms, the replacement values, and where the
model needs them the shuffle uniforms and the element-wise noise), so a
caller decides the generator and a test can hand both packages the same
numbers.  :func:`draw_train` draws them all from one ``torch.Generator``.
The autoregressive baselines' last-element pick is not in this port yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.schema import MASK_VALUE, NULL_VALUE, ColumnSpec, Schema

Tensors = Dict[str, torch.Tensor]

MASK_PROB = 0.15
NOISE_SIZE = 4  # channels of the element-wise noise (encoder.py:51)
REPLACE_PROB = 0.1
UNCHANGE_PROB = 0.1


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
                token_type: str,
                values: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write the [MASK], [NULL] or random token where ``mask`` (B, S) is
    True; ``x`` is (B, S, C).  ``"random"`` takes its tokens from
    ``values`` (shaped and typed like ``x``: ids in ``[0, input_dim)`` for
    a categorical column, ``0.1 * N(0, 1)`` for a numerical one)."""
    if token_type == "masked":
        token = column.mask_token_id if column.is_categorical else MASK_VALUE
    elif token_type == "unused":
        token = column.null_token_id if column.is_categorical else NULL_VALUE
    elif token_type == "random":
        if values is None:
            raise ValueError("token_type 'random' needs the values")
        return torch.where(mask[..., None], values, x)
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


def _sequence_columns(schema: Schema):
    return [c for c in schema.modeled if c.is_sequence]


def random_masking(inputs: Tensors, schema: Schema, seq_mask: torch.Tensor,
                   uniforms: torch.Tensor, values: Tensors,
                   mask_prob: float = MASK_PROB,
                   replace_prob: float = REPLACE_PROB,
                   unchange_prob: float = UNCHANGE_PROB):
    """MLM-style per-(element, field) masking; returns ``(inputs, masks)``.

    ``uniforms`` is the fused ``(B, 3, n_seq, S)`` draw (select / change /
    replace-vs-mask per sequence column), ``values`` the replacement tokens
    per sequence column."""
    change_prob = 1.0 - unchange_prob
    thresh = replace_prob / change_prob if change_prob > 0 else 0.0
    out: Tensors = {}
    masks: Tensors = {}
    si = 0
    for column in schema.modeled:
        x = inputs[column.name]
        if not column.is_sequence:
            out[column.name] = x
            masks[column.name] = torch.ones(
                x.shape[0], dtype=torch.bool, device=x.device
            )
            continue
        mfp_mask = seq_mask & (uniforms[:, 0, si] < mask_prob)
        chg = mfp_mask & (uniforms[:, 1, si] < change_prob)
        rand = uniforms[:, 2, si]
        y = apply_token(x, column, chg & (rand >= thresh), "masked")
        y = apply_token(y, column, chg & (rand < thresh), "random",
                        values[column.name])
        out[column.name] = y
        masks[column.name] = mfp_mask
        si += 1
    return out, masks


def sample_tasks(gumbel: torch.Tensor, probs: Sequence[float]) -> torch.Tensor:
    """Per-sample categorical task draw from the Gumbel noise ``gumbel``
    (B, #tasks): ``argmax(log(probs + 1e-30) + gumbel)``, which is what
    ``jax.random.categorical`` computes from its own Gumbel draw."""
    logits = torch.log(
        torch.tensor(probs, dtype=torch.float32, device=gumbel.device) + 1e-30
    )
    return torch.argmax(gumbel + logits, dim=-1).to(torch.int32)


def train_draw_shape(schema: Schema, batch_size: int) -> Tuple[int, ...]:
    """Shape of the fused per-step uniform draw :func:`preprocess_for_train`
    consumes: (B, 3, #sequence columns, S)."""
    return (batch_size, 3, len(_sequence_columns(schema)), schema.max_length)


@dataclasses.dataclass
class TrainDraws:
    """Every random number one training forward consumes.

    ``tasks`` (B,) int32 task ids; ``uniforms`` the fused (B, 3, n_seq, S)
    MLM draw; ``element`` (B,) uniforms of the elem task's pick; ``values``
    the random-replacement tokens per sequence column (like the column's
    input); ``dropout`` the generator the dropout masks come from (None:
    no dropout); ``shuffle`` the (B, S) uniforms that order the elements
    of an ``input_dtype='shuffled_set'`` model; ``noise`` the (B, S', 4)
    standard normals of a ``use_elemwise_noise`` encoder."""

    tasks: torch.Tensor
    uniforms: torch.Tensor
    element: torch.Tensor
    values: Tensors
    dropout: Optional[torch.Generator] = None
    shuffle: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None

    def to(self, device) -> "TrainDraws":
        def move(x):
            return None if x is None else x.to(device)

        return TrainDraws(
            self.tasks.to(device), self.uniforms.to(device),
            self.element.to(device),
            {k: v.to(device) for k, v in self.values.items()}, self.dropout,
            move(self.shuffle), move(self.noise),
        )


def draw_train(schema: Schema, batch_size: int, task_probs: Sequence[float],
               generator: torch.Generator, shuffle: bool = False,
               noise_length: Optional[int] = None) -> TrainDraws:
    """All the draws of :class:`TrainDraws` (but ``dropout``) from one
    generator, on the generator's device.  ``shuffle`` and
    ``noise_length`` (S') ask for the draws only some models need; they
    come after the others, so the others do not depend on them."""
    device = generator.device
    shape = (batch_size, schema.max_length)

    def uniform(*dims):
        return torch.rand(dims, generator=generator, device=device)

    # Gumbel noise as jax.random.gumbel makes it: -log(-log(u)), u > 0.
    tiny = torch.finfo(torch.float32).tiny
    u = uniform(batch_size, len(task_probs)).clamp_min_(tiny)
    tasks = sample_tasks(-torch.log(-torch.log(u)), task_probs)
    uniforms = uniform(*train_draw_shape(schema, batch_size))
    element = uniform(batch_size)
    values: Tensors = {}
    for column in _sequence_columns(schema):
        dims = shape + tuple(column.shape)
        if column.is_categorical:
            values[column.name] = torch.randint(
                0, column.input_dim, dims, generator=generator,
                device=device, dtype=torch.int32,
            )
        else:
            values[column.name] = 0.1 * torch.randn(
                dims, generator=generator, device=device
            )
    draws = TrainDraws(tasks, uniforms, element, values)
    if shuffle:
        draws.shuffle = uniform(*shape)
    if noise_length is not None:
        draws.noise = torch.randn((batch_size, noise_length, NOISE_SIZE),
                                  generator=generator, device=device)
    return draws


def record_generator(seed: int, record: int) -> torch.Generator:
    """A CPU generator seeded by ``(seed, record)`` alone."""
    mixed = np.random.SeedSequence([seed, int(record)]).generate_state(2)
    return torch.Generator().manual_seed(int(mixed[0]) << 32 | int(mixed[1]))


def record_draws(schema: Schema, task_probs: Sequence[float], seed: int,
                 records: Sequence[int], **options) -> TrainDraws:
    """Draws for a batch whose rows are the records ``records``: row ``i``
    comes from :func:`record_generator` of ``(seed, records[i])``, so a
    record's masks do not depend on the batch it lands in (validation
    scores do not change with the batch size or its padding).  ``options``
    go to :func:`draw_train`."""
    rows = []
    for record in records:
        rows.append(draw_train(schema, 1, task_probs,
                               record_generator(seed, record), **options))

    def cat(name):
        if getattr(rows[0], name) is None:
            return None
        return torch.cat([getattr(r, name) for r in rows])

    return TrainDraws(
        cat("tasks"), cat("uniforms"), cat("element"),
        {k: torch.cat([r.values[k] for r in rows]) for k in rows[0].values},
        shuffle=cat("shuffle"), noise=cat("noise"),
    )


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


def preprocess_for_train(inputs: Tensors, schema: Schema,
                         tasks: torch.Tensor, uniforms: torch.Tensor,
                         element: torch.Tensor, values: Tensors):
    """Per-sample task masking; returns ``(targets, modified_inputs,
    masks)``, and ``modified_inputs`` gains a ``"task"`` entry.

    Task 0 (random) is the MLM corruption from ``uniforms`` and
    ``values``; task 1 (elem) masks every field of the element picked by
    ``element``; task ``g + 2`` masks attribute group ``g`` across all
    elements.  Only the (B, S) bool masks are muxed per sample; each
    column's data is rewritten twice ([MASK] slots, then random slots).
    (The autoregressive baselines' last-element elem pick is not in this
    port yet.)"""
    seq_mask = get_seq_mask(inputs["length"], schema.max_length)
    filtered = filter_padding(inputs, schema, seq_mask)
    elem_sel = select_single_element(seq_mask, element)

    groups = list(schema.attribute_groups.values())
    is_random = (tasks == 0)[:, None]  # (B, 1)
    is_elem = (tasks == 1)[:, None]
    thresh = REPLACE_PROB / (1.0 - UNCHANGE_PROB)
    no_mask = torch.zeros_like(seq_mask)

    modified: Tensors = {}
    masks: Tensors = {}
    si = 0
    for column in schema.modeled:
        name = column.name
        if not column.is_sequence:
            modified[name] = filtered[name]
            masks[name] = torch.ones(
                seq_mask.shape[0], dtype=torch.bool, device=seq_mask.device
            )
            continue
        variant = torch.where(is_elem, elem_sel, no_mask)
        for g, group in enumerate(groups):
            if name in group:
                variant = torch.where((tasks == g + 2)[:, None], seq_mask,
                                      variant)
        mlm = seq_mask & (uniforms[:, 0, si] < MASK_PROB)
        chg = mlm & (uniforms[:, 1, si] < 1.0 - UNCHANGE_PROB)
        rand = uniforms[:, 2, si]
        mask_tok = torch.where(is_random, chg & (rand >= thresh), variant)
        rand_tok = is_random & chg & (rand < thresh)
        y = apply_token(filtered[name], column, mask_tok, "masked")
        y = apply_token(y, column, rand_tok, "random", values[name])
        modified[name] = y
        masks[name] = torch.where(is_random, mlm, variant)
        si += 1
    modified["task"] = tasks[:, None]
    return inputs, modified, masks


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
