"""Element-set reordering: sorting and shuffling the elements of a batch.

Counterpart of ``gather_elements``, ``sort_inputs`` and ``shuffle_inputs``
in ``flexdm_tpu/models/sorting.py``.

* :func:`sort_inputs` orders elements by (valid, type, left, top, width,
  height), padding last.  ``jnp.lexsort`` is stable and PyTorch has no
  lexsort, so the order is built from stable ``argsort`` passes, the least
  significant key (height) first: tied elements keep their input order, as
  in JAX.
* :func:`shuffle_inputs` permutes the valid elements of each sample and
  leaves the padding in place.  Its ``(B, S)`` uniforms are an argument,
  so a caller decides the generator.

:func:`reorganize_indices` moves one element of each row to a given
position (the autoregressive ``elem`` evaluation puts the queried element
last); :func:`merge_dicts` and :func:`split_dict` concatenate and split
dicts of tensors (sorting.py:107-148).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..data.schema import Schema
from .masking import get_seq_mask

Tensors = Dict[str, torch.Tensor]

# Lexicographic priority of the sort (most significant first).
SORT_KEYS = ("type", "left", "top", "width", "height")


def gather_elements(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Reorder axis 1 of ``x`` (B, S, ...) by per-row ``indices`` (B, S)."""
    idx = indices.reshape(indices.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand((-1, -1) + x.shape[2:]))


def lexsort(keys) -> torch.Tensor:
    """Per-row ``jnp.lexsort(keys, axis=-1)``: the LAST key is the primary
    one; ties keep their input order."""
    b, s = keys[0].shape
    order = torch.arange(s, device=keys[0].device).expand(b, s)
    for key in keys:
        step = torch.argsort(key.gather(1, order), dim=-1, stable=True)
        order = order.gather(1, step)
    return order


def sort_inputs(inputs: Tensors, schema: Schema,
                from_logits: bool = False) -> Tensors:
    """Sort each sample's elements by (valid, type, left, top, width,
    height).  ``from_logits``: a categorical key given as (B, S, C, V)
    logits is argmaxed first.  Needs ``inputs["length"]``; entries that are
    not sequence columns of ``schema`` pass through."""
    keys = {}
    for name in SORT_KEYS:
        x = inputs[name]
        if from_logits and schema[name].is_categorical and x.dim() == 4:
            x = x.argmax(-1)
        keys[name] = x[..., 0].to(torch.int32)
    invalid = (~get_seq_mask(inputs["length"], schema.max_length)).to(
        torch.int32)
    indices = lexsort([keys["height"], keys["width"], keys["top"],
                       keys["left"], keys["type"], invalid])
    return {
        name: gather_elements(x, indices)
        if name in schema and schema[name].is_sequence and x.dim() >= 2
        else x
        for name, x in inputs.items()
    }


def shuffle_inputs(inputs: Tensors, schema: Schema,
                   uniforms: torch.Tensor) -> Tensors:
    """Permute the valid elements of each sample by the order of
    ``uniforms`` (B, S) on them; padded slots keep their place.  Every
    (B, S, ...) entry that is not a canvas column is reordered."""
    seq_mask = get_seq_mask(inputs["length"], schema.max_length)
    s = seq_mask.shape[1]
    pad_rank = 1.0 + torch.arange(s, dtype=torch.float32,
                                  device=seq_mask.device)[None, :]
    sort_key = torch.where(seq_mask, uniforms.to(seq_mask.device), pad_rank)
    indices = torch.argsort(sort_key, dim=-1, stable=True)
    return {
        name: gather_elements(x, indices)
        if (x.dim() >= 2 and x.shape[1] == s
            and (name not in schema or schema[name].is_sequence))
        else x
        for name, x in inputs.items()
    }


def merge_dicts(batches: Sequence[Tensors], axis: int = 0) -> Tensors:
    """Concatenate a list of tensor dicts key by key (sorting.py:107-112)."""
    return {k: torch.cat([b[k] for b in batches], dim=axis)
            for k in batches[0]}


def split_dict(inputs: Tensors, num_splits: int,
               axis: int = 0) -> List[Tensors]:
    """Split a tensor dict into ``num_splits`` equal parts along ``axis``;
    a length that does not divide raises, as ``jnp.split`` does
    (sorting.py:115-123)."""
    out: List[Tensors] = [{} for _ in range(num_splits)]
    for k, v in inputs.items():
        if v.shape[axis] % num_splits:
            raise ValueError(f"{k}: length {v.shape[axis]} does not split "
                             f"into {num_splits} equal parts")
        for i, piece in enumerate(torch.chunk(v, num_splits, dim=axis)):
            out[i][k] = piece
    return out


def reorganize_indices(from_inds: torch.Tensor, n_elems: torch.Tensor,
                       maxlen: int) -> torch.Tensor:
    """``(B, maxlen)`` int64 gather indices that move element
    ``from_inds[i, 0]`` of row ``i`` to position ``n_elems[i, 0]`` and shift
    the others to keep their order (sorting.py:126-148): position ``p``
    reads ``f`` where ``p == n``, else entry ``q`` (``p`` before ``n``,
    ``p - 1`` after) of the row without ``f``, which is ``q`` below ``f``
    and ``q + 1`` from it on."""
    f = from_inds[:, :1].long()
    n = n_elems[:, :1].long()
    pos = torch.arange(maxlen, device=f.device)[None, :]
    q = torch.where(pos < n, pos, pos - 1)
    val = torch.where(q < f, q, q + 1)
    return torch.where(pos == n, f, val)
