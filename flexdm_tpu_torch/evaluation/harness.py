"""Quantitative evaluation harness: per-task masked-field scoring (PyTorch).

Counterpart of ``flexdm_tpu/evaluation/harness.py`` (reference
``eval.py``), with its names and its scores.  Task modes:

* ``random``: re-mask ~15% of the fields, pure masking (no 80/10/10
  replacement).  Record ``i`` is masked by the ``(n_seq, S)`` uniforms of
  :func:`record_uniforms`, drawn from a CPU generator seeded by
  ``(seed, i)`` alone, so the scores do not change with the batch size.
  JAX draws them from ``fold_in(key, i)``, bits the port cannot make
  without JAX: the port's ``random`` scores are not JAX's for the same
  seed (``uniforms_fn`` takes other draws).
* ``elem``: single-element filling, one replica per (document, element)
  pair with that element masked.  The replicas are enumerated on the host
  from the lengths (real documents and real elements only) and cut into
  chunks of ``elem_chunk`` (zero-weighted padding): over the whole split
  by the cache's ``elem_index_blocks``, or per host batch when streaming
  (``_elem_replicas``, padded with the out-of-range id ``B * S``); each
  chunk is gathered on the device from the cache or the batch already
  there, so the ``B * S`` expansion is never built.  For an
  autoregressive baseline (``is_autoreg``) each replica's queried element
  is moved to the end of the valid prefix (``reorganize_indices``), so the
  causal decode predicts it from all the other elements.
* ``pos`` / ``attr`` / ``img`` / ``txt`` / ``type``: one attribute group
  masked across all elements.
* ``all_feat``: every group but ``type``.

rico ``pos`` is scored on sorted elements; ``num_iter > 1`` decodes with
MaskGIT.  Scores are Σnum/Σden over the split; a field whose Σden is 0 is
left out.

The split is resident on the device (flexdm_tpu/evaluation/harness.py:
268-286, :333-540): :func:`evaluate_all` builds one
:class:`~..data.pipeline.DeviceDataCache` of the split, each record decoded
and uploaded once, and every task gathers its chunks from it.  A task is a
loop over index blocks the cache builds on the host once (``chunk`` rows
each: the batch size, or ``elem_chunk`` replicas), each forward's stacked
sums added into one float32 tensor on the device, and one host fetch at
the end (JAX's ``lax.scan`` and its single fetch).  The ``random`` task's
uniforms are drawn for the whole split once per cache and seed and
gathered by record id.  A split over ``RESIDENT_BYTE_LIMIT`` streams
instead, JAX's rule: each host batch is stacked and copied to the device
(``_batches``), and the sums are added on the host in Python floats from
one ``.tolist()`` per forward; so does ``resident=False``.  Each task logs
which path it took.

More than one device (flexdm_tpu/evaluation/harness.py:295-330,
:627-640, :726-741): on a ``grid`` (:mod:`..parallel.mesh`) of one node
the cache is spread over the data ranks as the trainer spreads its own
(data rank ``d`` decodes and holds records ``d, d + D, ...``), the chunk
is rounded up to a multiple of D and each rank walks its columns of the
blocks (the ranks of a model group the same ones, through a
tensor-parallel model); a rank runs as many ``elem`` blocks as its own
replicas need, since no collective crosses data ranks inside a forward.
The sums are summed over the data ranks once a task.  A record's masks do
not depend on the rows around it, and the padding is zero-weighted, so
the scores are the single-device ones.  ``--num_devices N`` spawns N data
ranks.  Not carried over, as in JAX: a resident cache over more than one
node (``num_hosts > 1``, JAX's ``process_count() > 1``); such a run
streams, every rank reading the whole split and scoring its rows of each
batch.
"""

from __future__ import annotations

import argparse
import csv
import logging
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import NUM_VALID_KEY
from ..data.pipeline import DeviceDataCache
from ..data.schema import Schema
from ..models.losses import compute_mfp_loss
from ..models.masking import (
    MASK_PROB,
    get_initial_masks,
    get_seq_mask,
    one_hot,
    record_generator,
)
from ..models.mfp import forward_eval
from ..models.sorting import gather_elements, reorganize_indices
from ..parallel import mesh
from ..train.trainer import take_rows, to_device

logger = logging.getLogger(__name__)

Tensors = Dict[str, torch.Tensor]
Group = Tuple[str, Tuple[str, ...]]

# Splits whose per-record bytes times records exceed this stream batch by
# batch (flexdm_tpu/evaluation/harness.py:276-285).
RESIDENT_BYTE_LIMIT = 4 << 30


def _split_fits_resident(loader, record: int = 0) -> bool:
    """Whether the split's per-record bytes (those of record ``record``;
    every record has the same shapes) times its records are within
    ``RESIDENT_BYTE_LIMIT``."""
    per_record = sum(
        v.nbytes for v in loader._record(record).values()
        if isinstance(v, np.ndarray) and v.dtype != object
    )
    return per_record * loader.num_records <= RESIDENT_BYTE_LIMIT


def _group_masks(schema: Schema, batch, group_keys) -> Tensors:
    """Mask every valid element of the columns in ``group_keys``."""
    seq_mask = get_seq_mask(batch["length"], schema.max_length)
    masks = get_initial_masks(schema, seq_mask)
    for key in group_keys:
        masks[key] = seq_mask
    return masks


def record_uniforms(schema: Schema, seed: int,
                    ids: Sequence[int]) -> torch.Tensor:
    """``(len(ids), n_seq, S)`` uniforms of the ``random`` task on the CPU:
    row ``i`` from :func:`~..models.masking.record_generator` of
    ``(seed, ids[i])``."""
    n_seq = sum(1 for c in schema.modeled if c.is_sequence)
    return torch.stack([
        torch.rand((n_seq, schema.max_length),
                   generator=record_generator(seed, record))
        for record in ids
    ])


def _random_masks(schema: Schema, batch, uniforms: torch.Tensor) -> Tensors:
    """Pure-mask ``random`` task: sequence column ``j`` (in
    ``schema.modeled`` order) masks the valid elements whose
    ``uniforms[:, j]`` is below ``MASK_PROB``."""
    seq_mask = get_seq_mask(batch["length"], schema.max_length)
    masks = get_initial_masks(schema, seq_mask)
    si = 0
    for c in schema.modeled:
        if c.is_sequence:
            masks[c.name] = seq_mask & (uniforms[:, si] < MASK_PROB)
            si += 1
    return masks


def task_id_for_mode(schema: Schema, task_mode: str) -> int:
    """Task-conditioning id of a task mode (``schema.task_names`` order)."""
    return schema.task_names.index(task_mode)


def _metric_names(schema: Schema) -> Tuple[str, ...]:
    """The sorted ``{field}_score_num`` / ``{field}_score_den`` names a step
    returns."""
    fields = [
        c.name for c in schema.columns if c.is_sequence and not c.demo_only
    ]
    return tuple(sorted(
        [f"{f}_score_num" for f in fields]
        + [f"{f}_score_den" for f in fields]
    ))


def make_eval_step(model, num_iter: int = 1, sort: bool = False,
                   task_id: Optional[int] = None,
                   observe: Optional[Callable] = None):
    """``(step, names)``: ``step(batch, masks, sample_weight)`` runs
    ``forward_eval`` and ``compute_mfp_loss`` and returns the metrics
    ``names`` stacked in one tensor, so the host fetches once per forward.

    ``sort``: score on sorted elements (rico ``pos``).  ``task_id``: the
    task-embedding id of a ``context='id'`` model.  ``observe``, if given,
    is called after each forward with ``(batch, masks, sample_weight,
    prediction, rounds)``; ``rounds`` is MaskGIT's record of its rounds
    (None for one pass)."""
    schema = model.schema
    names = _metric_names(schema)

    @torch.inference_mode()
    def step(batch, masks, sample_weight):
        b = batch["length"].shape[0]
        device = batch["length"].device
        tasks = None
        if task_id is not None:
            tasks = torch.full((b,), task_id, dtype=torch.int32,
                               device=device)
        rounds = [] if observe is not None and num_iter > 1 else None
        prediction = forward_eval(model, batch, masks, tasks, num_iter,
                                  rounds)
        sort_flag = torch.ones(b, dtype=torch.bool, device=device) \
            if sort else None
        _, metrics = compute_mfp_loss(
            schema, batch, prediction, masks, sort_flag=sort_flag,
            sample_weight=sample_weight,
        )
        if observe is not None:
            observe(batch, masks, sample_weight, prediction, rounds)
        return torch.stack([metrics[k] for k in names])

    return step, names


def _elem_masks(schema: Schema, rows: Tensors, elem: torch.Tensor,
                weight: torch.Tensor, autoreg: bool = False):
    """Replica ``j`` is document ``rows[j]`` with element ``elem[j]``
    masked: returns ``(rows, masks, weight)``, the weight zeroed where the
    element is padding; with ``autoreg`` the element is moved to position
    ``length`` (the last valid one) and the others keep their order
    (flexdm_tpu/evaluation/harness.py:425-456)."""
    S = schema.max_length
    eye = one_hot(elem, S, torch.bool)
    seq_mask = get_seq_mask(rows["length"], S)
    weight = weight * seq_mask.gather(1, elem[:, None])[:, 0].to(
        torch.float32)
    if autoreg:
        indices = reorganize_indices(elem[:, None],
                                     rows["length"].reshape(-1, 1), S)
        rows = dict(rows)
        for c in schema.modeled:
            if c.is_sequence:
                rows[c.name] = gather_elements(rows[c.name], indices)
        eye = eye.gather(1, indices)
    masks = get_initial_masks(schema, torch.zeros_like(eye))
    for c in schema.modeled:
        if c.is_sequence:
            masks[c.name] = eye
    return rows, masks, weight


def _elem_chunk(schema: Schema, batch: Tensors, idx: torch.Tensor,
                batch_weight: torch.Tensor, autoreg: bool = False):
    """The replicas ``idx`` of a ``(B, ...)`` batch on its device: replica
    ``r`` is document ``r // S`` with element ``r % S`` masked, row ``r``
    of the JAX package's ``_expand_elem`` (see :func:`_elem_masks`).  The
    weight is 0 for an out-of-range ``r`` (chunk padding), a padded
    element or a padded batch row."""
    S = schema.max_length
    total = batch["length"].shape[0] * S
    valid = idx < total
    r = idx.clamp(max=total - 1)
    b = r // S
    rows = {k: v.index_select(0, b) for k, v in batch.items()}
    return _elem_masks(schema, rows, r % S,
                       valid.to(torch.float32) * batch_weight[b], autoreg)


def make_elem_step(model, num_iter: int = 1, sort: bool = False,
                   task_id: Optional[int] = None,
                   observe: Optional[Callable] = None):
    """``(elem_step, names)``: ``elem_step(batch, idx, batch_weight)``
    scores the replicas ``idx`` (see :func:`_elem_chunk`; reordered for an
    ``is_autoreg`` model) of a batch already on the device, with
    :func:`make_eval_step`'s step."""
    step, names = make_eval_step(model, num_iter, sort, task_id, observe)
    autoreg = getattr(model, "is_autoreg", False)

    def elem_step(batch, idx, batch_weight):
        return step(*_elem_chunk(model.schema, batch, idx, batch_weight,
                                 autoreg))

    return elem_step, names


def _accumulate(total: Dict[str, float], names, stacked) -> None:
    for k, v in zip(names, stacked.tolist()):  # one host fetch
        total[k] = total.get(k, 0.0) + v


def _batches(loader, device, grid: Optional[mesh.Grid] = None) -> Iterator[
        Tuple[Tensors, torch.Tensor, range, np.ndarray]]:
    """Per host batch: the batch on ``device`` (one copy), the sample
    weight (0 past ``num_valid``), the record ids (split order) and the
    host lengths ``(B,)``, -1 past ``num_valid`` (those rows hold no
    element to score); on a ``grid``, of this rank's rows only."""
    offset = 0
    for host_batch in loader:
        lengths = host_batch["length"].reshape(-1).astype(np.int64)
        b = lengths.shape[0]
        num_valid = host_batch.get(NUM_VALID_KEY, b)
        lengths[num_valid:] = -1
        rows = slice(0, b) if grid is None else grid.rows(b)
        batch = to_device(take_rows(host_batch, rows), device)
        weight = torch.zeros(b)
        weight[:num_valid] = 1.0
        yield (batch, weight[rows].to(device),
               range(offset, offset + b)[rows], lengths[rows])
        offset += b


def _elem_replicas(lengths: np.ndarray, S: int, chunk: int) -> np.ndarray:
    """Replica ids ``b * S + i`` of every real element (``length`` is
    zero-based: ``length + 1`` elements), padded to a whole number of
    chunks with the out-of-range id ``B * S``."""
    real = np.arange(S)[None, :] < np.clip(lengths[:, None] + 1, 0, S)
    ids = np.flatnonzero(real.reshape(-1))
    pad = np.full((-len(ids)) % chunk, lengths.shape[0] * S)
    return np.concatenate([ids, pad]).astype(np.int64)


def _task_options(model, task_mode: str, group: Optional[Group]):
    """``(sort, task_id)`` of a task's steps: rico ``pos`` is scored on
    sorted elements, and a ``context='id'`` model is told the task."""
    if task_mode not in ("elem", "random") and group is None:
        raise ValueError(f"task {task_mode!r} needs its attribute group")
    schema = model.schema
    sort = bool(schema.sort_pos) and task_mode == "pos"
    task_id = (task_id_for_mode(schema, task_mode)
               if getattr(model, "context", None) == "id" else None)
    return sort, task_id


def _task_sums_streaming(model, loader, task_mode: str,
                         group: Optional[Group], num_iter: int, seed: int,
                         elem_chunk: int, uniforms_fn: Callable,
                         observe: Optional[Callable],
                         grid: Optional[mesh.Grid]) -> Dict[str, float]:
    """Batch by batch from the host loader (JAX's
    ``_evaluate_task_streaming``): each rank scores its rows of every
    batch, the sums added on the host per forward."""
    schema = model.schema
    device = next(model.parameters()).device
    sort, task_id = _task_options(model, task_mode, group)
    make_step = make_elem_step if task_mode == "elem" else make_eval_step
    step, names = make_step(model, num_iter, sort, task_id, observe)
    total = dict.fromkeys(names, 0.0)
    for batch, weight, ids, lengths in _batches(loader, device, grid):
        if task_mode == "elem":
            replicas = torch.from_numpy(
                _elem_replicas(lengths, schema.max_length, elem_chunk)
            ).to(device)
            for start in range(0, replicas.shape[0], elem_chunk):
                _accumulate(total, names, step(
                    batch, replicas[start:start + elem_chunk], weight))
            continue
        if task_mode == "random":
            masks = _random_masks(schema, batch,
                                  uniforms_fn(schema, seed, ids).to(device))
        else:
            masks = _group_masks(schema, batch, group[1])
        _accumulate(total, names, step(batch, masks, weight))
    if grid is not None:
        total = dict(zip(names, grid.sum_over_data(
            [total[k] for k in names], loader.batch_size)))
    return total


def _task_sums_resident(model, cache: DeviceDataCache, batch_size: int,
                        task_mode: str, group: Optional[Group],
                        num_iter: int, seed: int, elem_chunk: int,
                        uniforms_fn: Callable, observe: Optional[Callable],
                        grid: Optional[mesh.Grid]) -> Dict[str, float]:
    """The task over the cache's index blocks (JAX's ``_resident_scan``
    and ``_evaluate_task_resident``): each chunk gathered from the cache,
    masked, scored, and its sums added into one float32 tensor on the
    device; one host fetch."""
    schema = model.schema
    step, names = make_eval_step(model, num_iter,
                                 *_task_options(model, task_mode, group),
                                 observe)
    D = cache.data_size
    chunk = elem_chunk if task_mode == "elem" else batch_size
    chunk = -(-chunk // D) * D  # every data rank an equal share a block
    total = torch.zeros(len(names), dtype=torch.float32, device=cache.device)
    if task_mode == "elem":
        autoreg = getattr(model, "is_autoreg", False)
        for doc, elem, w in zip(*cache.device_elem_blocks(
                chunk, schema.max_length)):
            total += step(*_elem_masks(schema, cache.gather(doc), elem, w,
                                       autoreg))
    else:
        if task_mode == "random":
            uniforms = cache.on_device(
                ("uniforms", seed, uniforms_fn),
                lambda: uniforms_fn(schema, seed, range(cache.num_records)))
        for blk, w, gid in zip(*cache.device_eval_blocks(chunk)):
            batch = cache.gather(blk)
            if task_mode == "random":
                masks = _random_masks(schema, batch,
                                      uniforms.index_select(0, gid))
            else:
                masks = _group_masks(schema, batch, group[1])
            total += step(batch, masks, w)
    values = total.tolist()  # the task's one host fetch
    if grid is not None:
        values = grid.sum_over_data(values, chunk)
    return dict(zip(names, values))


def _make_cache(loader, device, grid: Optional[mesh.Grid] = None
                ) -> DeviceDataCache:
    """The split resident on ``device``; on a ``grid``, spread over its
    data ranks as the trainer spreads its own (the ranks of a model group
    hold the same shard)."""
    if grid is None:
        return DeviceDataCache(loader, device)
    return DeviceDataCache(loader, device, grid.data_size, grid.data_rank)


def _streams(loader, resident: Optional[bool], cache,
             grid: Optional[mesh.Grid]) -> bool:
    """JAX's dispatch (flexdm_tpu/evaluation/harness.py:333-377): stream
    when asked to, when the split is over ``RESIDENT_BYTE_LIMIT`` and no
    cache is given, or over more than one node."""
    if grid is not None and grid.num_hosts > 1:
        return True
    if resident is None:
        # A record this rank's shard holds: a spread cache decodes no other.
        first = 0 if grid is None else min(grid.data_rank,
                                           loader.num_records - 1)
        resident = cache is not None or _split_fits_resident(loader, first)
    return not resident


def task_sums(model, loader, task_mode: str, group: Optional[Group],
              num_iter: int = 1, seed: int = 0, elem_chunk: int = 256,
              uniforms_fn: Callable = record_uniforms,
              observe: Optional[Callable] = None,
              grid: Optional[mesh.Grid] = None,
              resident: Optional[bool] = None,
              cache: Optional[DeviceDataCache] = None) -> Dict[str, float]:
    """Σ of every ``{field}_score_num`` / ``_score_den`` over a split, on
    the device of ``model``; ``{}`` for an empty split.  ``group`` is
    ``(name, columns)`` for a group task, None for ``random`` and
    ``elem``; ``uniforms_fn(schema, seed, ids)`` gives the ``random``
    task's uniforms; ``observe`` goes to :func:`make_eval_step`.  On a
    ``grid`` each rank scores its share and the sums are summed over the
    data ranks.  Resident on the device (from ``cache``, a
    :class:`~..data.pipeline.DeviceDataCache` of the split, or one built
    here) unless :func:`_streams` says to stream."""
    if loader.num_records == 0:
        return {}
    if _streams(loader, resident, cache, grid):
        logger.info("eval %s: streaming %d records batch by batch",
                    task_mode, loader.num_records)
        return _task_sums_streaming(model, loader, task_mode, group,
                                    num_iter, seed, elem_chunk, uniforms_fn,
                                    observe, grid)
    if cache is None:
        cache = _make_cache(loader, next(model.parameters()).device, grid)
    logger.info("eval %s: resident, a cache of %d of %d records, %d bytes "
                "on %s, built in %.3f s", task_mode, cache.shard_size,
                cache.num_records, cache.nbytes, cache.device,
                cache.build_seconds)
    return _task_sums_resident(model, cache, loader.batch_size, task_mode,
                               group, num_iter, seed, elem_chunk,
                               uniforms_fn, observe, grid)


def _ratios(schema: Schema, total: Dict[str, float]) -> Dict[str, float]:
    ans = {}
    for c in schema.columns:
        num = total.get(f"{c.name}_score_num")
        den = total.get(f"{c.name}_score_den")
        if num is not None and den:
            ans[c.name] = num / den
    return ans


def evaluate_task(model, loader, task_mode: str, group: Optional[Group],
                  num_iter: int = 1, seed: int = 0, elem_chunk: int = 256,
                  uniforms_fn: Callable = record_uniforms,
                  grid: Optional[mesh.Grid] = None,
                  resident: Optional[bool] = None,
                  cache: Optional[DeviceDataCache] = None
                  ) -> Dict[str, float]:
    """Scores of one task over a split: ``{field: Σnum / Σden}`` (see
    :func:`task_sums`)."""
    return _ratios(model.schema, task_sums(
        model, loader, task_mode, group, num_iter, seed, elem_chunk,
        uniforms_fn, grid=grid, resident=resident, cache=cache))


def evaluate_all(model, spec, task_mode: str, batch_size: int = 256,
                 num_iter: int = 1, split: str = "test",
                 grid: Optional[mesh.Grid] = None
                 ) -> Dict[str, Dict[str, float]]:
    """Run the requested task mode(s): ``{group_name: {field: score}}``;
    ``elem`` and ``random`` go under ``"all"``.  One loader and, where the
    split is resident, one cache serve every task, so each record is
    decoded and uploaded once."""
    groups = spec.schema.attribute_groups
    loader = spec.make_dataset(split, batch_size=batch_size)
    cache = None
    if loader.num_records and not _streams(loader, None, None, grid):
        cache = _make_cache(loader, next(model.parameters()).device, grid)

    def task(name, group):
        return evaluate_task(model, loader, name, group, num_iter,
                             grid=grid, cache=cache)

    if task_mode in ("elem", "random"):
        return {"all": task(task_mode, None)}
    if task_mode == "all_feat":
        return {name: task(name, (name, keys))
                for name, keys in groups.items() if name != "type"}
    if task_mode not in groups:
        raise ValueError(f"task_mode {task_mode!r} is not elem, random, "
                         f"all_feat or one of {tuple(groups)}")
    return {task_mode: task(task_mode, (task_mode, groups[task_mode]))}


def merge_results(ans_all: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Merge per-group answers, rounded to 4 places, NaNs dropped
    (reference eval.py:187-193)."""
    final: Dict[str, float] = {}
    for ans in ans_all.values():
        for k, v in ans.items():
            if v == v:
                final[k] = round(v, 4)
    return final


def _refuse_unported(args) -> None:
    if args.attention_impl != "auto":
        raise NotImplementedError(
            f"--attention_impl {args.attention_impl} is not in this port yet")


def _evaluate(args, grid: Optional[mesh.Grid] = None) -> Dict[str, float]:
    from ..demo import load_model

    device = args.device if grid is None else grid.device
    model, spec = load_model(args.job_dir, args.checkpoint, args.batch_size,
                             device, data_dir=args.data_dir)
    return merge_results(evaluate_all(
        model, spec, args.task_mode, batch_size=args.batch_size,
        num_iter=args.num_iter, split=args.split, grid=grid,
    ))


def main(argv=None, devices=None,
         backend: Optional[str] = None) -> Dict[str, float]:
    """``python -m flexdm_tpu_torch.evaluation``: score a job per task.
    The flags of the JAX package's CLI, plus ``--device`` (default
    ``cuda``; ``cpu`` only on request).  ``--num_devices N`` scores on N
    data ranks (spawned, or joined under ``torchrun``) as
    :func:`..train.trainer.train` places them; ``devices`` and
    ``backend`` as there (several ranks on one card under ``gloo``)."""
    parser = argparse.ArgumentParser(
        description="Evaluate a trained MFP model per task (PyTorch port)")
    add = parser.add_argument
    add("--job-dir", dest="job_dir", required=True)
    add("--batch_size", default=256, type=int)
    add("--task_mode", default="attr", type=str)
    add("--num_iter", default=1, type=int)
    add("--result_csv", default="", type=str)
    add("--checkpoint", default="best", type=str)
    add("--split", default="test", type=str)
    add("--attention_impl", default="auto", type=str)
    add("--num_devices", default=None, type=int,
        help="shard evaluation batches over this many data ranks")
    add("--data_dir", default=None, type=str,
        help="override the data dir recorded in args.json")
    add("--device", default="cuda", help="torch device to evaluate on")
    args = parser.parse_args(argv)
    _refuse_unported(args)

    if args.num_devices is None:
        final = _evaluate(args)
    else:
        final = mesh.run_ranks(_evaluate, (args,), args.num_devices, 1,
                               args.device, devices, backend)
        if final is None:  # a rank other than 0 under torchrun
            return final
    print(final)
    if args.result_csv:
        with open(args.result_csv, "w") as f:
            writer = csv.writer(f)
            writer.writerow(list(final.keys()))
            writer.writerow(list(final.values()))
    return final
