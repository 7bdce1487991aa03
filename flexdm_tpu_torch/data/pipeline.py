"""Input pipeline: TFRecord shards -> fixed-shape batches, on the host or
resident on the device.

The port's own copy of ``flexdm_tpu/data/pipeline.py``:

* :class:`DataLoader` streams padded numpy batches of one split.  Static
  shapes: every batch is ``(B, max_length, C)``.  Records are decoded
  once, on first touch, and cached in RAM; batches are ``np.stack`` calls.
  The shuffle is re-derived per epoch from ``seed + epoch``, its epoch
  counted from 0.  A final partial batch is padded up to ``batch_size``
  and annotated with ``num_valid`` so evaluation keeps exact num/den
  score accounting.
* :class:`Prefetcher` runs any batch iterable (and a transform, such as
  the host-to-device copy) in a background thread.
* :class:`DeviceDataCache` stacks every record of a split once into
  tensors on one device; a batch is an ``index_select`` on a ``(B,)``
  index tensor, and :meth:`DeviceDataCache.epoch_indices` shuffles from
  ``seed + epoch`` with the epoch counted from 1, as the JAX trainer
  passes it, so the two packages' device-mode batches are the same
  records.  The two modes' batch orders differ, as in JAX.

More than one device, as in JAX: ``DataLoader(num_hosts, host_id)``
gives host ``host_id`` the records ``host_id, host_id + num_hosts, ...``
and keeps the pre-shard ``global_num_records``, from which every host
derives the same number of steps; ``DeviceDataCache(loader, device,
data_size, data_rank)`` holds data rank ``d``'s records ``d, d + D, ...``
only, and its :meth:`~DeviceDataCache.epoch_indices` is JAX's stratified,
device-aligned shuffle: columns ``[d k, (d+1) k)`` of every ``(B,)`` row
are data rank ``d``'s local indices, so the ranks' batches are the
records JAX's mesh of the same size takes.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    Optional)

import numpy as np
import torch

from . import tfrecord

# Key carrying the number of real (non-padding) samples in a padded batch.
NUM_VALID_KEY = "num_valid"


class DataLoader:
    """Iterable over preprocessed, padded batches of one split."""

    def __init__(
        self,
        spec,
        split: str,
        batch_size: int = 8,
        shuffle: bool = False,
        repeat: bool = False,
        seed: int = 0,
        drop_remainder: bool = False,
        num_hosts: int = 1,
        host_id: int = 0,
        verify_crc: bool = False,
    ):
        self.spec = spec
        self.split = split
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.repeat = repeat
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.verify_crc = verify_crc

        shards = tfrecord.list_shards(spec.path, split)
        if not shards:
            raise FileNotFoundError(
                f"no TFRecord shards for split {split!r} under {spec.path}"
            )
        payloads: List[bytes] = []
        for shard in shards:
            payloads.extend(tfrecord.read_records(
                shard, verify_crc=verify_crc, native=spec.native))
        # The pre-shard count, from which every host derives the same
        # number of steps per epoch (its shard may be one record short).
        self.global_num_records = len(payloads)
        if num_hosts > 1:
            payloads = payloads[host_id::num_hosts]
        self._payloads = payloads
        self._decoded: List[Optional[Dict[str, np.ndarray]]] = [None] * len(
            payloads
        )

    def __len__(self) -> int:
        n = len(self._payloads)
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    @property
    def num_records(self) -> int:
        return len(self._payloads)

    def _record(self, i: int) -> Dict[str, np.ndarray]:
        if self._decoded[i] is None:
            self._decoded[i] = self.spec.decode_record(self._payloads[i])
        return self._decoded[i]

    def _make_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        records = [self._record(int(i)) for i in indices]
        num_valid = len(records)
        if num_valid < self.batch_size:
            records = records + [records[-1]] * (self.batch_size - num_valid)
        batch = {
            k: np.stack([r[k] for r in records], axis=0) for k in records[0]
        }
        batch[NUM_VALID_KEY] = num_valid
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self._payloads)
        if self.drop_remainder and n < self.batch_size:
            raise ValueError(
                f"split {self.split!r} has {n} records < batch_size "
                f"{self.batch_size} with drop_remainder=True; no batch can "
                "ever be produced"
            )
        epoch = 0
        while True:
            order = np.arange(n)
            if self.shuffle:
                rng = np.random.default_rng(self.seed + epoch)
                rng.shuffle(order)
            stop = n - n % self.batch_size if self.drop_remainder else n
            for start in range(0, stop, self.batch_size):
                yield self._make_batch(order[start : start + self.batch_size])
            if not self.repeat:
                return
            epoch += 1


class Prefetcher:
    """Background-thread prefetch over any iterable, ``depth`` items ahead.

    ``transform`` runs in the worker thread (the trainer passes the
    host-to-device copy there, so copies overlap the steps).  An error in
    the worker is raised in the consumer, after the items made before it.
    :meth:`close` stops the worker (an endless loader would otherwise keep
    it blocked on a full queue).
    """

    def __init__(self, iterable: Iterable, depth: int = 2,
                 transform: Optional[Callable] = None):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: Optional[BaseException] = None
        self._closed = threading.Event()

        def worker():
            try:
                for item in iterable:
                    if self._closed.is_set():
                        return
                    self._put(transform(item) if transform is not None
                              else item)
            except BaseException as e:  # raised again in the consumer
                self._err = e
            finally:
                self._put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._closed.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is self._sentinel:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker and drop what it had queued."""
        self._closed.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)


class DeviceDataCache:
    """A whole split resident on one device.

    Every record is stacked once into one tensor per field on ``device``
    (the strings stay in the loader's host records); each training step
    then gathers its batch with ``index_select`` on a ``(B,)`` index
    tensor, so the only per-step traffic is the indices.  A failed upload
    raises: there is no host fallback.

    With ``data_size`` D > 1 the split is spread over the data ranks
    (JAX's mesh mode, flexdm_tpu/data/pipeline.py:171-442): data rank
    ``data_rank`` holds records ``d, d + D, ...`` (``local_counts[d]`` of
    them; the shard's tail repeats its last record), decodes only those,
    and a batch gathers this rank's local indices.

    Evaluation (flexdm_tpu/data/pipeline.py:249-258, :320-424) walks the
    cache through index blocks built on the host from the records'
    lengths: :meth:`eval_index_blocks` (every real record once) and
    :meth:`elem_index_blocks` (every real (record, element) pair once), on
    a spread cache this rank's columns of JAX's device-aligned blocks.
    :meth:`on_device` uploads such a block once per key.
    """

    def __init__(self, loader: DataLoader, device, data_size: int = 1,
                 data_rank: int = 0):
        t0 = time.perf_counter()
        n = loader.num_records
        self.num_records = n
        self.data_size = data_size
        self.data_rank = data_rank
        self.device = torch.device(device)
        self.shard_size = -(-n // data_size)
        self.local_counts = np.array(
            [len(range(d, n, data_size)) for d in range(data_size)],
            dtype=np.int64)
        mine = list(range(data_rank, n, data_size)) or [n - 1]
        # The global id of the record each slot holds.
        self.record_ids = np.array(
            mine + [mine[-1]] * (self.shard_size - len(mine)), np.int64)
        records = [loader._record(int(g)) for g in mine]
        records += [records[-1]] * (self.shard_size - len(records))
        # Host lengths per slot (zero-based: L + 1 elements), for the
        # ``elem`` blocks.
        self.host_lengths = (
            np.array([int(np.asarray(r["length"]).reshape(-1)[0])
                      for r in records], np.int64)
            if "length" in records[0] else None)
        self.data: Dict[str, torch.Tensor] = {}
        for k, v in records[0].items():
            if isinstance(v, np.ndarray) and v.dtype == object:
                continue
            stacked = np.stack([r[k] for r in records], axis=0)
            self.data[k] = torch.from_numpy(stacked).to(self.device)
        self.nbytes = sum(v.nbytes for v in self.data.values())
        self._on_device: Dict[Any, Any] = {}
        self.build_seconds = time.perf_counter() - t0

    def gather(self, indices: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Batch = dataset[indices], computed on the cache's device."""
        return {k: v.index_select(0, indices) for k, v in self.data.items()}

    def epoch_indices(self, batch_size: int, seed: int,
                      epoch: int) -> np.ndarray:
        """The epoch's ``(steps, batch_size)`` int64 index block:
        ``default_rng(seed + epoch).permutation``, remainder dropped.
        Spread over D data ranks: columns ``[d k, (d+1) k)`` (``k = B /
        D``) are a permutation of data rank ``d``'s ``local_counts[d]``
        records, cut to ``steps * k`` (each record at most once an
        epoch), drawn for ``d = 0, 1, ...`` in turn from the one
        generator, as JAX's mesh mode draws them."""
        rng = np.random.default_rng(seed + epoch)
        steps = self.num_records // batch_size
        if batch_size % self.data_size:
            raise ValueError(f"batch {batch_size} does not divide the "
                             f"{self.data_size} data ranks")
        k = batch_size // self.data_size
        cols = [rng.permutation(int(c))[:steps * k].reshape(steps, k)
                for c in self.local_counts]
        return np.concatenate(cols, axis=1).astype(np.int64)

    def _per_rank(self, chunk: int) -> int:
        if chunk % self.data_size:
            raise ValueError(f"chunk {chunk} does not divide the "
                             f"{self.data_size} data ranks")
        return chunk // self.data_size

    def eval_index_blocks(self, chunk: int):
        """``(blk, w, gid)``, each ``(T, chunk / D)``: local indices
        covering every real record of this rank once, their weights (0 on
        the padding) and the global ids of the records they hold, this
        rank's columns of JAX's ``(T, chunk)`` blocks."""
        k = self._per_rank(chunk)
        T = -(-self.shard_size // k)
        rows = np.arange(T * k).reshape(T, k)
        blk = np.minimum(rows, self.shard_size - 1)
        w = (rows < self.local_counts[self.data_rank]).astype(np.float32)
        return blk, w, self.record_ids[blk]

    def elem_index_blocks(self, chunk: int, seq_len: int):
        """``(doc, elem, w)``, each ``(T, chunk / D)``: one replica per
        real (record, element) pair of this rank (``length`` is
        zero-based: L + 1 elements), its local record index, element and
        weight; the tail padded with zero-weight ``(0, 0)`` replicas.
        This rank's columns of JAX's blocks, cut to the rows that hold
        its replicas (at least one): ranks may run different numbers of
        blocks."""
        k = self._per_rank(chunk)
        slots = np.arange(self.shard_size)
        if self.host_lengths is None:
            lengths = np.full(self.shard_size, seq_len, np.int64)
        else:
            lengths = np.clip(self.host_lengths + 1, 0, seq_len)
        lengths = lengths * (slots < self.local_counts[self.data_rank])
        n = int(lengths.sum())
        T = max(1, -(-n // k))
        doc = np.zeros(T * k, np.int64)
        elem = np.zeros(T * k, np.int64)
        w = np.zeros(T * k, np.float32)
        doc[:n] = np.repeat(slots, lengths)
        elem[:n] = np.arange(n) - (np.cumsum(lengths) - lengths)[doc[:n]]
        w[:n] = 1.0
        return doc.reshape(T, k), elem.reshape(T, k), w.reshape(T, k)

    def on_device(self, key, make: Callable):
        """``make()`` (a tensor or a tuple of arrays or tensors) on the
        cache's device, made and uploaded once per ``key``."""
        if key not in self._on_device:
            value = make()
            parts = value if isinstance(value, tuple) else (value,)
            parts = tuple(torch.as_tensor(p).to(self.device) for p in parts)
            self._on_device[key] = parts if isinstance(value, tuple) \
                else parts[0]
        return self._on_device[key]

    def device_eval_blocks(self, chunk: int):
        """:meth:`eval_index_blocks` on the device, uploaded once."""
        return self.on_device(("eval", chunk),
                              lambda: self.eval_index_blocks(chunk))

    def device_elem_blocks(self, chunk: int, seq_len: int):
        """:meth:`elem_index_blocks` on the device, uploaded once."""
        return self.on_device(("elem", chunk, seq_len),
                              lambda: self.elem_index_blocks(chunk, seq_len))


def split_device_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop host-only entries (strings, counters) before device transfer."""
    out = {}
    for k, v in batch.items():
        if k == NUM_VALID_KEY:
            continue
        if isinstance(v, np.ndarray) and v.dtype == object:
            continue
        out[k] = v
    return out
