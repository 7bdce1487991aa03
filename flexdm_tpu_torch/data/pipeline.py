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

The JAX package's per-host record sharding (``num_hosts``, ``host_id``)
and its mesh-sharded cache are not carried over: the port runs on one
device (ROADMAP Queue A #11).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional

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
        verify_crc: bool = False,
    ):
        self.spec = spec
        self.split = split
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.repeat = repeat
        self.seed = seed
        self.drop_remainder = drop_remainder
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
    """

    def __init__(self, loader: DataLoader, device):
        records = [loader._record(i) for i in range(loader.num_records)]
        self.num_records = len(records)
        self.data: Dict[str, torch.Tensor] = {}
        for k, v in records[0].items():
            if isinstance(v, np.ndarray) and v.dtype == object:
                continue
            stacked = np.stack([r[k] for r in records], axis=0)
            self.data[k] = torch.from_numpy(stacked).to(device)

    def gather(self, indices: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Batch = dataset[indices], computed on the cache's device."""
        return {k: v.index_select(0, indices) for k, v in self.data.items()}

    def epoch_indices(self, batch_size: int, seed: int,
                      epoch: int) -> np.ndarray:
        """The epoch's ``(steps, batch_size)`` int64 index block:
        ``default_rng(seed + epoch).permutation``, remainder dropped."""
        order = np.random.default_rng(seed + epoch).permutation(
            self.num_records)
        steps = self.num_records // batch_size
        return order[:steps * batch_size].reshape(steps, batch_size)


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
