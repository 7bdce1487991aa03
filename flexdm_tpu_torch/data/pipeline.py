"""Host-side input pipeline: TFRecord shards -> fixed-shape numpy batches.

The port's own copy of the host loader of ``flexdm_tpu/data/pipeline.py``
(``DataLoader``, ``split_device_batch``).  The JAX package's
device-resident input mode (``DeviceDataCache`` and its gathers) is not
carried over: the port's CLI refuses that mode.

* **Static shapes.**  Every batch is ``(B, max_length, C)``.
* **Decode once, cache.**  Records are decoded to compact per-record arrays on
  first touch and cached in RAM; batches are then ``np.stack`` calls.
* **Deterministic shuffling** from an explicit seed, re-derived per epoch.
* **Final partial batches** are padded up to ``batch_size`` and annotated with
  ``num_valid`` so evaluation can keep exact num/den score accounting.

The JAX package's per-host record sharding (``num_hosts``, ``host_id``) is
not carried over: the port runs on one device (ROADMAP Queue A #11).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

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
            payloads.extend(tfrecord.read_records(shard, verify_crc=verify_crc))
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
