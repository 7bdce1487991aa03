"""TFRecord container I/O without TensorFlow.

The port's own copy of ``flexdm_tpu/data/tfrecord.py``, reduced to the
numpy reader and the writer (the JAX package's optional C++ scanner and
decoders are not carried over; the records read are the same).

Record framing (the on-disk format produced by ``tf.io.TFRecordWriter`` and
consumed by the reference's ``tf.data.TFRecordDataset``, reference
``src/mfp/mfp/data/spec.py:234-237``)::

    uint64 length
    uint32 masked_crc32c(length)
    bytes  data[length]
    uint32 masked_crc32c(data)

CRC-32C (Castagnoli) with TFRecord's mask rotation.
"""

from __future__ import annotations

import glob as globlib
import os
import struct
from typing import Iterator, List, Optional

import numpy as np

_CRC_TABLE: Optional[np.ndarray] = None


def _crc32c_table() -> np.ndarray:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # reflected Castagnoli polynomial
        table = np.empty(256, dtype=np.uint32)
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table[i] = crc
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    t = _crc32c_table()
    c = 0xFFFFFFFF
    for b in np.frombuffer(data, dtype=np.uint8):
        c = (c >> 8) ^ int(t[(c ^ int(b)) & 0xFF])
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def read_records(path: str, verify_crc: bool = False) -> List[bytes]:
    """Read every record payload in a TFRecord file."""
    return list(iter_records(path, verify_crc=verify_crc))


def iter_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Iterate record payloads in a TFRecord file."""
    with open(path, "rb") as f:
        blob = f.read()
    pos, end = 0, len(blob)
    while pos < end:
        if end - pos < 12:
            raise IOError(f"truncated TFRecord header in {path} @ {pos}")
        (length,) = struct.unpack("<Q", blob[pos : pos + 8])
        if verify_crc:
            (length_crc,) = struct.unpack("<I", blob[pos + 8 : pos + 12])
            if masked_crc32c(blob[pos : pos + 8]) != length_crc:
                raise IOError(f"bad length crc in {path} @ {pos}")
        pos += 12
        data = blob[pos : pos + length]
        if len(data) != length:
            raise IOError(f"truncated TFRecord payload in {path} @ {pos}")
        pos += length
        if verify_crc:
            (data_crc,) = struct.unpack("<I", blob[pos : pos + 4])
            if masked_crc32c(data) != data_crc:
                raise IOError(f"bad data crc in {path} @ {pos}")
        pos += 4
        yield data


class RecordWriter:
    """Write TFRecord files (used by the synthetic-data generator)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", masked_crc32c(data)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def list_shards(data_dir: str, split: str) -> List[str]:
    """Shard files for a split, sorted (reference spec.py:231-233)."""
    return sorted(globlib.glob(os.path.join(data_dir, f"{split}-*.tfrecord")))
