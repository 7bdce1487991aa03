"""Minimal TensorBoard event writer (no TensorFlow dependency).

The port's copy of ``flexdm_tpu/utils/tboard.py``.  Event files are
TFRecord framing around small ``Event`` protos, both of which the port's
data layer already encodes:

    Event { double wall_time = 1; int64 step = 2;
            oneof { string file_version = 3; Summary summary = 5; } }
    Summary { repeated Value value = 1; }
    Value   { string tag = 1; float simple_value = 2; }

For the same scalars and wall time the records are byte-equal to the JAX
package's, which TensorFlow's ``summary_iterator`` reads.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

from ..data.example_proto import _len_field, _tag, _varint
from ..data.tfrecord import RecordWriter


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & ((1 << 64) - 1))


def encode_scalar_event(
    step: int, scalars: Dict[str, float], wall_time: Optional[float] = None
) -> bytes:
    summary = b"".join(
        _len_field(
            1,
            _len_field(1, tag.encode("utf-8")) + _float_field(2, float(v)),
        )
        for tag, v in scalars.items()
    )
    return (
        _double_field(1, wall_time if wall_time is not None else time.time())
        + _varint_field(2, int(step))
        + _len_field(5, summary)
    )


def encode_file_version_event() -> bytes:
    return _double_field(1, time.time()) + _len_field(3, b"brain.Event:2")


class SummaryWriter:
    """Append scalar summaries to a TensorBoard event file in ``log_dir``.
    Values that are not numbers, and NaNs, are left out."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._writer = RecordWriter(os.path.join(log_dir, name))
        self._writer.write(encode_file_version_event())

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        clean = {
            k: float(v)
            for k, v in values.items()
            if isinstance(v, (int, float)) and v == v
        }
        if clean:
            self._writer.write(encode_scalar_event(step, clean))

    def close(self) -> None:
        self._writer.close()
