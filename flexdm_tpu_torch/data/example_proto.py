"""Minimal, dependency-free codec for ``tf.train.SequenceExample`` protos.

The port's own copy of ``flexdm_tpu/data/example_proto.py``.

The reference parses its TFRecord shards with ``tf.io.parse_sequence_example``
(reference ``src/mfp/mfp/data/spec.py:255-287``).  This framework must not
depend on TensorFlow at runtime, so we speak the protobuf wire format
directly.  Only the small message tree used by SequenceExample is needed:

    BytesList  { repeated bytes value = 1; }
    FloatList  { repeated float value = 1 [packed = true]; }
    Int64List  { repeated int64 value = 1 [packed = true]; }
    Feature    { oneof { BytesList=1; FloatList=2; Int64List=3 } }
    Features   { map<string, Feature> feature = 1; }
    FeatureList  { repeated Feature feature = 1; }
    FeatureLists { map<string, FeatureList> feature_list = 1; }
    SequenceExample { Features context = 1; FeatureLists feature_lists = 2; }

Decoding returns plain Python structures (lists of bytes/float/int); shaping
and dtype conversion happen in the DatasetSpec layer.  An encoder is provided
for the synthetic-data writer and for golden round-trip tests against
TensorFlow's own parser.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple, Union

FeatureValue = Union[List[bytes], List[float], List[int]]

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


# ---------------------------------------------------------------------------
# Low-level varint / field readers
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _read_tag(buf: bytes, pos: int) -> Tuple[int, int, int]:
    key, pos = _read_varint(buf, pos)
    return key >> 3, key & 0x7, pos


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == _WIRE_VARINT:
        _, pos = _read_varint(buf, pos)
    elif wire == _WIRE_64BIT:
        pos += 8
    elif wire == _WIRE_LEN:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == _WIRE_32BIT:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _to_int64(v: int) -> int:
    """Interpret an unsigned varint as two's-complement int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# Feature / Features / FeatureLists decoding
# ---------------------------------------------------------------------------

def _parse_feature(buf: bytes) -> FeatureValue:
    """Parse a Feature message; returns the contained value list."""
    pos = 0
    end = len(buf)
    values: FeatureValue = []
    while pos < end:
        field, wire, pos = _read_tag(buf, pos)
        if wire != _WIRE_LEN:
            pos = _skip_field(buf, pos, wire)
            continue
        n, pos = _read_varint(buf, pos)
        body = buf[pos : pos + n]
        pos += n
        if field == 1:  # BytesList
            values = _parse_bytes_list(body)
        elif field == 2:  # FloatList
            values = _parse_float_list(body)
        elif field == 3:  # Int64List
            values = _parse_int64_list(body)
    return values


def _parse_bytes_list(buf: bytes) -> List[bytes]:
    pos, end, out = 0, len(buf), []
    while pos < end:
        field, wire, pos = _read_tag(buf, pos)
        if field == 1 and wire == _WIRE_LEN:
            n, pos = _read_varint(buf, pos)
            out.append(buf[pos : pos + n])
            pos += n
        else:
            pos = _skip_field(buf, pos, wire)
    return out


def _parse_float_list(buf: bytes) -> List[float]:
    pos, end, out = 0, len(buf), []
    while pos < end:
        field, wire, pos = _read_tag(buf, pos)
        if field != 1:
            pos = _skip_field(buf, pos, wire)
        elif wire == _WIRE_LEN:  # packed (the common case)
            n, pos = _read_varint(buf, pos)
            out.extend(struct.unpack(f"<{n // 4}f", buf[pos : pos + n]))
            pos += n
        elif wire == _WIRE_32BIT:  # unpacked
            out.append(struct.unpack("<f", buf[pos : pos + 4])[0])
            pos += 4
        else:
            pos = _skip_field(buf, pos, wire)
    return out


def _parse_int64_list(buf: bytes) -> List[int]:
    pos, end, out = 0, len(buf), []
    while pos < end:
        field, wire, pos = _read_tag(buf, pos)
        if field != 1:
            pos = _skip_field(buf, pos, wire)
        elif wire == _WIRE_LEN:  # packed
            n, pos = _read_varint(buf, pos)
            stop = pos + n
            while pos < stop:
                v, pos = _read_varint(buf, pos)
                out.append(_to_int64(v))
        elif wire == _WIRE_VARINT:  # unpacked
            v, pos = _read_varint(buf, pos)
            out.append(_to_int64(v))
        else:
            pos = _skip_field(buf, pos, wire)
    return out


def _parse_map_entry(buf: bytes) -> Tuple[str, bytes]:
    """Parse one map<string, Message> entry; returns (key, raw value bytes)."""
    pos, end = 0, len(buf)
    key = ""
    value = b""
    while pos < end:
        field, wire, pos = _read_tag(buf, pos)
        if wire != _WIRE_LEN:
            pos = _skip_field(buf, pos, wire)
            continue
        n, pos = _read_varint(buf, pos)
        body = buf[pos : pos + n]
        pos += n
        if field == 1:
            key = body.decode("utf-8")
        elif field == 2:
            value = body
    return key, value


def _parse_features(buf: bytes) -> Dict[str, FeatureValue]:
    """Parse a Features message (map<string, Feature>)."""
    pos, end = 0, len(buf)
    out: Dict[str, FeatureValue] = {}
    while pos < end:
        field, wire, pos = _read_tag(buf, pos)
        if field == 1 and wire == _WIRE_LEN:
            n, pos = _read_varint(buf, pos)
            key, raw = _parse_map_entry(buf[pos : pos + n])
            pos += n
            out[key] = _parse_feature(raw)
        else:
            pos = _skip_field(buf, pos, wire)
    return out


def _parse_feature_list(buf: bytes) -> List[FeatureValue]:
    """Parse a FeatureList message (repeated Feature)."""
    pos, end, out = 0, len(buf), []
    while pos < end:
        field, wire, pos = _read_tag(buf, pos)
        if field == 1 and wire == _WIRE_LEN:
            n, pos = _read_varint(buf, pos)
            out.append(_parse_feature(buf[pos : pos + n]))
            pos += n
        else:
            pos = _skip_field(buf, pos, wire)
    return out


def _parse_feature_lists(
    buf: bytes, skip: frozenset = frozenset()
) -> Dict[str, List[FeatureValue]]:
    """Parse a FeatureLists message (map<string, FeatureList>).

    Keys in ``skip`` are recorded with an empty list but their (potentially
    large) bodies are not parsed — the native decoder handles them.
    """
    pos, end = 0, len(buf)
    out: Dict[str, List[FeatureValue]] = {}
    while pos < end:
        field, wire, pos = _read_tag(buf, pos)
        if field == 1 and wire == _WIRE_LEN:
            n, pos = _read_varint(buf, pos)
            key, raw = _parse_map_entry(buf[pos : pos + n])
            pos += n
            out[key] = [] if key in skip else _parse_feature_list(raw)
        else:
            pos = _skip_field(buf, pos, wire)
    return out


def decode_sequence_example(
    buf: bytes,
    skip_sequence_keys: frozenset = frozenset(),
) -> Tuple[Dict[str, FeatureValue], Dict[str, List[FeatureValue]]]:
    """Decode a serialized SequenceExample into (context, feature_lists)."""
    pos, end = 0, len(buf)
    context: Dict[str, FeatureValue] = {}
    feature_lists: Dict[str, List[FeatureValue]] = {}
    while pos < end:
        field, wire, pos = _read_tag(buf, pos)
        if wire != _WIRE_LEN:
            pos = _skip_field(buf, pos, wire)
            continue
        n, pos = _read_varint(buf, pos)
        body = buf[pos : pos + n]
        pos += n
        if field == 1:
            context = _parse_features(body)
        elif field == 2:
            feature_lists = _parse_feature_lists(body, skip_sequence_keys)
    return context, feature_lists


# ---------------------------------------------------------------------------
# Encoding (for the synthetic-data writer and round-trip tests)
# ---------------------------------------------------------------------------

_ONE_BYTE = [bytes((v,)) for v in range(0x80)]


def _varint(v: int) -> bytes:
    if v < 0x80:  # tags and most lengths: one byte, no loop
        return _ONE_BYTE[v]
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, body: bytes) -> bytes:
    return _tag(field, _WIRE_LEN) + _varint(len(body)) + body


def encode_feature(values: FeatureValue) -> bytes:
    """Encode a value list as a Feature message (type inferred)."""
    if len(values) and isinstance(values[0], (bytes, str)):
        body = b"".join(
            _len_field(1, v.encode("utf-8") if isinstance(v, str) else v)
            for v in values
        )
        return _len_field(1, body)
    if len(values) and isinstance(values[0], float):
        packed = struct.pack(f"<{len(values)}f", *values)
        return _len_field(2, _len_field(1, packed))
    # ints (also the representation for an empty list)
    packed = b"".join(_varint(v & ((1 << 64) - 1)) for v in values)
    return _len_field(3, _len_field(1, packed))


def _encode_map_entry(key: str, value: bytes) -> bytes:
    return _len_field(1, key.encode("utf-8")) + _len_field(2, value)


def encode_sequence_example(
    context: Dict[str, FeatureValue],
    feature_lists: Dict[str, List[FeatureValue]],
) -> bytes:
    """Encode (context, feature_lists) as a serialized SequenceExample."""
    ctx_body = b"".join(
        _len_field(1, _encode_map_entry(k, encode_feature(v)))
        for k, v in context.items()
    )
    fl_body = b""
    for k, rows in feature_lists.items():
        flist = b"".join(_len_field(1, encode_feature(row)) for row in rows)
        fl_body += _len_field(1, _encode_map_entry(k, flist))
    return _len_field(1, ctx_body) + _len_field(2, fl_body)
