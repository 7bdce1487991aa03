"""TFRecord container I/O without TensorFlow.

The port's own copy of ``flexdm_tpu/data/tfrecord.py``.  Record framing
(the on-disk format produced by ``tf.io.TFRecordWriter`` and consumed by
the reference's ``tf.data.TFRecordDataset``, reference
``src/mfp/mfp/data/spec.py:234-237``)::

    uint64 length
    uint32 masked_crc32c(length)
    bytes  data[length]
    uint32 masked_crc32c(data)

CRC-32C (Castagnoli) with TFRecord's mask rotation.

A C++ fast path, the port's copy of the JAX package's decoder
(``flexdm_tpu_torch/csrc/tfrecord_io.cc``), is built with g++ at first use
into ``build/flexdm_tpu_torch/`` (``ops/_build.py``,
:func:`build_host_library`) and loaded with ctypes: it scans a whole file
into offsets in one pass and decodes SequenceExample payloads straight into
numpy buffers (:class:`SeqFeatureDecoder`, :class:`StringContextDecoder`).
Where there is no C++ compiler the pure-Python reader and proto codec are
used instead, with one logged warning; :func:`native_available` says which.
A compiler that fails to compile the source raises: no fallback then.
"""

from __future__ import annotations

import ctypes
import glob as globlib
import logging
import os
import struct
import threading
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

NATIVE_SOURCE = (Path(__file__).resolve().parent.parent / "csrc"
                 / "tfrecord_io.cc")

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


# ---------------------------------------------------------------------------
# Native fast path
# ---------------------------------------------------------------------------

_NATIVE_LIB = None
_NATIVE_TRIED = False
_native_lock = threading.Lock()


def _load_native():
    """The C++ I/O library, built from :data:`NATIVE_SOURCE` on first use;
    None (logged once) where there is no C++ compiler.  A failed compile
    raises with the compiler's output, on this call and on every later
    one."""
    global _NATIVE_LIB, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE_LIB
    from ..ops import _build

    with _native_lock:
        if _NATIVE_TRIED:
            return _NATIVE_LIB
        cxx = _build.find_cxx()
        if cxx is None:
            logger.warning(
                "no C++ compiler ($CXX or g++ on PATH): records are read "
                "and decoded by the pure-Python TFRecord reader and proto "
                "codec, not by %s", NATIVE_SOURCE.name)
            _NATIVE_TRIED = True
            return None
        lib = ctypes.CDLL(str(_build.build_host_library(
            "flexdm_io", NATIVE_SOURCE, cxx=cxx)))
        lib.flexdm_scan_records.restype = ctypes.c_longlong
        lib.flexdm_scan_records.argtypes = [
            ctypes.c_char_p,  # path
            ctypes.POINTER(ctypes.c_longlong),  # out offsets
            ctypes.POINTER(ctypes.c_longlong),  # out lengths
            ctypes.c_longlong,  # capacity
            ctypes.c_int,  # verify crc
        ]
        lib.flexdm_crc32c.restype = ctypes.c_uint
        lib.flexdm_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
        _NATIVE_LIB = lib
        _NATIVE_TRIED = True
        return lib


def native_available() -> bool:
    """Whether the C++ decoder is in use (building it on first call)."""
    return _load_native() is not None


def _scan_records_native(path: str, verify: bool) -> Optional[List[bytes]]:
    lib = _load_native()
    if lib is None:
        return None
    cap = 1 << 20
    offs = (ctypes.c_longlong * cap)()
    lens = (ctypes.c_longlong * cap)()
    n = lib.flexdm_scan_records(
        path.encode(), offs, lens, cap, 1 if verify else 0
    )
    if n < 0:
        raise IOError(f"native TFRecord scan failed for {path} (code {n})")
    with open(path, "rb") as f:
        blob = f.read()
    return [blob[offs[i] : offs[i] + lens[i]] for i in range(n)]


def decode_float_feature(
    payload: bytes, name: str, max_rows: int, row_size: int
) -> Optional[np.ndarray]:
    """Decode a float feature list straight into a numpy array (C++ path).

    Returns ``(n_rows, row_size)`` float32, or None when the native library
    is unavailable (caller falls back to the Python proto decoder).  Every
    present row must hold exactly ``row_size`` values (TF
    ``FixedLenSequenceFeature`` strictness; raises ValueError on ragged or
    wrong-typed rows).
    """
    lib = _load_native()
    if lib is None:
        return None
    if not getattr(lib, "_float_sig_set", False):
        lib.flexdm_decode_float_feature.restype = ctypes.c_longlong
        lib.flexdm_decode_float_feature.argtypes = [
            ctypes.c_char_p,
            ctypes.c_longlong,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
            ctypes.c_longlong,
        ]
        lib._float_sig_set = True
    out = np.zeros((max_rows, row_size), dtype=np.float32)
    n = lib.flexdm_decode_float_feature(
        payload,
        len(payload),
        name.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_rows,
        row_size,
    )
    if n < 0:
        raise ValueError(
            f"malformed feature list {name!r}: row {-n - 1} does not hold "
            f"exactly {row_size} float values"
        )
    return out[: int(n)]


class SeqFeatureDecoder:
    """One-native-pass decoder for a fixed work list of numeric sequence
    feature-lists (C++: ``flexdm_decode_seq_features``).

    ``metas``: sequence of ``(name, kind, max_rows, row_size)`` with kind
    ``'float'`` or ``'int64'``.  The ctypes argument blocks are built once
    here; each call only allocates the output buffers.  Returns ``{name:
    (n_rows, (max_rows, row_size) array)}``.
    """

    def __init__(self, metas, fn):
        # The argtype-configured function object is bound here, once.  If
        # the library cache is reset, a fresh CDLL's functions carry no
        # argtypes, and ctypes would pass the 64-bit counts as 32-bit ints
        # (the C side then loops on a garbage count).
        self._fn = fn
        self.metas = tuple(metas)
        n = len(self.metas)
        self._names = (ctypes.c_char_p * n)(
            *[m[0].encode() for m in self.metas]
        )
        self._kinds = (ctypes.c_ubyte * n)(
            *[1 if m[1] == "float" else 2 for m in self.metas]
        )
        self._max_rows = (ctypes.c_longlong * n)(
            *[m[2] for m in self.metas]
        )
        self._row_sizes = (ctypes.c_longlong * n)(
            *[m[3] for m in self.metas]
        )
        self._dtypes = [
            np.float32 if m[1] == "float" else np.int64 for m in self.metas
        ]

    def __call__(self, payload: bytes) -> dict:
        n = len(self.metas)
        arrays = [
            np.zeros((m[2], m[3]), dtype=dt)
            for m, dt in zip(self.metas, self._dtypes)
        ]
        outs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
        rows_out = (ctypes.c_longlong * n)()
        rc = self._fn(
            payload, len(payload), self._names, self._kinds, n, outs,
            self._max_rows, self._row_sizes, rows_out,
        )
        if rc < 0:
            raise IOError(f"native sequence decode failed (code {rc})")
        out = {}
        for i, m in enumerate(self.metas):
            n_rows = int(rows_out[i])
            if n_rows < 0:
                # Row -(n_rows) - 1 is ragged or wrong-typed: a row must
                # carry exactly row_size values (TF's
                # FixedLenSequenceFeature strictness).
                raise ValueError(
                    f"malformed feature list {m[0]!r}: row {-n_rows - 1} "
                    f"does not hold exactly {m[3]} {m[1]} values"
                )
            out[m[0]] = (n_rows, arrays[i])
        return out


def make_seq_feature_decoder(metas) -> Optional[SeqFeatureDecoder]:
    """A :class:`SeqFeatureDecoder`, or None without the native library
    or with an empty work list."""
    lib = _load_native()
    if lib is None or not metas:
        return None
    if not getattr(lib, "_seq_sig_set", False):
        lib.flexdm_decode_seq_features.restype = ctypes.c_longlong
        lib.flexdm_decode_seq_features.argtypes = [
            ctypes.c_char_p,
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib._seq_sig_set = True
    return SeqFeatureDecoder(metas, lib.flexdm_decode_seq_features)


class StringContextDecoder:
    """One-native-pass decoder for string sequence feature-lists plus all
    context features (C++: ``flexdm_decode_strings_and_context``); with
    :class:`SeqFeatureDecoder` it covers the whole record, so a full decode
    never enters the Python proto parser.

    ``seq_names``: string sequence columns (one bytes value per row).
    ``ctx_metas``: ``(name, kind, cap)`` with kind ``'float'``/``'int64'``/
    ``'bytes'`` and ``cap`` the most values the feature may carry.
    Returns ``{name: [bytes rows]}`` for sequences and ``{name: ndarray or
    [bytes]}`` for context (trimmed to the actual count).  A malformed item
    raises ValueError naming it.
    """

    def __init__(self, seq_names, ctx_metas, max_rows: int, fn):
        self._fn = fn  # bound once; see SeqFeatureDecoder
        self.seq_names = tuple(seq_names)
        self.ctx_metas = tuple(ctx_metas)
        self.max_rows = int(max_rows)
        ns, nc = len(self.seq_names), len(self.ctx_metas)
        self.ctx_cap = max([m[2] for m in self.ctx_metas], default=1)
        self._seq_names_c = (ctypes.c_char_p * ns)(
            *[n.encode() for n in self.seq_names]
        )
        kind_code = {"float": 1, "int64": 2, "bytes": 3}
        self._ctx_names_c = (ctypes.c_char_p * nc)(
            *[m[0].encode() for m in self.ctx_metas]
        )
        self._ctx_kinds_c = (ctypes.c_ubyte * nc)(
            *[kind_code[m[1]] for m in self.ctx_metas]
        )
        # Scratch buffers reused across calls (every output is copied out
        # before returning), held per thread: the Prefetcher's worker and
        # the main thread may decode with one spec at once, and shared
        # scratch would interleave two records' offsets.
        self._local = threading.local()

    def _scratch(self):
        s = getattr(self._local, "s", None)
        if s is None:
            ns, nc = len(self.seq_names), len(self.ctx_metas)
            R, C = self.max_rows, self.ctx_cap

            def ptr(a, t):
                return a.ctypes.data_as(ctypes.POINTER(t))

            seq_rows = (ctypes.c_longlong * max(ns, 1))()
            seq_offs = np.zeros((ns, R), dtype=np.int64)
            seq_lens = np.zeros((ns, R), dtype=np.int64)
            ctx_counts = (ctypes.c_longlong * max(nc, 1))()
            ctx_ints = np.zeros((nc, C), dtype=np.int64)
            ctx_floats = np.zeros((nc, C), dtype=np.float32)
            ctx_offs = np.zeros((nc, C), dtype=np.int64)
            ctx_lens = np.zeros((nc, C), dtype=np.int64)
            args = (
                self._seq_names_c, ns, R, seq_rows,
                ptr(seq_offs, ctypes.c_longlong),
                ptr(seq_lens, ctypes.c_longlong),
                self._ctx_names_c, self._ctx_kinds_c, nc, C, ctx_counts,
                ptr(ctx_ints, ctypes.c_longlong),
                ptr(ctx_floats, ctypes.c_float),
                ptr(ctx_offs, ctypes.c_longlong),
                ptr(ctx_lens, ctypes.c_longlong),
            )
            s = (
                args, seq_rows, seq_offs, seq_lens, ctx_counts,
                ctx_ints, ctx_floats, ctx_offs, ctx_lens,
            )
            self._local.s = s
        return s

    def __call__(self, payload: bytes) -> dict:
        ns = len(self.seq_names)
        (
            args, seq_rows, seq_offs, seq_lens, ctx_counts,
            ctx_ints, ctx_floats, ctx_offs, ctx_lens,
        ) = self._scratch()
        rc = self._fn(payload, len(payload), *args)
        if rc < 0:
            k = -int(rc) - 1
            name = (
                self.seq_names[k] if k < ns
                else self.ctx_metas[k - ns][0]
            )
            raise ValueError(f"malformed feature {name!r} (native decode)")
        out = {}
        for i, name in enumerate(self.seq_names):
            n = int(seq_rows[i])
            out[name] = [
                payload[seq_offs[i, r]: seq_offs[i, r] + seq_lens[i, r]]
                for r in range(n)
            ]
        for j, (name, kind, _cap) in enumerate(self.ctx_metas):
            n = int(ctx_counts[j])
            if kind == "bytes":
                out[name] = [
                    payload[ctx_offs[j, k]: ctx_offs[j, k] + ctx_lens[j, k]]
                    for k in range(n)
                ]
            elif kind == "float":
                out[name] = ctx_floats[j, :n].copy()
            else:
                out[name] = ctx_ints[j, :n].copy()
        return out


def make_string_context_decoder(
    seq_names, ctx_metas, max_rows: int
) -> Optional[StringContextDecoder]:
    """A :class:`StringContextDecoder`, or None without the native library
    or with nothing to decode."""
    lib = _load_native()
    if lib is None or not (seq_names or ctx_metas):
        return None
    if not getattr(lib, "_strctx_sig_set", False):
        LL = ctypes.c_longlong
        lib.flexdm_decode_strings_and_context.restype = LL
        lib.flexdm_decode_strings_and_context.argtypes = [
            ctypes.c_char_p, LL,
            ctypes.POINTER(ctypes.c_char_p), LL, LL,
            ctypes.POINTER(LL), ctypes.POINTER(LL), ctypes.POINTER(LL),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_ubyte),
            LL, LL, ctypes.POINTER(LL),
            ctypes.POINTER(LL), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(LL), ctypes.POINTER(LL),
        ]
        lib._strctx_sig_set = True
    return StringContextDecoder(
        seq_names, ctx_metas, max_rows,
        lib.flexdm_decode_strings_and_context,
    )


# ---------------------------------------------------------------------------
# Reading / writing
# ---------------------------------------------------------------------------

def read_records(path: str, verify_crc: bool = False,
                 native: bool = True) -> List[bytes]:
    """Read every record payload in a TFRecord file: one C++ scan when the
    native library is there (and ``native``), else :func:`iter_records`."""
    if native:
        records = _scan_records_native(path, verify_crc)
        if records is not None:
            return records
    return list(iter_records(path, verify_crc=verify_crc))


def iter_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Iterate record payloads in a TFRecord file (pure Python)."""
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


def _writer_crc(data: bytes) -> int:
    """:func:`masked_crc32c` of ``data``, by the C++ library where it is in
    use: the pure-Python loop, one table lookup a byte, dominates writing a
    crello record (~200 KB)."""
    lib = _load_native()
    if lib is None:
        return masked_crc32c(data)
    return lib.flexdm_crc32c(data, len(data))


class RecordWriter:
    """Write TFRecord files (the synthetic-data generator, the crello
    dataset builder)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _writer_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _writer_crc(data)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def list_shards(data_dir: str, split: str) -> List[str]:
    """Shard files for a split, sorted (reference spec.py:231-233)."""
    return sorted(globlib.glob(os.path.join(data_dir, f"{split}-*.tfrecord")))
