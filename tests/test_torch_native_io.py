"""The port's native record decoder (``flexdm_tpu_torch/csrc/tfrecord_io.cc``
through ``flexdm_tpu_torch/data/tfrecord.py`` and ``DatasetSpec``): the
counterparts of ``tests/test_native_io.py``, plus the build (g++ at first
use, keyed by the source) and its fallback policy.  The same records go
through the native path, the port's pure-Python path and
``flexdm_tpu.data``; the arrays must be identical (dtype included)."""

import logging
import os
import sys
import threading

import numpy as np
import pytest

from flexdm_tpu import data as jax_data
from flexdm_tpu_torch.data import DatasetSpec, example_proto, tfrecord
from flexdm_tpu_torch.data.pipeline import NUM_VALID_KEY, DeviceDataCache
from flexdm_tpu_torch.ops import _build

pytestmark = pytest.mark.skipif(
    _build.find_cxx() is None, reason="no C++ compiler to build the decoder"
)


@pytest.fixture(autouse=True)
def native_state(monkeypatch):
    """Each test starts from the loaded library; whatever a test does to the
    loader's cache is undone after it."""
    assert tfrecord.native_available()
    monkeypatch.setattr(tfrecord, "_NATIVE_LIB", tfrecord._NATIVE_LIB)
    monkeypatch.setattr(tfrecord, "_NATIVE_TRIED", tfrecord._NATIVE_TRIED)


def _reset_loader():
    tfrecord._NATIVE_TRIED = False
    tfrecord._NATIVE_LIB = None


def _assert_records_equal(got, want, label=""):
    assert set(got) == set(want), label
    for k in want:
        assert got[k].dtype == want[k].dtype, (label, k)
        assert got[k].shape == want[k].shape, (label, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label}:{k}")


def test_native_scan_matches_python(tmp_path):
    path = str(tmp_path / "x.tfrecord")
    payloads = [os.urandom(n) for n in (0, 1, 100, 5000)]
    with tfrecord.RecordWriter(path) as w:
        for p in payloads:
            w.write(p)
    assert tfrecord._scan_records_native(path, True) == payloads
    assert list(tfrecord.iter_records(path, verify_crc=True)) == payloads
    assert tfrecord.read_records(path, verify_crc=True) == payloads
    assert tfrecord.read_records(path, True, native=False) == payloads


def test_native_crc_detects_corruption(tmp_path):
    path = str(tmp_path / "x.tfrecord")
    with tfrecord.RecordWriter(path) as w:
        w.write(b"a" * 100)
    blob = bytearray(open(path, "rb").read())
    blob[30] ^= 0xFF
    bad = str(tmp_path / "bad.tfrecord")
    open(bad, "wb").write(bytes(blob))
    with pytest.raises(IOError):
        tfrecord._scan_records_native(bad, True)
    with pytest.raises(IOError):
        tfrecord.read_records(bad, verify_crc=True)
    with pytest.raises(IOError):
        tfrecord.read_records(bad, verify_crc=True, native=False)
    # Without the check the payload comes back as written to disk.
    assert tfrecord.read_records(bad) == tfrecord.read_records(
        bad, native=False)


def test_native_float_feature_decode():
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(7, 16)).astype(np.float32)
    buf = example_proto.encode_sequence_example(
        {"length": [7]},
        {"emb": [[float(x) for x in r] for r in rows],
         "type": [[b"a"]] * 7},
    )
    out = tfrecord.decode_float_feature(buf, "emb", 10, 16)
    assert out is not None and out.shape == (7, 16)
    np.testing.assert_array_equal(out, rows)
    # absent feature -> zero rows
    assert tfrecord.decode_float_feature(buf, "nope", 10, 16).shape == (0, 16)


def test_native_seq_features_decode_all_kinds():
    """One pass over float and int64 feature lists (negative ints, narrow
    and wide columns, an absent one), against the Python proto codec."""
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(5, 16)).astype(np.float32)
    types = rng.integers(-3, 12, size=(5, 1))
    color = rng.integers(0, 255, size=(5, 3))
    buf = example_proto.encode_sequence_example(
        {"length": [5]},
        {
            "emb": [[float(x) for x in r] for r in emb],
            "type": [[int(v) for v in r] for r in types],
            "color": [[int(v) for v in r] for r in color],
            "uuid": [[b"u%d" % i] for i in range(5)],
        },
    )
    metas = [
        ("emb", "float", 8, 16),
        ("type", "int64", 8, 1),
        ("color", "int64", 8, 3),
        ("missing", "int64", 8, 1),
    ]
    out = tfrecord.make_seq_feature_decoder(metas)(buf)
    _, lists = example_proto.decode_sequence_example(buf)
    for name, want in (("emb", emb), ("type", types), ("color", color)):
        n, arr = out[name]
        assert n == 5 and arr.shape == (8, want.shape[1])
        np.testing.assert_array_equal(arr[:5], want)
        np.testing.assert_array_equal(arr[:5], np.asarray(lists[name]))
        np.testing.assert_array_equal(arr[5:], 0)
    assert out["type"][1].dtype == np.int64
    assert out["emb"][1].dtype == np.float32
    n, arr = out["missing"]
    assert n == 0
    np.testing.assert_array_equal(arr, 0)


@pytest.mark.parametrize("dataset", ["crello", "rico"])
def test_decode_record_native_matches_python_and_jax(dataset, request):
    """Every record of a synthetic split: the port's native decode, its
    pure-Python decode and ``flexdm_tpu.data``'s are the same arrays."""
    data_dir = request.getfixturevalue(f"{dataset}_dir")
    native = DatasetSpec(dataset, data_dir)
    python = DatasetSpec(dataset, data_dir, native=False)
    jax_spec = jax_data.DatasetSpec(dataset, data_dir)
    assert native._native_decoder is not None
    assert native._native_layout is not None
    assert python._native_decoder is None and python._native_layout is None
    payloads = native.make_dataset("test")._payloads
    assert payloads == python.make_dataset("test")._payloads
    assert len(payloads) == 32
    for i, p in enumerate(payloads):
        got = native.decode_record(p)
        _assert_records_equal(got, python.decode_record(p), f"python {i}")
        _assert_records_equal(got, jax_spec.decode_record(p), f"jax {i}")


def test_loader_and_device_cache_same_either_way(crello_dir):
    """The consumers take the native path through ``read_records`` and
    ``decode_record``: the loader's batches and the device cache (on the
    CPU) are the same with and without it."""
    native = DatasetSpec("crello", crello_dir).make_dataset(
        "test", batch_size=12)
    python = DatasetSpec("crello", crello_dir, native=False).make_dataset(
        "test", batch_size=12)
    for a, b in zip(native, python):
        assert a[NUM_VALID_KEY] == b[NUM_VALID_KEY]
        del a[NUM_VALID_KEY], b[NUM_VALID_KEY]
        _assert_records_equal(a, b)
    ca, cb = DeviceDataCache(native, "cpu"), DeviceDataCache(python, "cpu")
    assert set(ca.data) == set(cb.data)
    for k in ca.data:
        assert ca.data[k].dtype == cb.data[k].dtype
        assert ca.data[k].equal(cb.data[k]), k


def test_native_decode_rejects_malformed_rows():
    """Every present row must hold exactly row_size values (TF's
    FixedLenSequenceFeature strictness): a ragged or wrong-typed row
    raises ValueError naming the column, and is never read as data."""
    dec = tfrecord.make_seq_feature_decoder([("type", "int64", 10, 1)])
    with pytest.raises(ValueError, match="'type': row 0 .* 1 int64"):
        dec(example_proto.encode_sequence_example({}, {"type": [[1, 2], [3]]}))

    decf = tfrecord.make_seq_feature_decoder([("emb", "float", 10, 16)])
    with pytest.raises(ValueError, match="'emb': row 1 .* 16 float"):
        decf(example_proto.encode_sequence_example(
            {}, {"emb": [[1.0] * 16, [1.0] * 15]}))
    # wrong-typed row: float data in an int64 column
    with pytest.raises(ValueError, match="row 0"):
        dec(example_proto.encode_sequence_example({}, {"type": [[1.5]]}))
    # absent feature stays a legitimate 0-row decode
    ok = dec(example_proto.encode_sequence_example({}, {"other": [[1]]}))
    assert ok["type"][0] == 0


def test_decode_record_rejects_a_ragged_row(rico_dir):
    """Both paths of ``decode_record`` raise ValueError on a row of the
    wrong width, rather than decode it."""
    bad = example_proto.encode_sequence_example(
        {"length": [1]},
        {"left": [[0.1, 0.2]], "type": [[b"Text"]]},
    )
    for native in (True, False):
        with pytest.raises(ValueError):
            DatasetSpec("rico", rico_dir, native=native).decode_record(bad)


def _ctx_record(feature_body: bytes, key: bytes = b"opt") -> bytes:
    """SequenceExample with one context map entry key -> Feature body."""
    entry = example_proto._len_field(1, key) + example_proto._len_field(
        2, feature_body
    )
    return example_proto._len_field(1, example_proto._len_field(1, entry))


@pytest.mark.parametrize("kind", ["int64", "bytes", "float"])
def test_empty_context_feature_decodes_as_zero_values(kind):
    """Every wire form of a missing optional value (``value {}``, an
    omitted map-entry value, an empty list of any kind) decodes as zero
    values, as the Python parser does; a non-empty wrong-typed list
    raises ValueError naming the feature."""
    dec = tfrecord.make_string_context_decoder([], [("opt", kind, 4)], 4)
    empty_forms = [
        _ctx_record(b""),
        example_proto._len_field(1, example_proto._len_field(
            1, example_proto._len_field(1, b"opt"))),
        _ctx_record(example_proto.encode_feature([])),
        _ctx_record(example_proto._len_field(1, b"")),  # BytesList
        _ctx_record(example_proto._len_field(2, b"")),  # FloatList
        _ctx_record(example_proto._len_field(3, b"")),  # Int64List
    ]
    for buf in empty_forms:
        assert list(dec(buf)["opt"]) == [], buf
        ctx, _ = example_proto.decode_sequence_example(buf)
        assert list(ctx.get("opt", [])) == []
    wrong = [1.5] if kind != "float" else [7]
    with pytest.raises(ValueError, match="'opt'"):
        dec(_ctx_record(example_proto.encode_feature(wrong)))


def test_empty_sequence_feature_list_decodes_as_zero_rows():
    """A FeatureList map entry with its value omitted is 0 rows, in the
    string pass, the numeric pass and the Python parser."""
    buf = example_proto._len_field(
        2, example_proto._len_field(1, example_proto._len_field(1, b"name")),
    )
    assert tfrecord.make_string_context_decoder(
        ["name"], [], 4)(buf)["name"] == []
    assert tfrecord.make_seq_feature_decoder(
        [("name", "int64", 4, 1)])(buf)["name"][0] == 0
    _, lists = example_proto.decode_sequence_example(buf)
    assert list(lists.get("name", [])) == []


def test_native_decoders_survive_corrupt_payloads():
    """Truncated, bit-flipped and spliced payloads raise ValueError or
    IOError, or decode degenerately; the process neither crashes nor
    hangs."""
    rng = np.random.default_rng(0)
    seq_dec = tfrecord.make_seq_feature_decoder(
        [("emb", "float", 8, 16), ("type", "int64", 8, 1)]
    )
    lay_dec = tfrecord.make_string_context_decoder(
        ["name"],
        [("length", "int64", 1), ("id", "bytes", 1), ("w", "float", 2)],
        8,
    )

    def txt(r, k):
        return bytes(r.integers(32, 127, size=int(k), dtype=np.uint8))

    def rand_record(r):
        n = int(r.integers(0, 8))
        return example_proto.encode_sequence_example(
            {"length": [n], "id": [txt(r, r.integers(0, 20))],
             "w": [float(x) for x in r.normal(size=2)]},
            {"emb": [[float(x) for x in r.normal(size=16)]
                     for _ in range(n)],
             "type": [[int(r.integers(0, 10))] for _ in range(n)],
             "name": [[txt(r, r.integers(0, 9))] for _ in range(n)]},
        )

    for _trial in range(60):
        buf = rand_record(rng)
        seq_dec(buf)
        lay_dec(buf)
        for _ in range(6):
            b = bytearray(buf)
            mode = rng.integers(0, 3)
            if mode == 0 and len(b) > 1:  # truncate
                b = b[: int(rng.integers(1, len(b)))]
            elif mode == 1:  # flip bytes
                for _ in range(int(rng.integers(1, 6))):
                    b[int(rng.integers(0, len(b)))] = int(
                        rng.integers(0, 256))
            else:  # splice garbage
                pos = int(rng.integers(0, len(b)))
                b = (b[:pos]
                     + bytes(rng.integers(0, 256, size=10, dtype=np.uint8))
                     + b[pos:])
            for dec in (seq_dec, lay_dec):
                try:
                    dec(bytes(b))
                except (ValueError, IOError):
                    pass


def test_decoder_survives_lib_cache_reset(crello_dir):
    """Decoders bind their argtype-configured function when built: after
    the library cache is reset (a fresh CDLL whose functions have no
    argtypes), the spec's decoders still decode the same arrays."""
    spec = DatasetSpec("crello", crello_dir)
    payload = spec.make_dataset("test")._payloads[0]
    before = spec.decode_record(payload)
    _reset_loader()
    assert tfrecord.native_available()  # a fresh CDLL
    _assert_records_equal(spec.decode_record(payload), before)


def test_concurrent_decode_matches_serial(crello_dir):
    """One spec decodes from two threads at once (the Prefetcher's worker
    and the main thread): the thread-local scratch keeps records apart.
    The interpreter switches threads every microsecond here, and the
    threads call the string/context decoder in a tight loop, so that a
    shared scratch would be overwritten between a call and its read."""
    spec = DatasetSpec("crello", crello_dir)
    payloads = list(spec.make_dataset("test")._payloads)
    layout = spec._native_layout
    serial = [spec.decode_record(p) for p in payloads]
    serial_layout = [layout(p) for p in payloads]
    results = [None] * len(payloads)
    mismatches = []

    def work(indices):
        for _ in range(100):
            for i in indices:
                if layout(payloads[i]) != serial_layout[i]:
                    mismatches.append(i)
        for i in indices:
            results[i] = spec.decode_record(payloads[i])

    threads = [threading.Thread(target=work,
                                args=(range(k, len(payloads), 2),))
               for k in (0, 1)]
    previous = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(previous)
    assert not mismatches
    for i, (s, r) in enumerate(zip(serial, results)):
        _assert_records_equal(r, s, str(i))


def test_decode_parity_randomized_records(crello_dir):
    """Any well-formed record (lengths 0, 1, S and between, negative and
    large ints, every vocabulary token, an optional context value present,
    empty or absent) decodes identically through the native and the
    pure-Python paths, and as ``flexdm_tpu.data`` decodes it."""
    spec_n = DatasetSpec("crello", crello_dir)
    spec_p = DatasetSpec("crello", crello_dir, native=False)
    spec_j = jax_data.DatasetSpec("crello", crello_dir)
    rng = np.random.default_rng(0)
    S = spec_n.max_length

    def tok(name, r):
        ts = [t for t in spec_n.vocabs[name].tokens if t != ""]
        v = ts[int(r.integers(0, len(ts)))]
        return v.encode() if isinstance(v, str) else int(v)

    def rand_payload(r):
        n = int(r.choice([0, 1, S, int(r.integers(0, S + 1))]))
        ctx = {name: [tok(name, r)] for name in (
            "length", "group", "format", "canvas_width", "canvas_height",
            "category")}
        form = r.integers(0, 3)
        if form == 0:
            ctx["id"] = [b"id-x"]
        elif form == 1:
            ctx["id"] = []
        seq = {
            "type": [[tok("type", r)] for _ in range(n)],
            "color": [[int(v) for v in r.integers(-2, 300, size=3)]
                      for _ in range(n)],
            "image_embedding": [[float(x) for x in r.normal(size=512)]
                                for _ in range(n)],
            "text_embedding": [[float(x) for x in r.normal(size=512)]
                               for _ in range(n)],
            "font_family": [[tok("font_family", r)] for _ in range(n)],
            "uuid": [[b"u%04d" % i] for i in range(n)],
        }
        for name in ("left", "top", "width", "height"):
            seq[name] = [[float(x)] for x in r.normal(size=n)]
        seq["opacity"] = [[float(x)] for x in r.uniform(size=n)]
        return example_proto.encode_sequence_example(ctx, seq)

    for t in range(30):
        buf = rand_payload(rng)
        got = spec_n.decode_record(buf)
        _assert_records_equal(got, spec_p.decode_record(buf), f"{t} python")
        _assert_records_equal(got, spec_j.decode_record(buf), f"{t} jax")


def test_host_build_is_keyed_by_its_source(tmp_path):
    """One library per source hash, reused while the source is unchanged;
    an edit builds another next to it."""
    src = tmp_path / "io.cc"
    src.write_text(tfrecord.NATIVE_SOURCE.read_text())
    first = _build.build_host_library("io", src, build_dir=tmp_path / "b")
    stamp = first.stat().st_mtime_ns
    assert _build.build_host_library("io", src, build_dir=tmp_path / "b") \
        == first
    assert first.stat().st_mtime_ns == stamp
    src.write_text(src.read_text() + "\n// edit\n")
    second = _build.build_host_library("io", src, build_dir=tmp_path / "b")
    assert second != first and second.exists()
    assert not list((tmp_path / "b").glob("*.tmp"))


def test_compile_failure_raises_not_falls_back(tmp_path, monkeypatch):
    """A compiler that exists but fails on the source raises with its
    output, on every call; the decoder never drops silently to Python."""
    broken = tmp_path / "tfrecord_io.cc"
    broken.write_text("this is not C++ {\n")
    monkeypatch.setattr(tfrecord, "NATIVE_SOURCE", broken)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _reset_loader()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*error"):
            tfrecord.native_available()
    with pytest.raises(RuntimeError):
        tfrecord.make_seq_feature_decoder([("type", "int64", 4, 1)])
    assert not list((tmp_path / "build").glob("*"))


def test_missing_compiler_takes_the_logged_python_path(
        tmp_path, monkeypatch, caplog, crello_dir):
    """Only a missing compiler takes the pure-Python path: logged once,
    the same records and arrays."""
    monkeypatch.setattr(_build, "find_cxx", lambda: None)
    _reset_loader()
    with caplog.at_level(logging.WARNING, logger=tfrecord.__name__):
        assert not tfrecord.native_available()
        assert not tfrecord.native_available()
        spec = DatasetSpec("crello", crello_dir)
        loader = spec.make_dataset("test")
    warnings = [r for r in caplog.records if "pure-Python" in r.getMessage()]
    assert len(warnings) == 1
    assert spec._native_decoder is None and spec._native_layout is None
    want = jax_data.DatasetSpec("crello", crello_dir)
    for p in loader._payloads[:4]:
        _assert_records_equal(spec.decode_record(p), want.decode_record(p))
