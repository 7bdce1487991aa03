"""The port's crello dataset builder (``tools/torch_build_crello_dataset.py``,
run with JAX blocked) against the JAX package's
(``tools/build_crello_dataset.py``): the same raw dump gives the same
files, byte for byte, and both packages' ``DatasetSpec`` decode equal
batches from them.  Also the port's ``make_raw_dump``
(``tools/torch_scale_drill.py``) against the JAX drill's, and the native
CRC the port's ``RecordWriter`` uses against the Python one."""

import json
import os

import numpy as np
import pytest

from flexdm_tpu.data import DatasetSpec as JaxSpec
from flexdm_tpu.data import example_proto as jax_proto
from flexdm_tpu.data.crello import Template as JaxTemplate
from flexdm_tpu_torch.data import DatasetSpec as PortSpec
from flexdm_tpu_torch.data import example_proto as port_proto
from flexdm_tpu_torch.data import tfrecord
from flexdm_tpu_torch.data.crello import Template as PortTemplate
from tests.test_converter_and_schema import RAW_TEMPLATE
from tests.test_torch_tools import run_tool
from tools import build_crello_dataset as jax_builder
from tools import scale_drill as jax_drill
from tools import torch_build_crello_dataset as port_builder
from tools import torch_scale_drill as port_drill

SPLITS = ("train", "val", "test")


def _inline(path, n=60):
    """``tests/test_dataset_builder.py``'s dump: RAW_TEMPLATE, 60 ids,
    three fonts."""
    with open(path, "w") as f:
        for i in range(n):
            tpl = json.loads(json.dumps(RAW_TEMPLATE))
            tpl["id"] = f"tpl{i:04d}"
            tpl["group"] = "socialMedia"
            tpl["template"][0]["elements"][1]["font"] = f"Font{i % 3}"
            f.write(json.dumps(tpl) + "\n")


def _drill_dump(path):
    port_drill.make_raw_dump(path, 300, seed=3)


DUMPS = {"inline60": (_inline, ["--shards", "2", "--val-frac", "0.2",
                                "--test-frac", "0.2"]),
         "raw_dump300": (_drill_dump, ["--shards", "8"])}


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.fixture(scope="module", params=sorted(DUMPS))
def built(request, tmp_path_factory):
    make, flags = DUMPS[request.param]
    root = tmp_path_factory.mktemp(request.param)
    raw = str(root / "dump.jsonl")
    make(raw)
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    jax_builder.main(["--input", raw, "--out", jax_dir, *flags])
    proc = run_tool("torch_build_crello_dataset.py", "--input", raw,
                    "--out", port_dir, *flags)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "wrote" in proc.stdout
    return jax_dir, port_dir


def test_builder_output_is_byte_identical(built):
    jax_dir, port_dir = built
    jax_files, port_files = _files(jax_dir), _files(port_dir)
    assert list(port_files) == list(jax_files)
    assert {"count.json", "vocabulary.json"} <= set(port_files)
    for name in jax_files:
        assert port_files[name] == jax_files[name], name
    counts = json.loads(port_files["count.json"])
    assert list(counts) == list(SPLITS) and sum(counts.values()) > 0


def test_both_specs_decode_equal_batches(built):
    _, port_dir = built
    counts = json.load(open(os.path.join(port_dir, "count.json")))
    jax_spec, port_spec = JaxSpec("crello", port_dir, 4), \
        PortSpec("crello", port_dir, 4)
    for split in SPLITS:
        if not counts[split]:
            continue
        want = next(iter(jax_spec.make_dataset(split, batch_size=4)))
        got = next(iter(port_spec.make_dataset(split, batch_size=4)))
        assert set(got) == set(want), split
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
        assert got["left"].shape == (4, 50, 1)
        assert port_spec.unbatch(got) == jax_spec.unbatch(want)


@pytest.mark.parametrize("docs, seed", [(300, 0), (57, 7)])
def test_make_raw_dump_is_the_jax_drills(tmp_path, docs, seed):
    jax_drill.make_raw_dump(str(tmp_path / "jax.jsonl"), docs, seed)
    port_drill.make_raw_dump(str(tmp_path / "port.jsonl"), docs, seed)
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "jax.jsonl").read_bytes()


def test_template_to_example_and_helpers(tmp_path):
    raw = str(tmp_path / "dump.jsonl")
    port_drill.make_raw_dump(raw, 40, seed=1)
    for jax_tpl, port_tpl in zip(JaxTemplate.load(raw),
                                 PortTemplate.load(raw)):
        want = jax_builder.template_to_example(jax_tpl)
        got = port_builder.template_to_example(port_tpl)
        assert got == want
        assert port_proto.encode_sequence_example(
            got["context"], got["feature_lists"]) == \
            jax_proto.encode_sequence_example(want["context"],
                                              want["feature_lists"])
    assert port_builder.template_to_example(
        PortTemplate.from_dict(dict(RAW_TEMPLATE, width=0))) is None
    for value in ("#ff0080", [1, 2, 3], {"r": 9, "g": 8, "b": 7}, None,
                  "junk", "#zzzzzz", (4, 5, 6, 7)):
        assert port_builder._parse_color(value) == \
            jax_builder._parse_color(value)
    for i in range(200):
        for fracs in ((0.05, 0.05), (0.2, 0.2)):
            assert port_builder.assign_split(f"d{i}", *fracs) == \
                jax_builder.assign_split(f"d{i}", *fracs)
    assert (port_builder.MAX_ELEMENTS, port_builder.EMB_DIM) == \
        (jax_builder.MAX_ELEMENTS, jax_builder.EMB_DIM)


def test_writer_crc_and_varint_match_the_python_codec():
    assert tfrecord.native_available()  # g++ is here: the C++ CRC runs
    rng = np.random.default_rng(0)
    for n in (0, 1, 8, 31, 4096, 20000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tfrecord._writer_crc(data) == tfrecord.masked_crc32c(data)
    for v in (0, 1, 127, 128, 255, 300, 2 ** 21, 2 ** 63, 2 ** 64 - 1):
        assert port_proto._varint(v) == jax_proto._varint(v)
