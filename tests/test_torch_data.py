"""The port's data layer (``flexdm_tpu_torch.data``) against the JAX
package's (``flexdm_tpu.data``): for the same seed, the same synthetic files,
schema, batches, documents and device batches, on crello and rico."""

import dataclasses
import os

import numpy as np
import pytest

from flexdm_tpu import data as jax_data
from flexdm_tpu.data import synthetic as jax_synthetic
from flexdm_tpu_torch import data as port_data
from flexdm_tpu_torch.data import synthetic as port_synthetic
from flexdm_tpu_torch.serve import _jsonable

SIZES = {"crello": (10, 4, 5), "rico": (17, 6, 7)}


@pytest.fixture(scope="module", params=sorted(SIZES))
def dirs(request, tmp_path_factory):
    """``(name, JAX package's dir, port's dir)``, each written by its own
    package's ``synthetic.generate`` from seed 3."""
    name = request.param
    root = tmp_path_factory.mktemp(f"data_{name}")
    out = []
    for package in (jax_synthetic, port_synthetic):
        out.append(package.generate(
            name, str(root / package.__name__.split(".")[0]), *SIZES[name],
            seed=3))
    return (name, *out)


def _specs(dirs, batch_size=4):
    name, jax_dir, port_dir = dirs
    return (jax_data.DatasetSpec(name, jax_dir, batch_size),
            port_data.DatasetSpec(name, port_dir, batch_size))


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_synthetic_generate_writes_the_same_files(dirs):
    _, jax_dir, port_dir = dirs
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir))
    assert any(n.endswith(".tfrecord") for n in names)
    for n in names:
        with open(os.path.join(jax_dir, n), "rb") as a, \
                open(os.path.join(port_dir, n), "rb") as b:
            assert a.read() == b.read(), n


def test_schema_matches(dirs):
    jax_spec, port_spec = _specs(dirs)
    assert (dataclasses.asdict(port_spec.schema)
            == dataclasses.asdict(jax_spec.schema))
    assert port_spec.schema.task_names == jax_spec.schema.task_names
    for task in ("elem_pos_attr", "random_elem_pos_attr_img_txt"):
        assert (port_data.make_task_probs(port_spec.schema, task)
                == jax_data.make_task_probs(jax_spec.schema, task))


@pytest.mark.parametrize("split", ["train", "test"])
def test_make_dataset_batches_match(dirs, split):
    """Every batch of a shuffled split (the padded final batch included)
    and its device batch are equal, array for array."""
    jax_spec, port_spec = _specs(dirs)
    kwargs = dict(batch_size=3, shuffle=True, seed=1)
    want = list(jax_spec.make_dataset(split, **kwargs))
    got = list(port_spec.make_dataset(split, verify_crc=True, **kwargs))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
        assert g[port_data.NUM_VALID_KEY] == w[jax_data.NUM_VALID_KEY]
        _assert_batches_equal(port_data.split_device_batch(g),
                              jax_data.split_device_batch(w))


def test_unbatch_and_batch_documents_match(dirs):
    jax_spec, port_spec = _specs(dirs)
    batch = next(iter(jax_spec.make_dataset("test", batch_size=5)))
    want_docs = _jsonable(jax_spec.unbatch(batch))
    got_docs = _jsonable(port_spec.unbatch(batch))
    assert got_docs == want_docs
    _assert_batches_equal(port_spec.batch_documents(got_docs),
                          jax_spec.batch_documents(want_docs))
