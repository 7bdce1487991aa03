"""The port's device-resident evaluation against the JAX package's.

The same weights (``model_pair``: crello, latent 32, 1 block, 4 heads;
AutoReg at D=16) and the same synthetic split go through JAX's resident
``evaluate_task`` (its ``lax.scan`` over a ``DeviceDataCache``, on the
CPU) and the port's resident path (a loop over the port's cache's index
blocks).  Tolerances:

* scores within ``SCORE_ATOL`` = 1e-5 abs of JAX's for every attribute
  group, ``elem``, ``random`` (JAX's own draws through ``uniforms_fn``),
  rico ``pos`` sorted, MaskGIT (``num_iter=3``) and AutoReg ``elem``;
* the port's resident sums within 2e-5 relative of its streaming sums
  (``resident=False``) at another batch size, the bar JAX holds its own
  two paths to (``tests/test_data_sharding.py``);
* the index blocks equal, rank by rank, JAX's device-aligned blocks of
  the mesh of the same size, and the ``elem`` blocks hold every real
  (record, element) pair exactly once, at D = 1, 2 and 4;
* one host fetch a task, one cache (each record decoded once) a run of
  ``evaluate_all``, and on 2 CPU data ranks (gloo) the scores of the run
  alone within 1e-5 relative, each rank decoding only its own records.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from flexdm_tpu.data import DatasetSpec as JaxSpec  # noqa: E402
from flexdm_tpu.data.pipeline import DeviceDataCache as JaxCache  # noqa: E402
from flexdm_tpu.evaluation import harness as jax_harness  # noqa: E402
from flexdm_tpu.models.baselines import AutoReg as JaxAutoReg  # noqa: E402
from flexdm_tpu.parallel import mesh as jax_mesh  # noqa: E402
from flexdm_tpu_torch.convert import init_params, params_to_jax  # noqa: E402
from flexdm_tpu_torch.data import DatasetSpec as PortSpec  # noqa: E402
from flexdm_tpu_torch.data.pipeline import DeviceDataCache  # noqa: E402
from flexdm_tpu_torch.evaluation import harness  # noqa: E402
from flexdm_tpu_torch.models import baselines as port_baselines  # noqa: E402
from flexdm_tpu_torch.models import mfp  # noqa: E402
from flexdm_tpu_torch.parallel import mesh  # noqa: E402
from tests import _torch_ranks as ranks  # noqa: E402
from tests._torch_baselines import _unflatten  # noqa: E402
from tests._torch_parity import model_pair, numpy_batch  # noqa: E402
from tests.test_torch_eval import _jax_uniforms  # noqa: E402

SCORE_ATOL = 1e-5
PATHS_RTOL = 2e-5
GROUPS = ("pos", "attr", "img", "txt", "type")


def _group(schema, task_mode):
    groups = schema.attribute_groups
    return (task_mode, groups[task_mode]) if task_mode in groups else None


def _both(jax_spec, port_spec, jax_model, params, port_model, task_mode,
          batch_size=8, port_kwargs=None, **kwargs):
    """JAX's and the port's resident ``evaluate_task`` over the test
    split."""
    group = _group(jax_spec.schema, task_mode)
    want = jax_harness.evaluate_task(
        jax_model, params, jax_spec.make_dataset("test", batch_size=batch_size),
        task_mode, group, resident=True, **kwargs)
    got = harness.evaluate_task(
        port_model, port_spec.make_dataset("test", batch_size=batch_size),
        task_mode, group, resident=True, **kwargs, **(port_kwargs or {}))
    assert want and set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=SCORE_ATOL,
                                   err_msg=k)
    return got


@pytest.fixture(scope="module")
def crello(crello_spec, crello_dir):
    port_spec = PortSpec("crello", crello_dir, 8)
    models = model_pair(crello_spec.schema, numpy_batch(crello_spec, 4),
                        num_blocks=1)
    return (crello_spec, port_spec) + models


@pytest.mark.parametrize("task_mode", GROUPS + ("elem",))
def test_resident_matches_jax(crello, task_mode):
    _both(*crello, task_mode)


def test_resident_random_with_jax_draws_matches_jax(crello):
    _both(*crello, "random", seed=3,
          port_kwargs={"uniforms_fn": _jax_uniforms})


def test_resident_maskgit_matches_jax(crello):
    _both(*crello, "pos", num_iter=3)


def test_resident_rico_pos_sorted_matches_jax(rico_spec, rico_dir):
    assert rico_spec.schema.sort_pos
    models = model_pair(rico_spec.schema, numpy_batch(rico_spec, 4),
                        num_blocks=1)
    _both(rico_spec, PortSpec("rico", rico_dir, 8), *models, "pos")


def test_resident_autoreg_elem_matches_jax(crello_dir):
    """The queried element moved last on the gathered chunk
    (flexdm_tpu/evaluation/harness.py:440-455)."""
    jax_spec = JaxSpec("crello", crello_dir, 8)
    sizes = dict(latent_dim=16, num_blocks=1, num_heads=2)
    port = init_params(port_baselines.AutoReg(jax_spec.schema, **sizes),
                       0).eval()
    params = {"params": _unflatten({
        k: jnp.asarray(v)
        for k, v in params_to_jax(port.state_dict()).items()})}
    model = JaxAutoReg(schema=jax_spec.schema, attention_impl="xla", **sizes)
    _both(jax_spec, PortSpec("crello", crello_dir, 8), model, params, port,
          "elem", elem_chunk=64)


@pytest.mark.parametrize("task_mode", ["pos", "txt", "elem", "random"])
def test_resident_matches_streaming(crello, task_mode):
    """The two paths' sums at batches 8 (resident) and 5 (streaming,
    whose last batch is padded)."""
    _, port_spec, _, _, model = crello
    group = _group(port_spec.schema, task_mode)
    resident = harness.task_sums(
        model, port_spec.make_dataset("test", batch_size=8), task_mode,
        group, seed=4, elem_chunk=24, resident=True)
    streaming = harness.task_sums(
        model, port_spec.make_dataset("test", batch_size=5), task_mode,
        group, seed=4, elem_chunk=24, resident=False)
    assert resident and set(resident) == set(streaming)
    assert any(v > 0 for v in resident.values())
    for k in resident:
        np.testing.assert_allclose(resident[k], streaming[k],
                                   rtol=PATHS_RTOL, err_msg=k)


def _caches(port_spec, jax_spec, data_size, batch_size=16):
    """Every data rank's cache of the port, and JAX's cache on a mesh of
    ``data_size`` devices (no mesh at 1)."""
    loader = port_spec.make_dataset("test", batch_size=batch_size)
    port = [DeviceDataCache(loader, "cpu", data_size, d)
            for d in range(data_size)]
    jax_loader = jax_spec.make_dataset("test", batch_size=batch_size)
    want = JaxCache(jax_loader, mesh=jax_mesh.make_mesh(data_size)
                    if data_size > 1 else None)
    return port, want, jax_loader


@pytest.mark.parametrize("data_size", [1, 2, 4])
def test_eval_blocks_are_jax_columns(rico_spec, rico_dir, data_size):
    """Rank ``d``'s ``(blk, w)`` are columns ``[d k, (d+1) k)`` of JAX's
    blocks; ``gid`` is the global id of the record each slot holds."""
    port, want, _ = _caches(PortSpec("rico", rico_dir), rico_spec, data_size)
    chunk = 8
    k = chunk // data_size
    blk, w = want.eval_index_blocks(chunk)
    seen = []
    for d, cache in enumerate(port):
        got_blk, got_w, gid = cache.eval_index_blocks(chunk)
        np.testing.assert_array_equal(got_blk, blk[:, d * k:(d + 1) * k])
        np.testing.assert_array_equal(got_w, w[:, d * k:(d + 1) * k])
        real = got_w > 0
        np.testing.assert_array_equal(gid[real],
                                      got_blk[real] * data_size + d)
        seen.extend(gid[real].tolist())
    assert sorted(seen) == list(range(port[0].num_records))


@pytest.mark.parametrize("data_size", [1, 2, 4])
def test_elem_blocks_enumerate_exactly_real_elements(rico_spec, rico_dir,
                                                     data_size):
    """Every real (record, element) pair exactly once (``length`` is
    zero-based: L + 1 real elements), nothing else weighted; rank ``d``'s
    blocks are the first rows of its columns of JAX's, whose other rows
    weigh nothing (``tests/test_data_sharding.py``'s test, per rank)."""
    port, want, jax_loader = _caches(PortSpec("rico", rico_dir), rico_spec,
                                     data_size)
    S = rico_spec.schema.max_length
    chunk = 16
    k = chunk // data_size
    doc, elem, w = want.elem_index_blocks(chunk, S)
    seen = set()
    for d, cache in enumerate(port):
        got = cache.elem_index_blocks(chunk, S)
        T = got[0].shape[0]
        for a, b in zip(got, (doc, elem, w)):
            np.testing.assert_array_equal(a, b[:T, d * k:(d + 1) * k])
        assert not w[T:, d * k:(d + 1) * k].any()
        g_doc, g_elem, g_w = got
        for t, row in zip(*np.nonzero(g_w)):
            g = int(cache.record_ids[g_doc[t, row]])
            pair = (g, int(g_elem[t, row]))
            assert pair not in seen
            seen.add(pair)
    expected = {(g, e) for g in range(jax_loader.num_records)
                for e in range(min(int(np.asarray(
                    jax_loader._record(g)["length"]).reshape(-1)[0]) + 1,
                    S))}
    assert seen == expected


@pytest.mark.parametrize("task_mode", ["pos", "elem", "random"])
def test_one_host_fetch_per_task(crello, monkeypatch, task_mode):
    """The resident task fetches its sums once: no ``.tolist()``,
    ``.item()`` or conversion to a Python number inside its loop."""
    _, port_spec, _, _, model = crello
    loader = port_spec.make_dataset("test", batch_size=8)
    cache = harness._make_cache(loader, "cpu")
    fetches = []
    for name in ("tolist", "item", "__float__", "__int__", "__bool__"):
        real = getattr(torch.Tensor, name)

        def spy(self, *args, _real=real, _name=name):
            fetches.append(_name)
            return _real(self, *args)

        monkeypatch.setattr(torch.Tensor, name, spy)
    sums = harness.task_sums(model, loader, task_mode,
                             _group(port_spec.schema, task_mode),
                             elem_chunk=16, cache=cache)
    monkeypatch.undo()
    assert sums and fetches == ["tolist"]
    blocks = (cache.elem_index_blocks(16, port_spec.schema.max_length)
              if task_mode == "elem" else cache.eval_index_blocks(8))
    assert blocks[0].shape[0] > 1  # more than one forward, one fetch


def test_evaluate_all_builds_one_cache(crello, monkeypatch, caplog):
    """``all_feat``'s four tasks share one cache: one build, each record
    decoded once, every task logged as resident."""
    _, port_spec, _, _, model = crello
    built = []

    class Counted(DeviceDataCache):
        def __init__(self, *args, **kwargs):
            built.append(self)
            super().__init__(*args, **kwargs)

    decode = port_spec.decode_record
    decoded = []
    monkeypatch.setattr(harness, "DeviceDataCache", Counted)
    monkeypatch.setattr(port_spec, "decode_record",
                        lambda p: decoded.append(p) or decode(p))
    with caplog.at_level(logging.INFO, logger=harness.__name__):
        scores = harness.evaluate_all(model, port_spec, "all_feat",
                                      batch_size=8)
    assert set(scores) == {"pos", "attr", "img", "txt"}
    assert len(built) == 1
    assert len(decoded) == built[0].num_records == 32
    resident = [r for r in caplog.records if "resident" in r.getMessage()]
    assert len(resident) == 4


def test_dispatch_follows_jax_rule(crello, monkeypatch):
    """Resident by default or with a cache; streaming when asked to, over
    ``RESIDENT_BYTE_LIMIT`` or over more than one node."""
    _, port_spec, _, _, _ = crello
    loader = port_spec.make_dataset("test", batch_size=8)
    assert not harness._streams(loader, None, None, None)
    assert harness._streams(loader, False, None, None)
    two_nodes = mesh.Grid(0, 2, 1, torch.device("cpu"), num_hosts=2)
    assert harness._streams(loader, None, None, two_nodes)
    monkeypatch.setattr(harness, "RESIDENT_BYTE_LIMIT", 1000)
    assert harness._streams(loader, None, None, None)
    assert not harness._streams(loader, None, object(), None)


def test_two_data_ranks_resident_equal_alone(rico_dir):
    """``evaluate_all`` on 2 CPU data ranks through the spread cache: the
    scores alone, each rank decoding only its own records."""
    spec = PortSpec("rico", rico_dir, 16)
    sizes = dict(latent_dim=32, num_blocks=1, num_heads=4)
    weights = {k: np.array(v) for k, v in params_to_jax(init_params(
        mfp.MFPModel(spec.schema, **sizes), 0).state_dict()).items()}
    modes = ("all_feat", "elem", "random")
    got = mesh.spawn(ranks.evaluate_all_worker, 2,
                     (2, rico_dir, "rico", weights, sizes, modes, 7),
                     timeout=ranks.TIMEOUT_S, cpu=True)
    model = ranks.build(spec, weights, sizes)
    n = spec.make_dataset("test").num_records
    for i, mode in enumerate(modes):
        want = harness.evaluate_all(model, spec, mode, batch_size=7)
        for d, rank in enumerate(got):
            scores, decoded = rank[i]
            assert decoded == len(range(d, n, 2))
            assert set(scores) == set(want)
            for group, fields in want.items():
                for k, v in fields.items():
                    np.testing.assert_allclose(scores[group][k], v,
                                               rtol=1e-5,
                                               err_msg=(mode, group, k))
