"""The port's data layer on more than one device, against the JAX
package's.

* ``DataLoader(num_hosts, host_id)``: each host's record stride and the
  pre-shard ``global_num_records`` equal JAX's loader's; a rank's rows of
  its host's batch are its rows of the global batch.
* ``DeviceDataCache`` spread over D data ranks: data rank ``d`` holds
  JAX's mesh shard ``d`` (records ``d, d + D, ...``), its gather of local
  indices is bit-exact, and ``epoch_indices`` gives, column block by
  column block, the records JAX's mesh-mode shuffle gives device ``d``,
  each record at most once an epoch; it decodes only its own records, and
  its real rows are bitwise those of a cache stacked from the whole
  split's records (its padding repeats its own last record).
* Evaluation sums on 2 CPU data ranks equal 1 rank's for ``random``,
  ``elem`` and a group task, at a batch that splits (16 rows, 8 a rank)
  and at one that does not (7 rows: every rank takes the whole batch).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flexdm_tpu.data import DataLoader as JaxLoader  # noqa: E402
from flexdm_tpu.data.pipeline import DeviceDataCache as JaxCache  # noqa: E402
from flexdm_tpu.parallel import mesh as jax_mesh  # noqa: E402
from flexdm_tpu_torch.convert import init_params, params_to_jax  # noqa: E402
from flexdm_tpu_torch.data import DatasetSpec  # noqa: E402
from flexdm_tpu_torch.data.pipeline import DataLoader, DeviceDataCache  # noqa: E402
from flexdm_tpu_torch.models import mfp  # noqa: E402
from flexdm_tpu_torch.parallel import mesh  # noqa: E402
from tests import _torch_ranks as ranks  # noqa: E402

SIZES = dict(latent_dim=32, num_blocks=1, num_heads=4)


@pytest.fixture(scope="module")
def port_spec(rico_dir):
    return DatasetSpec("rico", rico_dir, 16)


@pytest.mark.parametrize("num_hosts", [2, 3])
def test_host_strides_match_jax(rico_spec, port_spec, num_hosts):
    for host in range(num_hosts):
        got = DataLoader(port_spec, "train", num_hosts=num_hosts,
                         host_id=host)
        want = JaxLoader(rico_spec, "train", num_hosts=num_hosts,
                         host_id=host)
        assert got.global_num_records == want.global_num_records == 96
        assert got.num_records == want.num_records
        for i in range(got.num_records):
            a, b = got._record(i), want._record(i)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("data_size", [2, 4, 8])
def test_spread_cache_matches_jax_mesh(rico_spec, port_spec, data_size):
    jax_loader = rico_spec.make_dataset("train", batch_size=16)
    port_loader = port_spec.make_dataset("train", batch_size=16)
    jax_cache = JaxCache(jax_loader, mesh=jax_mesh.make_mesh(data_size))
    caches = [DeviceDataCache(port_loader, "cpu", data_size, d)
              for d in range(data_size)]
    k = 16 // data_size
    seen = []
    for epoch in (1, 2):
        want = np.stack(list(jax_cache.epoch_indices(16, 0, epoch)))
        for d, cache in enumerate(caches):
            np.testing.assert_array_equal(cache.local_counts,
                                          jax_cache.local_counts)
            got = cache.epoch_indices(16, 0, epoch)[:, d * k:(d + 1) * k]
            np.testing.assert_array_equal(got, want[:, d * k:(d + 1) * k])
            assert (got < cache.local_counts[d]).all()
            seen.append(got.reshape(-1) * data_size + d)
    for epoch in range(2):  # each record at most once an epoch
        records = np.concatenate(seen[epoch * data_size:
                                      (epoch + 1) * data_size])
        assert len(set(records.tolist())) == len(records) == 96 // 16 * 16


@pytest.mark.parametrize("data_size", [1, 3, 5])
def test_spread_cache_decodes_only_its_records(port_spec, monkeypatch,
                                               data_size):
    """96 records over 5 ranks leave ranks 1-4 a padded slot."""
    decode = port_spec.decode_record
    for d in range(data_size):
        decoded = []
        monkeypatch.setattr(port_spec, "decode_record",
                            lambda p: decoded.append(p) or decode(p))
        loader = port_spec.make_dataset("train", batch_size=16)
        cache = DeviceDataCache(loader, "cpu", data_size, d)
        monkeypatch.undo()
        assert len(decoded) == cache.local_counts[d]
        whole = port_spec.make_dataset("train", batch_size=16)
        n = cache.local_counts[d]
        for k, v in cache.data.items():
            want = np.stack([whole._record(g)[k]
                             for g in range(d, whole.num_records, data_size)])
            np.testing.assert_array_equal(v[:n].numpy(), want, err_msg=k)
            np.testing.assert_array_equal(
                v[n:].numpy(), np.broadcast_to(want[-1], v[n:].shape),
                err_msg=k)
        np.testing.assert_array_equal(
            cache.record_ids[:n], np.arange(d, whole.num_records, data_size))


def test_spread_gather_is_bit_exact(port_spec):
    loader = port_spec.make_dataset("train", batch_size=16)
    rng = np.random.default_rng(0)
    for d in range(3):
        cache = DeviceDataCache(loader, "cpu", 3, d)
        idx = rng.integers(0, cache.local_counts[d], 5)
        batch = cache.gather(torch.from_numpy(idx))
        for row, i in enumerate(idx):
            record = loader._record(int(i) * 3 + d)
            for key, v in batch.items():
                np.testing.assert_array_equal(v[row].numpy(), record[key],
                                              err_msg=key)


def test_eval_sums_on_two_ranks_equal_one(port_spec, rico_dir):
    weights = {k: np.array(v) for k, v in params_to_jax(init_params(
        mfp.MFPModel(port_spec.schema, **SIZES), 0).state_dict()).items()}
    groups = port_spec.schema.attribute_groups
    tasks = [("random", None), ("elem", None), ("pos", ("pos", groups["pos"]))]
    got = mesh.spawn(ranks.eval_worker, 2,
                     (2, rico_dir, "rico", weights, SIZES, tasks, (16, 7)),
                     timeout=ranks.TIMEOUT_S, cpu=True)
    model = ranks.build(port_spec, weights, SIZES)
    for name, group in tasks:
        for b in (16, 7):
            want = ranks.task_sums(
                model, port_spec.make_dataset("test", batch_size=b), name,
                group)
            for rank_sums in got:
                sums = rank_sums[name, b]
                assert set(sums) == set(want)
                for key, v in want.items():
                    np.testing.assert_allclose(sums[key], v, rtol=1e-5,
                                               err_msg=(name, b, key))


@pytest.mark.parametrize("world, model_parallel", [(4, 1), (8, 2)])
def test_host_rows_are_the_global_rows(world, model_parallel):
    """On 2 hosts (nodes under ``torchrun``), each rank's rows of its
    host's half of the global batch are its rows of the global batch."""
    b, hosts = 32, 2
    per_host = world // hosts
    for rank in range(world):
        grid = mesh.Grid(rank, world, model_parallel, torch.device("cpu"),
                         num_hosts=hosts, host_id=rank // per_host)
        local = grid.host_rows(b // hosts)
        offset = grid.host_id * (b // hosts)
        assert slice(local.start + offset, local.stop + offset) == \
            grid.rows(b)
