"""The port's input pipeline for training against the JAX package's.

* ``Prefetcher`` keeps order and items, runs its transform in the worker,
  re-raises a worker error in the consumer (the cases of
  ``tests/test_input_pipeline.py``), stops its worker on ``close()`` and
  keeps order with 16 of them at a short switch interval.
* ``DeviceDataCache``: the epoch's index block equals JAX's
  ``DeviceDataCache.epoch_indices`` for the same split, seed and epochs
  1-3, and the gathered batches equal JAX's gathered batches and the host
  loader's ``_make_batch`` for those indices, array for array (exact).
* The trainer's host mode on the CPU hands out the loader's batches, in
  order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flexdm_tpu.data.pipeline import DeviceDataCache as JaxDeviceDataCache  # noqa: E402
from flexdm_tpu_torch.data import DatasetSpec, split_device_batch  # noqa: E402
from flexdm_tpu_torch.data.pipeline import DeviceDataCache, Prefetcher  # noqa: E402
from flexdm_tpu_torch.train.trainer import HostBatches  # noqa: E402

BATCH = 16


def test_prefetcher_preserves_order_and_items():
    items = list(range(20))
    assert list(Prefetcher(iter(items), depth=3)) == items


def test_prefetcher_transform_runs_in_worker():
    import threading

    seen = []

    def transform(x):
        seen.append(threading.current_thread())
        return x * 10

    assert list(Prefetcher(iter([1, 2, 3]), transform=transform)) == [10, 20,
                                                                      30]
    assert seen and all(t is not threading.current_thread() for t in seen)


def test_prefetcher_propagates_errors():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = iter(Prefetcher(gen()))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_prefetcher_close_stops_an_endless_worker():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    prefetcher = Prefetcher(endless(), depth=2)
    it = iter(prefetcher)
    assert [next(it) for _ in range(5)] == [0, 1, 2, 3, 4]
    prefetcher.close(timeout=5.0)
    assert not prefetcher._thread.is_alive()


def test_prefetchers_under_thread_churn():
    """16 prefetchers (more threads than cores) consumed side by side with
    a short switch interval: each yields its items in order, and every
    worker stops."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        prefetchers = [Prefetcher(iter(range(i, i + 300)), depth=2,
                                  transform=lambda x: x + 1)
                       for i in range(16)]
        iters = [iter(p) for p in prefetchers]
        got = [[] for _ in prefetchers]
        for _ in range(300):
            for out, it in zip(got, iters):
                out.append(next(it))
        for i, (out, it) in enumerate(zip(got, iters)):
            assert out == list(range(i + 1, i + 301))
            assert next(it, None) is None
        for p in prefetchers:
            p._thread.join(timeout=10.0)
            assert not p._thread.is_alive()
    finally:
        sys.setswitchinterval(interval)


@pytest.fixture(scope="module")
def port_loader(crello_dir):
    spec = DatasetSpec("crello", crello_dir, BATCH)
    return spec.make_dataset("train", batch_size=BATCH, shuffle=True,
                             repeat=True, seed=0, drop_remainder=True)


@pytest.fixture(scope="module")
def caches(crello_spec, port_loader):
    jax_loader = crello_spec.make_dataset("train", batch_size=BATCH)
    return JaxDeviceDataCache(jax_loader), DeviceDataCache(port_loader, "cpu")


@pytest.mark.parametrize("epoch", [1, 2, 3])
def test_epoch_batches_match_jax_device_cache(caches, port_loader, epoch):
    """Epoch ``epoch`` (counted from 1, as both trainers pass it): the same
    index block, and each gathered batch equal to JAX's and to the host
    loader's batch of those records."""
    jax_cache, cache = caches
    seed = 3
    want = np.stack(list(jax_cache.epoch_indices(BATCH, seed, epoch)))
    block = cache.epoch_indices(BATCH, seed, epoch)
    assert block.shape == (port_loader.num_records // BATCH, BATCH)
    np.testing.assert_array_equal(block, want)
    for indices in block:
        got = cache.gather(torch.from_numpy(indices))
        jax_batch = {k: np.asarray(v)
                     for k, v in jax_cache.gather(indices).items()}
        host = split_device_batch(port_loader._make_batch(indices))
        assert set(got) == set(jax_batch) == set(host)
        for k in host:
            np.testing.assert_array_equal(got[k].numpy(), host[k], err_msg=k)
            np.testing.assert_array_equal(got[k].numpy(), jax_batch[k],
                                          err_msg=k)


def test_device_cache_keeps_strings_on_the_host(caches, port_loader):
    _, cache = caches
    assert cache.num_records == port_loader.num_records
    record = port_loader._record(0)
    strings = {k for k, v in record.items()
               if isinstance(v, np.ndarray) and v.dtype == object}
    assert strings and not strings & set(cache.data)


def test_host_batches_on_the_cpu_follow_the_loader(crello_dir):
    spec = DatasetSpec("crello", crello_dir, BATCH)

    def loader():
        return spec.make_dataset("train", batch_size=BATCH, shuffle=True,
                                 repeat=True, seed=5, drop_remainder=True)

    host = HostBatches(loader(), "cpu")
    try:
        want = iter(loader())
        for _ in range(2 * (loader().num_records // BATCH) + 1):
            got = next(host)
            expected = split_device_batch(next(want))
            assert set(got) == set(expected)
            for k, v in expected.items():
                np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    finally:
        host.close()
    assert not host._prefetcher._thread.is_alive()
