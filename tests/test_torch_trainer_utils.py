"""The port's TensorBoard writer and profiling helpers against the JAX
package's (``flexdm_tpu/utils/tboard.py``, ``flexdm_tpu/utils/profiling.py``).

* Event records byte-equal to the JAX writer's for the same scalars and
  wall time, one by one and as whole files (clock and host name fixed).
* ``analytic_train_flops`` equal to JAX's for each preset in ``configs/``.
* ``mfu`` against the H100's dense bf16 peak (989.4 TFLOP/s), not the
  TPU's.
* The trainer's TensorBoard scalars per epoch and at the end, and
  ``enable_profile``'s trace in ``logs/trace``, on the CPU.
"""

import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")

from flexdm_tpu.data import DatasetSpec as JaxDatasetSpec  # noqa: E402
from flexdm_tpu.utils import profiling as jax_profiling  # noqa: E402
from flexdm_tpu.utils import tboard as jax_tboard  # noqa: E402
from flexdm_tpu_torch.config import TrainConfig  # noqa: E402
from flexdm_tpu_torch.data import DatasetSpec  # noqa: E402
from flexdm_tpu_torch.train import trainer as port_trainer  # noqa: E402
from flexdm_tpu_torch.utils import profiling, tboard  # noqa: E402

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
SCALARS = [
    (0, {"loss": 3.25, "val_total_score": 0.5}),
    (7, {"loss": 1.5, "checkpointed": True, "big": 1e30, "neg": -2.0}),
    (2**40, {"unicode_tag_é": 0.125}),
]


@pytest.mark.parametrize("step,scalars", SCALARS)
def test_scalar_event_is_byte_equal_to_jax(step, scalars):
    for wall_time in (1234.5, 1.7e9 + 0.25):
        assert (tboard.encode_scalar_event(step, scalars, wall_time)
                == jax_tboard.encode_scalar_event(step, scalars, wall_time))


def test_event_file_is_byte_equal_to_jax(tmp_path, monkeypatch):
    files = {}
    for name, module in (("jax", jax_tboard), ("port", tboard)):
        monkeypatch.setattr(module.time, "time", lambda: 1700000000.5)
        monkeypatch.setattr(module.socket, "gethostname", lambda: "host")
        log_dir = tmp_path / name
        writer = module.SummaryWriter(str(log_dir))
        for step, scalars in SCALARS:
            writer.scalars(step, {**scalars, "skipped": float("nan"),
                                  "text": "not a number"})
        writer.close()
        (path,) = glob.glob(str(log_dir / "events.out.tfevents.*"))
        with open(path, "rb") as f:
            files[name] = (os.path.basename(path), f.read())
    assert files["port"] == files["jax"]


def _preset(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p)[:-5] for p in glob.glob(os.path.join(CONFIGS,
                                                             "*.json"))))
def test_analytic_train_flops_matches_jax(request, name):
    preset = _preset(name)
    data_dir = request.getfixturevalue(f"{preset['dataset_name']}_dir")
    kwargs = dict(batch_size=preset["batch_size"],
                  latent_dim=preset["latent_dim"],
                  num_blocks=preset["num_blocks"],
                  seq_type=preset.get("seq_type", "default"),
                  context=preset.get("context"))
    got = profiling.analytic_train_flops(
        DatasetSpec(preset["dataset_name"], data_dir).schema, **kwargs)
    want = jax_profiling.analytic_train_flops(
        JaxDatasetSpec(preset["dataset_name"], data_dir).schema, **kwargs)
    assert got == want > 0


def test_mfu_uses_the_h100_peak():
    assert profiling.H100_BF16_PEAK_FLOPS == 989.4e12
    assert profiling.mfu(989.4e12, 0.5) == 50.0
    assert profiling.mfu(989.4e12, 1.0, num_chips=4) == 25.0
    tpu = jax_profiling.mfu(989.4e12, 0.5)
    assert tpu == pytest.approx(50.0 * 989.4 / 197.3)


def test_step_timer_counts_items(monkeypatch):
    clock = iter([10.0, 12.0, 12.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(items_per_step=256)
    timer.tick(3)
    assert timer.steps_per_sec == 1.5
    assert timer.items_per_sec == 384.0


def test_trainer_writes_scalars_and_a_trace(crello_dir, tmp_path):
    """2 epochs with ``enable_profile``: one scalar event per epoch (the
    history record but epoch and step), one of the test metrics, and a
    Chrome trace in ``logs/trace``."""
    job = str(tmp_path / "job")
    results = port_trainer.train(TrainConfig(
        dataset_name="crello", data_dir=crello_dir, job_dir=job,
        latent_dim=16, num_blocks=1, num_heads=2, batch_size=32,
        num_epochs=2, validation_freq=1, device="cpu", enable_profile=True))
    (path,) = glob.glob(os.path.join(job, "logs", "events.out.tfevents.*"))
    events = _read_events(path)
    assert [e["step"] for e in events] == [3, 6, 6]
    for event, record in zip(events, results["history"]):
        want = {k: float(v) for k, v in record.items()
                if k not in ("epoch", "step")}
        assert event["scalars"].keys() == want.keys()
        for k, v in want.items():
            assert event["scalars"][k] == pytest.approx(v, rel=1e-6)
    assert events[-1]["scalars"] == pytest.approx(
        {f"test_{k}": v for k, v in results["test_metrics"].items()},
        rel=1e-6)
    traces = glob.glob(os.path.join(job, "logs", "trace", "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("addmm" in n or "linear" in n for n in names)


def _read_events(path):
    """The scalar events of an event file: ``[{"step", "scalars"}]``
    (a decoder for the three message types the writer emits)."""
    import struct

    from flexdm_tpu_torch.data.example_proto import _read_varint

    with open(path, "rb") as f:
        blob = f.read()
    records, pos = [], 0
    while pos < len(blob):
        (n,) = struct.unpack("<Q", blob[pos:pos + 8])
        records.append(blob[pos + 12:pos + 12 + n])
        pos += 12 + n + 4

    def fields(buf):
        pos = 0
        while pos < len(buf):
            key, pos = _read_varint(buf, pos)
            field, wire = key >> 3, key & 7
            if wire == 0:
                value, pos = _read_varint(buf, pos)
            elif wire == 1:
                value, pos = buf[pos:pos + 8], pos + 8
            elif wire == 5:
                value, pos = buf[pos:pos + 4], pos + 4
            else:
                n, pos = _read_varint(buf, pos)
                value, pos = buf[pos:pos + n], pos + n
            yield field, value

    events = []
    for record in records[1:]:  # the first is the file version
        event = dict(fields(record))
        scalars = {}
        for field, value in fields(event[5]):
            v = dict(fields(value))
            scalars[v[1].decode()] = struct.unpack("<f", v[2])[0]
        events.append({"step": event[2], "scalars": scalars})
    return events
