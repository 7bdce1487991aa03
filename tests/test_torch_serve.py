"""The port's serving path: engine parity with the JAX engine on an
exported job, chunking/fields/warmup, the HTTP server, request coalescing,
and a run with JAX blocked from import."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from flexdm_tpu.serve import InferenceEngine as JaxEngine  # noqa: E402
from flexdm_tpu_torch.serve import (  # noqa: E402
    CoalescingEngine,
    InferenceEngine,
    _jsonable,
    serve,
)
from tests._torch_parity import numpy_batch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def job(rico_dir, tmp_path_factory):
    """A JAX job (random weights, id context) exported for the port."""
    import jax

    from flexdm_tpu.data import DatasetSpec
    from flexdm_tpu.train import checkpoint as ckpt_lib
    from flexdm_tpu.train.trainer import TrainConfig, build_model, init_params
    from tools.export_torch_weights import export

    job_dir = str(tmp_path_factory.mktemp("torch_serve_job"))
    config = TrainConfig(
        dataset_name="rico", data_dir=rico_dir, latent_dim=32, num_blocks=2,
        num_heads=4, context="id", attention_impl="xla",
    )
    spec = DatasetSpec("rico", rico_dir, batch_size=2)
    model, sample = build_model(config, spec.schema), numpy_batch(spec, 2)
    params = jax.jit(lambda: init_params(model, sample, seed=0))()
    ckpt_lib.save_checkpoint(
        os.path.join(job_dir, "checkpoints", "best"), params
    )
    with open(os.path.join(job_dir, "args.json"), "w") as f:
        json.dump(config.to_json(), f)
    export(job_dir, "best")
    return job_dir


@pytest.fixture(scope="module")
def docs(rico_spec):
    batch = next(iter(rico_spec.make_dataset("test", batch_size=3)))
    return _jsonable(rico_spec.unbatch(batch))


@pytest.fixture(scope="module")
def engine(job):
    return InferenceEngine(job, batch_size=4, device="cpu")


@pytest.mark.parametrize("request_args", [
    {"task": "pos"},
    {"task": "elem", "element": 0},
    {"task": "elem", "element": [1, 0, 1], "fields": "changed"},
], ids=["pos", "elem-pinned", "elem-pinned-changed"])
def test_engine_matches_jax_engine(job, engine, docs, request_args):
    assert all(len(d["elements"]) >= 2 for d in docs)
    want = JaxEngine(job, batch_size=4).predict(docs, **request_args)
    assert engine.predict(docs, **request_args) == want


@pytest.mark.parametrize("request_args", [
    {"task": "pos", "num_iter": 2},
    {"task": "attr", "num_iter": 3},
    {"task": "elem", "element": 1, "num_iter": 3, "fields": "changed"},
], ids=["pos-2", "attr-3", "elem-pinned-3"])
def test_engine_maskgit_matches_jax_engine(job, engine, docs, request_args):
    """MaskGIT requests: the same documents as the JAX engine's, and
    ``num_iter`` below 2 is one pass."""
    want = JaxEngine(job, batch_size=4).predict(docs, **request_args)
    assert engine.predict(docs, **request_args) == want
    one_pass = dict(request_args, num_iter=1)
    assert (engine.predict(docs, **dict(request_args, num_iter=0))
            == engine.predict(docs, **one_pass))


def test_engine_chunks_fields_and_rejects(engine, docs):
    nine = (docs * 3)[:9]
    full = engine.predict(nine, task="pos")
    assert len(full) == 9
    assert full[:3] == engine.predict(docs, task="pos")
    for doc, pred in zip(nine, full):
        assert len(pred["elements"]) == len(doc["elements"])
        for el_in, el_out in zip(doc["elements"], pred["elements"]):
            assert el_out["type"] == el_in["type"]  # out of group: echoed
    thin = engine.predict(docs, task="pos", fields="changed")
    for f, t in zip(full, thin):
        for el_f, el_t in zip(f["elements"], t["elements"]):
            assert set(el_t) == {"left", "top", "width", "height"}
            assert all(el_t[k] == el_f[k] for k in el_t)
    pinned = engine.predict(docs, task="elem", element=1, seed=3)
    for doc, pred in zip(docs, pinned):
        for i, (el_in, el_out) in enumerate(
                zip(doc["elements"], pred["elements"])):
            if i != 1:
                assert el_out == el_in
    assert engine.predict(docs, task="elem", element=1, seed=9) == pinned
    bad = [
        dict(task="nope"), dict(fields="nope"), dict(num_iter=2.5),
        dict(task="pos", element=0), dict(task="elem", element=[0]),
        dict(task="elem", element=99), dict(task="elem", element=1.5),
        dict(seed=-1),
    ]
    for kwargs in bad:
        with pytest.raises(ValueError):
            engine.predict(docs, **kwargs)
    assert engine.predict([], task="pos") == []


def test_jsonable_decodes_bytes_arrays():
    """Object and bytes-dtype arrays go element by element, so bytes come
    back decoded; numeric arrays take the tolist() path."""
    import numpy as np

    assert _jsonable(np.array([b"ab", b"c"], dtype="S2")) == ["ab", "c"]
    assert _jsonable(np.array([b"x", "y"], dtype=object)) == ["x", "y"]
    assert _jsonable({"a": np.arange(3, dtype=np.int32),
                      "b": np.float32(0.5)}) == {"a": [0, 1, 2], "b": 0.5}
    json.dumps(_jsonable(np.array([[b"q"]], dtype="S1")))


def test_engine_warmup(engine):
    timings = engine.warmup([("pos", 1), ("elem", 1), ("nope", 1),
                             ("pos", 3)])
    assert set(timings) == {"pos/1", "elem/1", "elem/1/pinned", "pos/3"}
    assert engine.warmup(split="no_such_split") == {}


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)


def test_http_round_trip(engine, docs):
    server = serve(CoalescingEngine(engine, window_ms=1.0), port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.load(r) == {"status": "ok"}
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/schema", timeout=30) as r:
            info = json.load(r)
        assert info["dataset"] == "rico" and "pos" in info["tasks"]
        out = _post(port, {"task": "pos", "documents": docs})
        assert out["predictions"] == engine.predict(docs, task="pos")
        out = _post(port, {"task": "pos", "documents": docs, "num_iter": 3})
        assert out["predictions"] == engine.predict(docs, task="pos",
                                                    num_iter=3)
        for payload in ({"task": "pos", "documents": docs, "num_iter": 2.5},
                        {"task": "elem", "documents": docs, "element": 2.5},
                        {"task": "nope", "documents": docs}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(port, payload)
            assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()


def _run_concurrently(calls):
    outcomes = {}

    def worker(name, fn):
        try:
            outcomes[name] = ("ok", fn())
        except Exception as e:
            outcomes[name] = ("err", e)

    threads = [threading.Thread(target=worker, args=item)
               for item in calls.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a request hung"
    return outcomes


def test_coalescing_merges_and_matches_solo(engine, docs, monkeypatch):
    solo = [engine.predict([d], task="pos") for d in docs]
    calls = []
    real_predict = engine.predict

    def counting_predict(documents, *args, **kwargs):
        calls.append(len(documents))
        return real_predict(documents, *args, **kwargs)

    monkeypatch.setattr(engine, "predict", counting_predict)
    coalescing = CoalescingEngine(engine, window_ms=500.0)
    outcomes = _run_concurrently({
        i: (lambda i=i: coalescing.predict([docs[i]], task="pos"))
        for i in range(3)
    })
    assert sum(calls) == 3 and len(calls) < 3, calls
    for i in range(3):
        assert outcomes[i] == ("ok", solo[i])


def test_coalescing_under_thread_stress(engine, docs):
    """More client threads than cores, a short switch interval: every
    request still gets exactly its own document back."""
    solo = [engine.predict([d], task="pos") for d in docs]
    coalescing = CoalescingEngine(engine, window_ms=20.0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        outcomes = _run_concurrently({
            i: (lambda i=i: coalescing.predict([docs[i % 3]], task="pos"))
            for i in range(4 * (os.cpu_count() or 1) + 2)
        })
    finally:
        sys.setswitchinterval(interval)
    for i, outcome in outcomes.items():
        assert outcome == ("ok", solo[i % 3]), i


def test_coalescing_rejects_malformed_element_without_hanging(engine, docs):
    """A malformed ``element`` fails its own request before it is queued;
    well-formed pinned requests coalesced around it still finish."""
    coalescing = CoalescingEngine(engine, window_ms=300.0)
    outcomes = _run_concurrently({
        "good0": lambda: coalescing.predict([docs[0]], task="elem", element=1),
        "bad_float": lambda: coalescing.predict(
            [docs[1]], task="elem", element=2.5),
        "bad_length": lambda: coalescing.predict(
            [docs[1]], task="elem", element=[0, 1]),
        "good1": lambda: coalescing.predict(
            [docs[1]], task="elem", element=[0]),
    })
    assert outcomes["bad_float"][0] == "err"
    assert isinstance(outcomes["bad_float"][1], ValueError)
    assert isinstance(outcomes["bad_length"][1], ValueError)
    assert outcomes["good0"] == (
        "ok", engine.predict([docs[0]], task="elem", element=1))
    assert outcomes["good1"] == (
        "ok", engine.predict([docs[1]], task="elem", element=0))


_NO_JAX = r"""
import importlib.abc, json, os, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "flexdm_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, Block())
assert os.environ["FLEXDM_PLATFORM"] == "cpu"
data_dir, job, crello_dir = sys.argv[1:4]

from flexdm_tpu_torch.data import DatasetSpec
from flexdm_tpu_torch.config import TrainConfig, build_model
from flexdm_tpu_torch.convert import init_params, save_weights
from flexdm_tpu_torch.serve import InferenceEngine, _jsonable

config = {"dataset_name": "rico", "data_dir": data_dir, "latent_dim": 32,
          "num_blocks": 1, "num_heads": 4}
os.makedirs(os.path.join(job, "checkpoints"))
with open(os.path.join(job, "args.json"), "w") as f:
    json.dump(config, f)
spec = DatasetSpec("rico", data_dir, 2)
model = init_params(build_model(TrainConfig.from_args(config), spec.schema), 0)
save_weights(os.path.join(job, "checkpoints", "best.torch.npz"), model)
engine = InferenceEngine(job, batch_size=2, device="cpu")
docs = _jsonable(spec.unbatch(next(iter(spec.make_dataset("test", batch_size=2)))))
out = engine.predict(docs, task="pos")
assert len(out) == 2

bf16 = os.path.join(os.path.dirname(job), "bf16")
os.makedirs(os.path.join(bf16, "checkpoints"))
with open(os.path.join(bf16, "args.json"), "w") as f:
    json.dump(dict(config, dtype="bfloat16"), f)
save_weights(os.path.join(bf16, "checkpoints", "best.torch.npz"), model)
engine = InferenceEngine(bf16, batch_size=2, device="cpu")
assert engine.model.dtype == "bfloat16"
assert len(engine.predict(docs, task="pos", num_iter=2)) == 2

from flexdm_tpu_torch.cli import main

trained = os.path.join(os.path.dirname(job), "trained")
main(["--dataset_name", "crello", "--data_dir", crello_dir, "--job-dir", trained,
      "--num_epochs", "1", "--batch_size", "16", "--latent_dim", "32",
      "--num_blocks", "1", "--device", "cpu", "--log_level", "WARNING"])
spec = DatasetSpec("crello", crello_dir, 2)
docs = _jsonable(spec.unbatch(next(iter(spec.make_dataset("test", batch_size=2)))))
engine = InferenceEngine(trained, batch_size=2, device="cpu")
assert len(engine.predict(docs, task="pos")) == 2

import csv, runpy

scores = os.path.join(os.path.dirname(job), "scores.csv")
sys.argv = ["flexdm_tpu_torch.evaluation", "--job-dir", trained, "--device", "cpu",
            "--task_mode", "all_feat", "--batch_size", "8", "--result_csv", scores]
runpy.run_module("flexdm_tpu_torch.evaluation", run_name="__main__")
with open(scores) as f:
    keys, values = list(csv.reader(f))
assert "left" in keys and "text_embedding" in keys and len(values) == len(keys)

flat = os.path.join(os.path.dirname(job), "flat")
main(["--preset", "crello_flat", "--data_dir", crello_dir, "--job-dir", flat,
      "--num_epochs", "1", "--batch_size", "16", "--latent_dim", "32",
      "--num_blocks", "1", "--device", "cpu", "--log_level", "WARNING"])
engine = InferenceEngine(flat, batch_size=2, device="cpu")
assert engine.model.seq_type == "flat"
assert len(engine.predict(docs, task="pos", num_iter=2)) == 2
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("OK", len(out))
"""


def test_port_runs_with_jax_blocked(rico_dir, crello_dir, tmp_path):
    """Serving (a float32 and a bf16 model), a 1-epoch training run scored
    by ``python -m flexdm_tpu_torch.evaluation --task_mode all_feat``, and
    a flat model
    trained for an epoch and served with MaskGIT (``num_iter=2``), with JAX
    and every
    module of the JAX package unimportable, and ``FLEXDM_PLATFORM`` set
    (with it set, importing ``flexdm_tpu`` imports JAX)."""
    env = dict(os.environ, FLEXDM_PLATFORM="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, rico_dir, str(tmp_path / "job"),
         crello_dir],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK 2")
