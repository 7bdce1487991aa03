"""The port's entry points with a baseline job, on the CPU at a tiny size
(D=16, 1 block (BART: 1 + 1), 8 heads, batch 32, one epoch on the crello fixture):
``python -m flexdm_tpu_torch --preset crello_{canvasvae,layoutvae,
autoreg,bart}`` trains, validates and writes ``best``/``last``/``final``;
the eval CLI scores the job (``pos``; ``elem``'s autoreg protocol is held
to JAX in ``tests/test_torch_eval_autoreg.py``); ``InferenceEngine``
answers a prediction request; the demo renders a page.  No JAX runs
here."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flexdm_tpu_torch import cli  # noqa: E402
from flexdm_tpu_torch.demo import load_model, run_demo  # noqa: E402
from flexdm_tpu_torch.evaluation import harness  # noqa: E402
from flexdm_tpu_torch.models import baselines  # noqa: E402
from flexdm_tpu_torch.serve import InferenceEngine, _jsonable  # noqa: E402

TINY = ["--latent_dim", "16", "--num_blocks", "1",
        "--batch_size", "32", "--num_epochs", "1", "--validation_freq", "1",
        "--device", "cpu", "--log_level", "WARNING"]
PRESETS = {"crello_canvasvae": baselines.CanvasVAE,
           "crello_layoutvae": baselines.LayoutVAE,
           "crello_autoreg": baselines.AutoReg,
           "crello_bart": baselines.BART}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_baseline_preset_trains_evaluates_and_serves(preset, crello_dir,
                                                     tmp_path):
    job = str(tmp_path / "job")
    # --dtype bfloat16 is accepted and ignored by a baseline, as in JAX.
    extra = ["--dtype", "bfloat16"] if preset == "crello_canvasvae" else []
    cli.main(["--preset", preset, "--data_dir", crello_dir, "--job-dir", job,
              *TINY, *extra])
    with open(os.path.join(job, "logs", "history.jsonl")) as f:
        history = [json.loads(line) for line in f]
    assert len(history) == 1 and history[0]["checkpointed"]
    record = history[0]
    assert all(np.isfinite(v) for v in record.values()
               if isinstance(v, float))
    assert record["val_loss"] > 0 and 0 < record["val_total_score"] <= 1
    for name in ("best", "last", "final"):
        assert os.path.exists(os.path.join(job, "checkpoints",
                                           f"{name}.torch.npz"))

    model, spec = load_model(job, device="cpu")
    assert type(model) is PRESETS[preset]
    assert all(p.dtype == torch.float32 for p in model.parameters())

    csv_path = str(tmp_path / "pos.csv")
    scores = harness.main(["--job-dir", job, "--task_mode", "pos",
                           "--batch_size", "16", "--device", "cpu",
                           "--result_csv", csv_path])
    assert scores and all(0 <= v <= 1 for v in scores.values())
    assert os.path.exists(csv_path)

    engine = InferenceEngine(job, batch_size=4, device="cpu")
    docs = _jsonable(spec.unbatch(next(iter(spec.make_dataset(
        "test", batch_size=3)))))
    preds = engine.predict(docs, task="pos", num_iter=3)
    assert len(preds) == 3
    for doc, pred in zip(docs, preds):
        assert len(pred["elements"]) == len(doc["elements"])
        for el_in, el_out in zip(doc["elements"], pred["elements"]):
            assert el_out["type"] == el_in["type"]  # not in the pos group

    outputs = {}
    page = run_demo(job, task="elem", num_examples=2, device="cpu",
                    out_path=str(tmp_path / "demo.html"), outputs=outputs)
    assert os.path.exists(page)
    assert outputs["rounds"] == []
