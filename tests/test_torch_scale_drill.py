"""``tools/torch_scale_drill.py`` on the CPU at a tiny width (128 raw
documents, latent 32, 1 block, batch 16, 2 epochs), run with JAX blocked:
its row carries every key of the JAX drill's row and the port's own (the
device, the launches a stage, the steps), the resident and streaming
``pos`` sums are equal, and the corpus it built is the JAX builder's."""

import json
import os

import pytest

from tests.test_torch_tools import run_tool, tool_json
from tools import build_crello_dataset as jax_builder

DOCS, BATCH, EPOCHS = 128, 16, 2
JAX_KEYS = {
    "docs", "root", "gen_raw_sec", "build_sec", "decode_docs_per_sec",
    "train_records", "first_epoch_decode_sec", "train_sec", "loss_first",
    "loss_last", "best_val_total_score", "steady_epoch_sec",
    "steady_epoch_sec_min", "steady_steps_per_sec", "startup_sec",
    "eval_resident_sec", "eval_streaming_sec", "eval_pos_scores",
    "test_records", "demo_sec", "demo_html_bytes",
}
STAGES = ("train", "eval_resident", "eval_streaming", "demo")


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    root = tmp_path_factory.mktemp("drill")
    out = root / "row.json"
    row = tool_json("torch_scale_drill.py", "--docs", str(DOCS), "--epochs",
                    str(EPOCHS), "--latent-dim", "32", "--num-blocks", "1",
                    "--batch-size", str(BATCH), "--dtype", "float32",
                    "--root", str(root), "--out", str(out), "--device",
                    "cpu")
    return root, row, json.loads(out.read_text())


def test_row_keys_and_values(drill):
    root, row, written = drill
    assert written == row
    assert JAX_KEYS <= set(row)
    assert (row["docs"], row["root"], row["device"], row["card"]) == (
        DOCS, str(root), "cpu", "cpu")
    assert row["native_decoder"] is True
    assert row["train_records"] + row["test_records"] < DOCS
    assert row["steps"] == EPOCHS * (row["train_records"] // BATCH)
    assert not row["stopped_on_nan"]
    assert row["loss_first"] == row["loss_first"] and row["loss_last"] > 0
    for key in ("build_sec", "decode_docs_per_sec", "train_sec",
                "eval_resident_sec", "eval_streaming_sec", "demo_sec"):
        assert row[key] > 0, key
    assert set(row["eval_pos_scores"]) == {"left", "top", "width", "height"}
    assert all(0 <= v <= 1 for v in row["eval_pos_scores"].values())
    # the CPU runs no kernel: every stage's counts are 0
    assert set(row["launches"]) == set(STAGES)
    assert {v for s in STAGES for v in row["launches"][s].values()} == {0}


def test_resident_equals_streaming(drill):
    _, row, _ = drill
    assert row["eval_paths_equal"] is True
    assert row["eval_paths_max_rel_gap"] == 0.0
    sums = row["eval_pos_sums"]
    assert sums["left_score_den"] > 0
    assert row["eval_pos_scores"]["left"] == pytest.approx(
        sums["left_score_num"] / sums["left_score_den"], rel=1e-12)


def test_corpus_and_demo(drill, tmp_path):
    root, row, _ = drill
    jax_dir = str(tmp_path / "jax")
    jax_builder.main(["--input", str(root / "dump.jsonl"), "--out", jax_dir,
                      "--shards", "8", "--val-frac", "0.05", "--test-frac",
                      "0.05"])
    for name in sorted(os.listdir(jax_dir)):
        assert (root / "data" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    page = (root / "demo.html").read_text()
    assert len(page.encode()) == row["demo_html_bytes"]
    assert page.count("<svg") >= 4 * 3
    for name in ("best", "final", "last"):
        assert (root / "job" / "checkpoints" / f"{name}.torch.npz").exists()


@pytest.mark.parametrize("tool", ["torch_scale_drill.py",
                                  "torch_capstone.py"])
def test_tools_refuse_a_machine_without_a_card(tool, tmp_path):
    proc = run_tool(tool, "--docs", "8", "--root", str(tmp_path))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "dump.jsonl").exists()
