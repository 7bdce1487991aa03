"""``tools/torch_capstone.py`` on the CPU at a tiny width (128 raw
documents, latent 32, 1 block, batch 16, 2 epochs, MaskGIT 2 rounds), run
with JAX blocked: the IMP -> EXP -> EXP-FT chain trains, EXP-FT starts
from IMP's ``best.torch.npz``, every task mode scores, the result lands
under ``--root`` (the repository untouched), and a second run reuses the
corpus and skips the trained stages."""

import json
import math
import os

import pytest

from tests.test_torch_tools import ROOT, tool_json

NUM_ITER = 2
TINY = ["--docs", "128", "--epochs", "2", "--num_iter", str(NUM_ITER),
        "--batch_size", "16", "--latent_dim", "32", "--num_blocks", "1",
        "--device", "cpu"]
MODELS = ("imp", "exp", "exp_ft")
TASKS = ("random", "elem", "pos", "attr", "img", "txt",
         f"elem_maskgit{NUM_ITER}")
ANCHOR = os.path.join(ROOT, "BASELINE_ANCHOR_V2.json")


@pytest.fixture(scope="module")
def capstone(tmp_path_factory):
    root = tmp_path_factory.mktemp("capstone")
    with open(ANCHOR, "rb") as f:
        anchor = f.read()
    result = tool_json("torch_capstone.py", "--root", str(root), *TINY)
    with open(ANCHOR, "rb") as f:
        assert f.read() == anchor  # the JAX tool's default target untouched
    return root, result


def test_result_lands_under_root(capstone):
    root, result = capstone
    assert json.loads((root / "capstone.json").read_text()) == result
    assert sorted(os.listdir(root)) == ["capstone.json", "data",
                                        "dump.jsonl", "job_exp",
                                        "job_exp_ft", "job_imp"]
    meta = result["_meta"]
    assert (meta["device"], meta["card"]) == ("cpu", "cpu")
    assert "tools/torch_build_crello_dataset.py" in meta["corpus"]


@pytest.mark.parametrize("name", MODELS)
def test_each_stage_trains_and_scores(capstone, name):
    root, result = capstone
    train = result[name]["train"]
    assert train["job_dir"] == str(root / f"job_{name}")
    assert train["epochs_run"] == 2 and not train["stopped_on_nan"]
    assert train["n_validations"] == 1 == train["n_best_saves"]
    for key in ("loss_first", "loss_last", "best_val_total_score",
                "test_total_score", "train_wall_sec"):
        assert math.isfinite(train[key]), key
    for ckpt in ("best", "final", "last"):
        assert (root / f"job_{name}" / "checkpoints"
                / f"{ckpt}.torch.npz").exists()
    scores = result[name]["eval"]
    assert set(scores) == set(TASKS) | {"_eval_wall_sec", "_launches"}
    for task in TASKS:
        assert scores[task], task
        assert all(0 <= v <= 1 for v in scores[task].values()), task
        assert set(scores["_launches"][task].values()) == {0}  # CPU
    assert set(scores["pos"]) == {"left", "top", "width", "height"}


def test_exp_ft_starts_from_imps_best(capstone):
    root, result = capstone
    with open(root / "job_exp_ft" / "args.json") as f:
        args = json.load(f)
    assert args["weights"] == str(root / "job_imp" / "checkpoints"
                                  / "best.torch.npz")
    assert args["masking_method"] == "elem_pos_attr_img_txt"
    with open(root / "job_exp" / "args.json") as f:
        assert json.load(f)["weights"] is None
    assert result["exp_ft"]["train"]["loss_first"] != \
        result["exp"]["train"]["loss_first"]


def test_second_run_reuses_corpus_and_jobs(capstone):
    root, _ = capstone
    before = (root / "data" / "count.json").stat().st_mtime_ns
    again = tool_json("torch_capstone.py", "--root", str(root), "--out",
                      str(root / "again.json"), "--skip-eval", *TINY)
    assert (root / "data" / "count.json").stat().st_mtime_ns == before
    for name in MODELS:
        assert again[name]["train"]["skipped"] is True
        assert "eval" not in again[name]
