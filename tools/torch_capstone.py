"""Release-scale capstone of the port: the north-star recipe chain.

    python tools/torch_capstone.py [--docs 20000] [--epochs 500]
        [--num_iter 4] [--batch_size 256] [--latent_dim 256]
        [--num_blocks 4] [--root DIR] [--out F] [--resume]
        [--models imp,exp,exp_ft] [--skip-eval] [--device cuda]

Counterpart of ``tools/capstone.py`` for ``flexdm_tpu_torch``, importing
nothing of the JAX package.  It runs the reference's published crello
recipe chain (README.md:38-41, train.py:79-97) on a corpus of ``--docs``
raw templates built by ``tools/torch_build_crello_dataset.py``:

    Ours-IMP     masking_method=random,                --epochs
    Ours-EXP     masking_method=elem_pos_attr_img_txt, --epochs
    Ours-EXP-FT  = EXP warm-started from IMP's best weights (--weights)

each with validation every 10 epochs and on the last, best-by-val
checkpointing, then scores every task mode on the test split with
``python -m flexdm_tpu_torch.evaluation`` (random, elem, pos/attr/img/txt,
and elem under MaskGIT ``--num_iter``), and writes the per-field score
table with wall times (host clock), each stage's attention-kernel
launches and the card's name and power limit (``nvidia-smi``) to ``--out``
(default ``<root>/capstone.json``; never into the repository), and prints
it as one JSON line.

The corpus is built once: a ``<root>/data`` with a ``count.json`` is
reused.  A stage whose ``checkpoints/final.torch.npz`` exists is skipped
(delete its job dir to re-train); ``--resume`` continues an interrupted
run from its ``checkpoints/last.torch.npz``.
"""

import argparse
import json
import logging
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

logger = logging.getLogger("torch_capstone")

RECIPES = {
    "imp": {"masking_method": "random"},
    "exp": {"masking_method": "elem_pos_attr_img_txt"},
    "exp_ft": {"masking_method": "elem_pos_attr_img_txt",
               "weights_from": "imp"},
}
VALIDATION_FREQ = 10


def ensure_corpus(root: str, docs: int) -> str:
    """Build (once) the corpus via the L0 offline builder."""
    data_dir = os.path.join(root, "data")
    if os.path.exists(os.path.join(data_dir, "count.json")):
        logger.info("corpus already built at %s", data_dir)
        return data_dir
    from tools.torch_build_crello_dataset import main as build_main
    from tools.torch_scale_drill import make_raw_dump

    raw = os.path.join(root, "dump.jsonl")
    t0 = time.perf_counter()
    make_raw_dump(raw, docs)
    build_main(["--input", raw, "--out", data_dir, "--shards", "8",
                "--val-frac", "0.05", "--test-frac", "0.05"])
    logger.info("corpus built in %.1fs", time.perf_counter() - t0)
    return data_dir


def job_dir_of(root: str, name: str) -> str:
    return os.path.join(root, f"job_{name}")


def train_stage(name: str, data_dir: str, root: str, args,
                weights: str = None) -> dict:
    from flexdm_tpu_torch.config import TrainConfig
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.train.trainer import train

    job_dir = job_dir_of(root, name)
    row = {"job_dir": job_dir}
    if os.path.isfile(os.path.join(job_dir, "checkpoints",
                                   "final.torch.npz")):
        logger.info("[%s] already trained (checkpoints/final exists)", name)
        row["skipped"] = True
        return row
    config = TrainConfig(
        dataset_name="crello", data_dir=data_dir, job_dir=job_dir,
        latent_dim=args.latent_dim, num_blocks=args.num_blocks,
        block_type="deepsvg", batch_size=args.batch_size,
        num_epochs=args.epochs, learning_rate=1e-4, l2=1e-2, dropout=0.1,
        validation_freq=VALIDATION_FREQ, seed=0,
        masking_method=RECIPES[name]["masking_method"],
        weights=weights, resume=args.resume, input_mode="device",
        device=args.device,
    )
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    out = train(config)
    row["train_wall_sec"] = time.perf_counter() - t0
    row["launches"] = attn.launch_counts()
    hist = out["history"]
    row["epochs_run"] = len(hist)
    row["steps"] = hist[-1]["step"]
    row["loss_first"] = hist[0]["loss"]
    row["loss_last"] = hist[-1]["loss"]
    row["best_val_total_score"] = out["best_val_total_score"]
    row["stopped_on_nan"] = out["stopped_on_nan"]
    row["n_validations"] = sum(1 for h in hist if "val_total_score" in h)
    row["n_best_saves"] = sum(1 for h in hist if h.get("checkpointed"))
    row["test_total_score"] = out["test_metrics"].get("total_score",
                                                      float("nan"))
    if len(hist) >= 3:
        deltas = [hist[i]["wall_time"] - hist[i - 1]["wall_time"]
                  for i in range(1, len(hist)) if "val_total_score"
                  not in hist[i] and "val_total_score" not in hist[i - 1]]
        if deltas:
            row["steady_epoch_sec"] = statistics.median(deltas)
    return row


def eval_stage(name: str, data_dir: str, root: str, args) -> dict:
    """All task modes on the test split, via the public eval CLI entry."""
    from flexdm_tpu_torch.evaluation.harness import main as eval_main
    from flexdm_tpu_torch.ops import attention as attn

    base = ["--job-dir", job_dir_of(root, name), "--data_dir", data_dir,
            "--batch_size", str(args.batch_size), "--device", args.device]
    runs = {"random": ["--task_mode", "random"],
            "elem": ["--task_mode", "elem"]}
    for grp in ("pos", "attr", "img", "txt"):
        runs[grp] = ["--task_mode", grp]
    runs[f"elem_maskgit{args.num_iter}"] = [
        "--task_mode", "elem", "--num_iter", str(args.num_iter)]
    scores, launches = {}, {}
    t0 = time.perf_counter()
    for key, extra in runs.items():
        attn.reset_launch_counts()
        scores[key] = eval_main(base + extra)
        launches[key] = attn.launch_counts()
    scores["_eval_wall_sec"] = time.perf_counter() - t0
    scores["_launches"] = launches
    return scores


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--docs", type=int, default=20000)
    parser.add_argument("--epochs", type=int, default=500)
    parser.add_argument("--num_iter", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--latent_dim", type=int, default=256)
    parser.add_argument("--num_blocks", type=int, default=4)
    parser.add_argument("--root", default=os.path.join(
        tempfile.gettempdir(), "flexdm_torch_capstone"))
    parser.add_argument("--out", default=None,
                        help="result JSON path (default <root>/capstone.json)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--models", default="imp,exp,exp_ft")
    parser.add_argument("--skip-eval", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from tools.torch_profile_step import card_name

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU run")
    os.makedirs(args.root, exist_ok=True)
    out_path = args.out or os.path.join(args.root, "capstone.json")
    data_dir = ensure_corpus(args.root, args.docs)

    result = {
        "_meta": {
            "corpus": f"synthetic crello raw dump, {args.docs} docs, "
                      "offline-built (tools/torch_build_crello_dataset.py), "
                      "90/5/5 split",
            "config": f"latent {args.latent_dim}, {args.num_blocks} deepsvg "
                      f"blocks, B={args.batch_size}, {args.epochs} epochs, "
                      "Adam 1e-4 clipnorm 1.0, l2 1e-2, dropout 0.1, seed 0, "
                      f"val every {VALIDATION_FREQ} and on the last, "
                      "best-by-val",
            "recipes": "IMP=random; EXP=elem_pos_attr_img_txt; "
                       "EXP-FT=EXP warm-started from IMP best "
                       "(reference README.md:38-41)",
            "device": str(device),
            "card": card_name(device),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
    }
    models = [m.strip() for m in args.models.split(",") if m.strip()]
    for name in models:
        weights = None
        if RECIPES[name].get("weights_from"):
            weights = os.path.join(
                job_dir_of(args.root, RECIPES[name]["weights_from"]),
                "checkpoints", "best.torch.npz")
            if not os.path.isfile(weights):
                raise SystemExit(f"{name} needs {weights}; train "
                                 f"{RECIPES[name]['weights_from']} first")
        logger.info("=== training %s ===", name)
        result[name] = {"train": train_stage(name, data_dir, args.root,
                                             args, weights)}
        _flush(result, out_path)

    if not args.skip_eval:
        for name in models:
            logger.info("=== evaluating %s ===", name)
            result[name]["eval"] = eval_stage(name, data_dir, args.root,
                                              args)
            _flush(result, out_path)

    print(json.dumps(result))
    return result


def _flush(result, path):
    with open(path, "w") as f:
        json.dump(result, f, indent=2)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
