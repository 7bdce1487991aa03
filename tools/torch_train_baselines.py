"""Train the baseline presets with the port, one row each.

    python tools/torch_train_baselines.py [--docs 2048] [--epochs N]
        [--arch canvasvae|layoutvae|autoreg|bart_autoreg]
        [--latent-dim D] [--num-blocks N] [--batch-size B]
        [--device cuda] [--job-root DIR] [--out results.json]

Counterpart of ``tools/train_baselines.py`` for ``flexdm_tpu_torch``:
each ``configs/crello_<name>.json`` baseline preset (or ``--arch``'s
alone) trained by ``flexdm_tpu_torch.train.trainer.train`` on a synthetic
crello corpus of ``--docs`` train documents (and ``max(64, docs / 8)``
validation and test documents, seed 0), made in a temporary directory.
The flags override the preset's epochs, width, depth and batch.  A row
per preset: the loss of the first and the last epoch, the best
``val_total_score``, the epochs run, the wall seconds of ``train()`` (host
clock), the parameters and whether the run stopped on a non-finite loss.
Prints one JSON line with the rows, the device and the card's name and
power limit (``nvidia-smi``).
"""

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools.torch_profile_step import card_name  # noqa: E402

PRESETS = {
    "canvasvae": "crello_canvasvae",
    "layoutvae": "crello_layoutvae",
    "autoreg": "crello_autoreg",
    "bart_autoreg": "crello_bart",
}


def train_row(arch, data_dir, job_dir, args):
    """One preset trained; its row."""
    from flexdm_tpu_torch.config import TrainConfig
    from flexdm_tpu_torch.train.trainer import train

    with open(os.path.join(REPO, "configs", f"{PRESETS[arch]}.json")) as f:
        preset = json.load(f)
    if args.epochs:
        preset["num_epochs"] = args.epochs
        preset["validation_freq"] = min(
            preset.get("validation_freq", args.epochs), args.epochs)
    for key in ("latent_dim", "num_blocks", "batch_size"):
        if getattr(args, key):
            preset[key] = getattr(args, key)
    config = TrainConfig.from_args(dict(preset, data_dir=data_dir,
                                        job_dir=job_dir, device=args.device))
    t0 = time.perf_counter()
    out = train(config)
    wall = time.perf_counter() - t0
    hist = out["history"]
    return {"preset": PRESETS[arch], "loss_first": hist[0]["loss"],
            "loss_last": hist[-1]["loss"],
            "best_val_total_score": out["best_val_total_score"],
            "epochs": len(hist), "wall_sec": wall,
            "num_params": out["num_params"],
            "stopped_on_nan": out["stopped_on_nan"]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--docs", type=int, default=2048)
    parser.add_argument("--epochs", type=int, default=None,
                        help="override the preset's num_epochs")
    parser.add_argument("--latent-dim", dest="latent_dim", type=int,
                        default=None)
    parser.add_argument("--num-blocks", dest="num_blocks", type=int,
                        default=None)
    parser.add_argument("--batch-size", dest="batch_size", type=int,
                        default=None)
    parser.add_argument("--arch", default=None, choices=sorted(PRESETS),
                        help="one architecture instead of all")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--job-root", default=None)
    parser.add_argument("--out", default=None, help="write the rows here")
    args = parser.parse_args(argv)

    import torch

    from flexdm_tpu_torch.data import synthetic

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU run")
    results = {}
    with tempfile.TemporaryDirectory() as root:
        eval_docs = max(64, args.docs // 8)
        data_dir = synthetic.generate("crello", os.path.join(root, "data"),
                                      args.docs, eval_docs, eval_docs,
                                      seed=0)
        job_root = args.job_root or os.path.join(root, "jobs")
        for arch in [args.arch] if args.arch else sorted(PRESETS):
            results[arch] = train_row(arch, data_dir,
                                      os.path.join(job_root, arch), args)
    out = {"docs": args.docs, "device": str(device),
           "card": card_name(device), "baselines": results}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
