"""Release-scale drill of the port: raw JSONL -> build -> train -> eval -> demo.

    python tools/torch_scale_drill.py [--docs 20000] [--epochs 3]
        [--latent-dim 256] [--num-blocks 4] [--batch-size 256]
        [--dtype bfloat16] [--root DIR] [--out F] [--device cuda]

Counterpart of ``tools/scale_drill.py`` for ``flexdm_tpu_torch``, importing
nothing of the JAX package.  It writes a raw JSONL dump of ``--docs``
crello templates (:func:`make_raw_dump`, the JAX tool's generator: the
same seed writes the same bytes), builds it with
``tools/torch_build_crello_dataset.py``, measures the first epoch's decode
rate through the port's ``DataLoader`` (the C++ decoder where g++ is
found), checks that the built positions are not degenerate, trains the
flagship with ``flexdm_tpu_torch.train.trainer.train`` in
``input_mode="device"``, scores ``pos`` on the test split resident and
streaming (``resident=False``; their sums must agree within the port's
2e-5 relative, at which ``pos``'s integer counts are equal), and renders
a demo page with ``python -m flexdm_tpu_torch.demo``.  Prints one JSON row
with the wall times (host clock), the attention kernels' launches per
stage, the device and, on a card, its name and power limit
(``nvidia-smi``).  Not carried over: the JAX tool's persistent
compilation cache.
"""

import argparse
import json
import os
import random
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

PATHS_RTOL = 2e-5  # resident vs streaming sums: the port's bar for its paths

FONTS = ["Roboto", "Lato", "Montserrat", "Oswald", "Raleway", "Merriweather"]
GROUPS = ["socialMedia", "blogging", "marketing", "adBanner"]
FORMATS = ["instagramPost", "facebookPost", "twitterPost", "mediumRectangle"]
WORDS = ("sale summer brand new launch deal flash event open join "
         "free taste shop local night live music art fest").split()


def _element(rng: random.Random, i: int, cw: int, ch: int):
    # Geometry is in PIXELS relative to the canvas, as in real crello raw
    # dumps — the offline builder normalizes by canvas size (norm(el.x, w)).
    t = rng.random()
    if i == 0 and t < 0.7:
        return {
            "type": "coloredBackground", "uuid": f"u{i}", "width": cw,
            "height": ch, "opacity": 1.0,
            "color": "#%06x" % rng.randrange(1 << 24),
            "position": {"x": 0, "y": 0},
        }
    common = {
        "uuid": f"u{i}",
        "width": round(rng.uniform(0.05, 0.9) * cw, 1),
        "height": round(rng.uniform(0.05, 0.9) * ch, 1),
        "opacity": round(rng.uniform(0.5, 1.0), 3),
        "left": round(rng.uniform(0.0, 0.8) * cw, 1),
        "top": round(rng.uniform(0.0, 0.8) * ch, 1),
    }
    if t < 0.35:
        return dict(common, type="textElement",
                    text=" ".join(rng.sample(WORDS, rng.randint(1, 5))),
                    font=rng.choice(FONTS),
                    color="#%06x" % rng.randrange(1 << 24))
    if t < 0.6:
        return dict(common, type="imageElement")
    if t < 0.8:
        return dict(common, type="svgElement", colors=[])
    return dict(common, type="maskElement")


def make_raw_dump(path: str, docs: int, seed: int = 0) -> None:
    rng = random.Random(seed)
    with open(path, "w") as f:
        for d in range(docs):
            n = rng.randint(1, 15)
            cw = rng.choice([1080, 1200, 800])
            ch = rng.choice([1080, 628, 600])
            tpl = {
                "id": f"tpl{d:06d}",
                "templateType": "regular",
                "width": cw,
                "height": ch,
                "group": rng.choice(GROUPS),
                "format": rng.choice(FORMATS),
                "template": [{"elements": [_element(rng, i, cw, ch)
                                           for i in range(n)]}],
            }
            f.write(json.dumps(tpl) + "\n")


def _rel_gap(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--docs", type=int, default=20000)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--latent-dim", type=int, default=256)
    parser.add_argument("--num-blocks", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--root", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from flexdm_tpu_torch.config import TrainConfig
    from flexdm_tpu_torch.data import DatasetSpec, tfrecord
    from flexdm_tpu_torch.demo import load_model, main as demo_main
    from flexdm_tpu_torch.evaluation import harness
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.train.trainer import train
    from tools.torch_build_crello_dataset import main as build_main
    from tools.torch_profile_step import card_name

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU run")
    root = args.root or tempfile.mkdtemp(prefix="flexdm_torch_scale_drill_")
    os.makedirs(root, exist_ok=True)
    row = {"docs": args.docs, "root": root, "device": str(device),
           "card": card_name(device)}
    launches = row["launches"] = {}

    # 1. Raw dump -> offline builder (L0 ingestion).
    raw = os.path.join(root, "dump.jsonl")
    t0 = time.perf_counter()
    make_raw_dump(raw, args.docs)
    row["gen_raw_sec"] = time.perf_counter() - t0
    data_dir = os.path.join(root, "data")
    t0 = time.perf_counter()
    build_main(["--input", raw, "--out", data_dir, "--shards", "8",
                "--val-frac", "0.05", "--test-frac", "0.05"])
    row["build_sec"] = time.perf_counter() - t0

    # 2. First-epoch decode throughput (the shards read, then decoded on the
    # first pass: the C++ decoder where it was built).
    spec = DatasetSpec("crello", data_dir, batch_size=args.batch_size)
    loader = spec.make_dataset("train", batch_size=args.batch_size)
    t0 = time.perf_counter()
    nb = sum(1 for _ in loader)
    dt = time.perf_counter() - t0
    if nb != len(loader):
        raise AssertionError(f"{nb} batches of {len(loader)}")
    row["native_decoder"] = tfrecord.native_available()
    row["decode_docs_per_sec"] = loader.num_records / dt
    row["train_records"] = loader.num_records
    row["first_epoch_decode_sec"] = dt

    # Degenerate-data tripwire: a units mismatch between the raw dump and
    # the builder once collapsed every position into bucket 0, which makes
    # eval scores a vacuous 1.0.  Fail loudly instead.
    probe = next(iter(spec.make_dataset("train", batch_size=64)))
    for col in ("left", "top", "width", "height"):
        if col in probe and len(np.unique(np.asarray(probe[col]))) < 2:
            raise AssertionError(
                f"built dataset is degenerate: column {col!r} has a "
                "single value across 64 documents"
            )

    # 3. Train device-resident (the flagship input path).
    config = TrainConfig(
        dataset_name="crello", data_dir=data_dir,
        job_dir=os.path.join(root, "job"),
        latent_dim=args.latent_dim, num_blocks=args.num_blocks,
        batch_size=args.batch_size, num_epochs=args.epochs,
        validation_freq=max(1, args.epochs // 2 + args.epochs % 2),
        dtype=None if args.dtype in ("", "float32") else args.dtype,
        input_mode="device", device=args.device,
    )
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    out = train(config)
    row["train_sec"] = time.perf_counter() - t0
    launches["train"] = attn.launch_counts()
    hist = out["history"]
    row["steps"] = hist[-1]["step"]
    row["loss_first"] = hist[0]["loss"]
    row["loss_last"] = hist[-1]["loss"]
    row["best_val_total_score"] = out["best_val_total_score"]
    row["stopped_on_nan"] = out["stopped_on_nan"]
    # The first epoch's wall holds the one-time work (the split's decode
    # and upload); the steady rate is the MEDIAN epoch-over-epoch wall
    # delta (min is optimistically biased; both are reported).
    if len(hist) >= 2:
        deltas = [hist[i]["wall_time"] - hist[i - 1]["wall_time"]
                  for i in range(1, len(hist))]
        med = statistics.median(deltas)
        row["steady_epoch_sec"] = med
        row["steady_epoch_sec_min"] = min(deltas)
        row["steady_steps_per_sec"] = (row["steps"] / len(hist)
                                       / max(med, 1e-9))
    row["startup_sec"] = hist[0]["wall_time"]

    # 4. Eval of ``pos`` on the best weights: resident AND streaming.
    model, spec = load_model(config.job_dir, "best", args.batch_size,
                             args.device)
    test_loader = spec.make_dataset("test", batch_size=args.batch_size)
    group = ("pos", spec.schema.attribute_groups["pos"])
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    sums = harness.task_sums(model, test_loader, "pos", group, resident=True)
    row["eval_resident_sec"] = time.perf_counter() - t0
    launches["eval_resident"] = attn.launch_counts()
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    streamed = harness.task_sums(model, test_loader, "pos", group,
                                 resident=False)
    row["eval_streaming_sec"] = time.perf_counter() - t0
    launches["eval_streaming"] = attn.launch_counts()
    if set(sums) != set(streamed):
        raise AssertionError(f"resident sums {sorted(sums)} vs streaming "
                             f"{sorted(streamed)}")
    gap = max((_rel_gap(sums[k], streamed[k]) for k in sums), default=0.0)
    if gap > PATHS_RTOL:
        raise AssertionError(
            f"resident vs streaming eval diverged: {sums} vs {streamed}")
    row["eval_paths_max_rel_gap"] = gap
    row["eval_paths_equal"] = sums == streamed
    row["eval_pos_sums"] = sums
    row["eval_pos_scores"] = harness._ratios(spec.schema, sums)
    row["test_records"] = test_loader.num_records

    # 5. Demo render.
    page = os.path.join(root, "demo.html")
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    demo_main(["--job-dir", config.job_dir, "--task", "pos",
               "--num-examples", "4", "--out", page,
               "--device", args.device])
    row["demo_sec"] = time.perf_counter() - t0
    launches["demo"] = attn.launch_counts()
    row["demo_html_bytes"] = os.path.getsize(page)

    print(json.dumps(row))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=2)
    return row


if __name__ == "__main__":
    main()
