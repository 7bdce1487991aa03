"""The port's demo, stage by stage, cold and warm.

    python tools/torch_profile_demo.py --job-dir JOB [--task pos]
        [--num-examples 4] [--num-iter 1] [--repeats 2] [--device cuda]
        [--out breakdown.json]

Counterpart of ``tools/profile_demo.py`` for ``flexdm_tpu_torch``: calls
``flexdm_tpu_torch.demo.run_demo`` (the CLI's path) ``--repeats`` times in
this process, the first cold (the CUDA context, the kernels' libraries and
the record decoder loaded by it), the others warm, and reports each call's
stages from its ``timings`` hook (``load_model``, ``load_batch``,
``forward_eval``, ``unbatch``, ``svg_html``, in seconds on the host clock)
and its total.  The pages go to a temporary directory.  Prints one JSON
line with the device, the card's name and power limit (``nvidia-smi``)
and the attention kernels' forward launches over the run.
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--job-dir", dest="job_dir", required=True)
    parser.add_argument("--task", default="pos")
    parser.add_argument("--num-examples", type=int, default=4)
    parser.add_argument("--num-iter", type=int, default=1)
    parser.add_argument("--repeats", type=int, default=2,
                        help="run_demo calls (the first cold)")
    parser.add_argument("--checkpoint", default="best")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None,
                        help="also write the breakdown JSON here")
    args = parser.parse_args(argv)

    import torch

    from flexdm_tpu_torch.demo import run_demo
    from flexdm_tpu_torch.ops import attention as attn

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU run")
    attn.reset_launch_counts()
    runs = []
    with tempfile.TemporaryDirectory() as root:
        for i in range(max(args.repeats, 1)):
            timings = {}
            t0 = time.perf_counter()
            run_demo(args.job_dir, args.task, args.num_examples,
                     args.num_iter, os.path.join(root, f"demo_{i}.html"),
                     args.checkpoint, timings=timings, device=device)
            timings["total"] = time.perf_counter() - t0
            runs.append({"run": "cold" if i == 0 else f"warm{i}",
                         "timings": timings})
    result = {"job_dir": args.job_dir, "task": args.task,
              "num_examples": args.num_examples, "num_iter": args.num_iter,
              "device": str(device), "card": card_name(device),
              "runs": runs,
              "launches": {"fwd": attn.KERNEL_LAUNCHES,
                           "fwd_bf16": attn.BF16_FWD_LAUNCHES}}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
