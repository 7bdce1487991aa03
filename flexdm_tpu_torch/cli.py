"""``python -m flexdm_tpu_torch``: train an MFP model with the port.

The flags and ``--preset`` mirror ``flexdm_tpu/cli.py`` (``python -m
flexdm_tpu``), plus ``--device`` (default ``cuda``).  ``--input_mode``
defaults to ``device`` (the train split resident on the card), as the JAX
CLI's does; ``host`` streams it through a prefetch thread.  ``--resume``
continues from ``checkpoints/last.torch.npz``, ``--checkpoint_every``
sets how often ``last`` is written, ``--weights`` warm-starts from a
``*.torch.npz`` weight file (a JAX job's checkpoint is converted with
``tools/export_torch_weights.py``), ``--enable_profile`` writes a
``torch.profiler`` trace to ``logs/trace``.  Every ``--arch_type``
trains: the oneshot model and the baselines (``--preset
crello_{canvasvae,layoutvae,autoreg,bart}``).  ``--num_devices N
[--model_parallel M]`` trains on N ranks, ``N / M`` data-parallel by
``M`` tensor-parallel (every arch type): spawned from this process
(one card each, ``cuda:r`` with ``nccl``; ``--device cpu``: N CPU ranks
with ``gloo``), or, under ``torchrun``, joined to its group (also over
more than one node); rank 0 prints.  ``--attention_impl`` is JAX's:
``auto`` (the kernels on a card, the plain version on the CPU), ``xla``
(the plain version on any device) or ``pallas`` (the kernels; with
``--device cpu`` it raises before anything is written); ``args.json``
records it.  Every head dim (``latent_dim / 8``) runs on a card: above
128 through the wide kernels.  For the oneshot model a ``--dtype`` other
than ``float32``
and ``bfloat16`` raises ``NotImplementedError`` (``build_model``).
``--dtype bfloat16`` computes the oneshot model in bf16 where the JAX
package does; parameters, gradients, the optimizer state and checkpoints
stay float32.
A baseline computes in float32 whatever ``--dtype`` says (logged), as in
the JAX package.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .config import TrainConfig

CONFIGS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs"
)


def _apply_preset(argv, parser):
    """``--preset <name|path>`` loads ``configs/<name>.json`` as argument
    defaults (explicit flags still win)."""
    argv = list(argv)
    if "--preset" not in argv:
        return argv
    i = argv.index("--preset")
    name = argv[i + 1]
    del argv[i:i + 2]
    path = name if os.path.exists(name) else os.path.join(
        CONFIGS_DIR, name + ".json"
    )
    with open(path) as f:
        preset = json.load(f)
    parser.set_defaults(**preset)
    for action in parser._actions:  # a preset may satisfy required flags
        if action.dest in preset:
            action.required = False
    return argv


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train an MFP model (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    add = parser.add_argument
    add("--dataset_name", required=True, choices=["rico", "crello"])
    add("--data_dir", required=True)
    add("--weights", default=None, type=str)
    add("--latent_dim", default=256, type=int)
    add("--num_blocks", default=4, type=int)
    add("--arch_type", default="oneshot",
        choices=["oneshot", "canvasvae", "layoutvae", "autoreg",
                 "bart_autoreg"])
    add("--kl", default=1.0, type=float, help="KL weight for VAE baselines")
    add("--block_type", default="deepsvg", choices=["deepsvg", "transformer"])
    add("--l2", default=1e-2, type=float)
    add("--dropout", default=0.1, type=float)
    add("--masking_method", default="random", type=str)
    add("--seq_type", default="default", choices=["default", "flat"])
    add("--log_level", default="INFO", type=str)
    add("--seed", default=0, type=int)
    add("--context", default=None)
    add("--input_dtype", default="set", choices=["set", "shuffled_set"])
    add("--batch_size", default=256, type=int)
    add("--attention_impl", default="auto", choices=["auto", "xla", "pallas"])
    add("--dtype", default=None)
    add("--num_devices", default=None, type=int)
    add("--model_parallel", default=1, type=int)
    add("--job-dir", dest="job_dir", required=True)
    add("--num_epochs", default=500, type=int)
    add("--learning_rate", default=1e-4, type=float)
    add("--enable_profile", action="store_true")
    add("--validation_freq", default=10, type=int)
    add("--resume", action="store_true")
    add("--input_mode", default="device", choices=["device", "host"])
    add("--checkpoint_every", default=None, type=int)
    add("--device", default="cuda", help="torch device to train on")
    return parser


def main(argv=None) -> None:
    parser = make_parser()
    argv = _apply_preset(sys.argv[1:] if argv is None else argv, parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper()))

    from .train.trainer import train

    config = TrainConfig(**{
        k: v for k, v in vars(args).items()
        if k in TrainConfig.__dataclass_fields__
    })
    results = train(config)
    if results is None:  # a rank other than 0 under torchrun
        return
    print("test metrics:")
    for k, v in sorted(results["test_metrics"].items()):
        print(f"  {k}: {v:.4f}")
