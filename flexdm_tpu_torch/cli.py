"""``python -m flexdm_tpu_torch``: train an MFP model with the port.

The flags and ``--preset`` mirror ``flexdm_tpu/cli.py`` (``python -m
flexdm_tpu``), plus ``--device`` (default ``cuda``).  A flag that selects
something the port does not have yet raises ``NotImplementedError``:
``--resume``, ``--weights``, ``--num_devices``/``--model_parallel`` above 1,
``--enable_profile``, ``--input_mode device``, ``--checkpoint_every``, an
``--attention_impl`` other than ``auto``, every ``--arch_type`` but the
oneshot model and a ``--dtype`` other than ``float32`` and ``bfloat16``
(``build_model`` raises for those two).  ``--dtype bfloat16`` computes in
bf16 where the JAX package does; parameters, gradients, the optimizer
state and checkpoints stay float32.
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
    add("--input_mode", default="host", choices=["device", "host"])
    add("--checkpoint_every", default=None, type=int)
    add("--device", default="cuda", help="torch device to train on")
    return parser


def _refuse_unported(args) -> None:
    unported = {
        "--resume": args.resume,
        "--weights": args.weights is not None,
        "--num_devices > 1": (args.num_devices or 1) > 1,
        "--model_parallel > 1": args.model_parallel > 1,
        "--enable_profile": args.enable_profile,
        "--input_mode device": args.input_mode == "device",
        "--checkpoint_every": args.checkpoint_every is not None,
        f"--attention_impl {args.attention_impl}": args.attention_impl != "auto",
    }
    for flag, given in unported.items():
        if given:
            raise NotImplementedError(f"{flag} is not in this port yet")


def main(argv=None) -> None:
    parser = make_parser()
    argv = _apply_preset(sys.argv[1:] if argv is None else argv, parser)
    args = parser.parse_args(argv)
    _refuse_unported(args)
    logging.basicConfig(level=getattr(logging, args.log_level.upper()))

    from .train.trainer import train

    config = TrainConfig(**{
        k: v for k, v in vars(args).items()
        if k in TrainConfig.__dataclass_fields__
    })
    results = train(config)
    print("test metrics:")
    for k, v in sorted(results["test_metrics"].items()):
        print(f"  {k}: {v:.4f}")
