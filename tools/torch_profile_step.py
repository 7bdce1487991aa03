"""The port's training step, segment by segment.

    python tools/torch_profile_step.py [--preset crello_ours_exp]
        [--batch-size 256] [--latent-dim 256] [--num-blocks 4]
        [--dtype bfloat16] [--remat] [--attention-impl auto] [--iters 30]
        [--device cuda]

Counterpart of ``tools/profile_step.py`` for ``flexdm_tpu_torch``: the
preset's model (random weights, seed 0) on one batch of a synthetic corpus
made in a temporary directory, and each segment of a training step run
``--iters`` times after a warm-up, its median reported in ms:

* ``masking_ms``: the step's draws (``trainer.step_draws``) and the task
  masking (``preprocess_for_train``; the element shuffle or sort of a
  shuffled or sorted model is left out);
* ``forward_ms``: ``forward_train``'s loss with dropout, no autograd;
* ``forward_backward_ms``: the loss with the L2 term and the gradients of
  every parameter;
* ``optimizer_ms``: the per-tensor clip and keras Adam on fixed gradients;
* ``full_step_ms``: the trainer's step (``make_train_step``), draws
  included.

On a card each segment is timed between CUDA events (``clock``
``cuda_events``); with ``--device cpu`` on the host clock (``clock``
``host``: a CPU number, not a device time).  Prints one JSON line with the
device, the card's name and power limit (``nvidia-smi``) and the
attention kernels' launches over the whole run.
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

WARMUP = 3


def card_name(device) -> str:
    """The card's name and power limit, as nvidia-smi gives them; the CPU
    has none."""
    if device.type != "cuda":
        return "cpu"
    import chip_smoke

    return chip_smoke.card_line()


def median_ms(fn, iters, device) -> float:
    """Median ms of ``fn()`` over ``iters`` calls after ``WARMUP``: CUDA
    events on a card, the host clock on the CPU."""
    import torch

    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1000 * (time.perf_counter() - t0))
    return statistics.median(times)


def make_config(args):
    """The preset with the flags' overrides (its ``data_dir`` unset)."""
    from flexdm_tpu_torch.config import TrainConfig

    with open(os.path.join(REPO, "configs", f"{args.preset}.json")) as f:
        preset = json.load(f)
    preset.update(device=args.device,
                  attention_impl=args.attention_impl, remat=args.remat)
    for key in ("batch_size", "latent_dim", "num_blocks", "dtype"):
        if getattr(args, key) is not None:
            preset[key] = getattr(args, key)
    return TrainConfig.from_args(preset)


def profile(config, iters):
    """Every segment's median ms (see the module docstring)."""
    import torch

    from flexdm_tpu_torch.config import build_model
    from flexdm_tpu_torch.convert import init_params
    from flexdm_tpu_torch.data import DatasetSpec
    from flexdm_tpu_torch.models import forward_train, make_task_config
    from flexdm_tpu_torch.models.masking import preprocess_for_train
    from flexdm_tpu_torch.train.optim import (
        KerasAdam,
        clip_by_per_leaf_norm,
        l2_penalty,
    )
    from flexdm_tpu_torch.train.trainer import (
        CLIPNORM,
        make_train_step,
        step_draws,
        to_device,
    )

    device = torch.device(config.device)
    b = config.batch_size
    spec = DatasetSpec(config.dataset_name, config.data_dir, b)
    schema = spec.schema
    batch = to_device(next(iter(spec.make_dataset("train"))), device)
    model = init_params(build_model(config, schema), 0).to(device)
    task_config = make_task_config(schema, config.masking_method)
    optimizer = KerasAdam(model.parameters(), config.learning_rate)
    generator = torch.Generator(device).manual_seed(0)
    l2 = config.l2 or 0.0

    def draws():
        return step_draws(model, schema, task_config, b, generator)

    def masking():
        d = draws()
        return preprocess_for_train(batch, schema, d.tasks, d.uniforms,
                                    d.element, d.values)

    def forward():
        with torch.no_grad():
            return forward_train(model, batch, draws(), task_config)[0]

    def gradients():
        loss = forward_train(model, batch, draws(), task_config)[0]
        if l2:
            loss = loss + l2 * l2_penalty(model)
        return torch.autograd.grad(loss, optimizer.params,
                                   allow_unused=True)

    fixed = [torch.zeros_like(p) if g is None else g
             for p, g in zip(optimizer.params, gradients())]

    def update():
        grads = [g.clone() for g in fixed]
        clip_by_per_leaf_norm(grads, CLIPNORM, optimizer.params)
        optimizer.step(grads)

    step = make_train_step(model, task_config, optimizer, l2)
    out = {}
    for name, fn in (("masking_ms", masking), ("forward_ms", forward),
                     ("forward_backward_ms", gradients),
                     ("optimizer_ms", update),
                     ("full_step_ms", lambda: step(batch, draws()))):
        out[name] = median_ms(fn, iters, device)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="crello_ours_exp")
    parser.add_argument("--batch-size", dest="batch_size", type=int,
                        default=None)
    parser.add_argument("--latent-dim", dest="latent_dim", type=int,
                        default=None)
    parser.add_argument("--num-blocks", dest="num_blocks", type=int,
                        default=None)
    parser.add_argument("--dtype", default=None)
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--attention-impl", dest="attention_impl",
                        default="auto")
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from flexdm_tpu_torch.data import synthetic
    from flexdm_tpu_torch.ops import attention as attn

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU run")
    with tempfile.TemporaryDirectory() as root:
        config = make_config(args)
        config.data_dir = synthetic.generate(
            config.dataset_name, os.path.join(root, "data"),
            config.batch_size, 4, 4, seed=0)
        attn.reset_launch_counts()
        segments = profile(config, args.iters)
    out = {
        "config": {"preset": args.preset, "batch_size": config.batch_size,
                   "latent_dim": config.latent_dim,
                   "num_blocks": config.num_blocks, "dtype": config.dtype,
                   "remat": config.remat,
                   "attention_impl": config.attention_impl,
                   "iters": args.iters},
        "device": str(device), "card": card_name(device),
        "clock": "cuda_events" if device.type == "cuda" else "host",
        **segments,
        "steps_per_sec": 1000.0 / segments["full_step_ms"],
        "launches": attn.launch_counts(),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
