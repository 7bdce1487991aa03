"""Compare builds of the port's flash-attention forward kernel on one GPU.

    python tools/torch_fwd_bench.py [--other NAME=PATH.cu ...] [--steps]

Builds ``flexdm_tpu_torch/csrc/flash_attention_fwd.cu`` three times, with
4, 2 and 1 warps per block (64-, 32- and 16-row query tiles), plus every
``--other`` source that has the same C entry point (an earlier revision of
the file, or a variant of it), one nvcc each, all at once.  Then:

* checks every build against the plain PyTorch version (O and lse within
  2e-5 abs + 2e-5 rel) at each timed shape;
* times every build at (8, 8, 50, 32), (256, 8, 50, 32) and (8, 8, 650, 32)
  as device time (CUDA graph of 20 calls, median of 50), in turns: each
  build twice, in the order given and then reversed;
* with ``--steps``: the crello Ours-EXP training step at batch 256 (random
  weights, seed 0; one synthetic batch; draws and dropout on the card) with
  the default build and with each ``--other`` build swapped in, in turns
  (A, B, B, A): median of 20 warm steps between CUDA events, and from
  ``torch.profiler`` over 10 steps the device kernel time per step, the
  forward kernel's time per step and the device kernels per step.

Prints one line per measurement and, last, one JSON object with all of
them.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SHAPES = ((8, 8, 50, 32), (256, 8, 50, 32), (8, 8, 650, 32))
WARPS = (4, 2, 1)


def build(name, source, flags):
    """nvcc ``source`` into a library in the build dir; returns its entry."""
    from flexdm_tpu_torch.ops import _build

    out = os.path.join(_build.BUILD_DIR, f"libfwd_bench_{name}.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags,
           "-I", str(_build.CSRC_DIR), "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    fn = ctypes.CDLL(out).flexdm_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    registers = [line.strip() for line in
                 (proc.stdout + proc.stderr).splitlines()
                 if "registers" in line]
    return name, fn, registers


def call(fn, q, k, v, mask):
    """The forward through ``fn`` (a C entry point): O, lse, m, l."""
    import torch

    b, h, s, dh = q.shape
    o = torch.empty_like(q)
    lse, m, l = torch.empty((3, b, h, s), device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
             o.data_ptr(), lse.data_ptr(), m.data_ptr(), l.data_ptr(),
             b, h, s, dh, 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return o, lse, m, l


def bench_kernels(builds, card):
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    g = torch.Generator().manual_seed(0)
    results = {}
    for shape in SHAPES:
        b, h, s, dh = shape
        q, k, v = (torch.randn(shape, generator=g).cuda() for _ in range(3))
        mask = torch.ones(b, s, dtype=torch.bool)
        mask[:, s - s // 5:] = False
        mask = mask.cuda()
        bias = attn.key_bias(mask, b, s, q.device)
        want = (attn.attention_reference(q, k, v, bias),
                attn.attention_reference_lse(q, k, bias))
        row = {}
        for name, fn, _ in builds:
            o, lse, _, _ = call(fn, q, k, v, mask)
            err = max((o - want[0]).abs().max().item(),
                      (lse - want[1]).abs().max().item())
            chip_smoke.check(
                torch.allclose(o, want[0], **chip_smoke.KERNEL_TOL)
                and torch.allclose(lse, want[1], **chip_smoke.KERNEL_TOL),
                f"{name} differs from plain at {shape}: {err}")
            row[name] = {"max_abs_err": err, "ms": []}
        order = builds + builds[::-1]
        for name, fn, _ in order:
            row[name]["ms"].append(chip_smoke.device_ms(
                lambda fn=fn: call(fn, q, k, v, mask)))
        for name, r in row.items():
            print(f"[fwd] {shape} {name}: device ms {r['ms'][0]:.4f}, "
                  f"{r['ms'][1]:.4f} (max abs err {r['max_abs_err']:.2e}) "
                  f"[{card}]", flush=True)
        results[str(shape)] = row
    return results


def device_kernels(prof, steps):
    """(device kernel ms per step, forward kernel ms per step, kernels per
    step) from a profile of ``steps`` steps."""
    import torch

    total = fwd = 0.0
    count = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time", None)
        if us is None:
            us = e.cuda_time
        total += us
        count += 1
        if "flash_fwd" in e.name:
            fwd += us
    return total / 1e3 / steps, fwd / 1e3 / steps, count / steps


def bench_steps(builds, card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params
    from flexdm_tpu_torch.data import DatasetSpec, split_device_batch, \
        synthetic
    from flexdm_tpu_torch.models import make_task_config
    from flexdm_tpu_torch.models.masking import draw_train
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.train.optim import KerasAdam
    from flexdm_tpu_torch.train.trainer import make_train_step

    batch_size = chip_smoke.TRAIN_BATCH
    with tempfile.TemporaryDirectory() as root:
        data_dir = synthetic.generate("crello", os.path.join(root, "data"),
                                      batch_size, 4, 4, seed=0)
        spec = DatasetSpec("crello", data_dir, batch_size)
        batch = {k: torch.from_numpy(v).cuda() for k, v in split_device_batch(
            next(iter(spec.make_dataset("train")))).items()}
    with open(os.path.join(REPO, chip_smoke.CONFIG)) as f:
        config = TrainConfig.from_args(dict(json.load(f), data_dir=data_dir))
    task_config = make_task_config(spec.schema, config.masking_method)
    default = attn._kernel
    first, *others = builds
    results = {}
    for name, fn, _ in [first, *others, *others, first]:
        attn._kernel = (lambda fn=fn: fn)
        model = init_params(build_model(config, spec.schema), 0).cuda()
        step = make_train_step(
            model, task_config,
            KerasAdam(model.parameters(), config.learning_rate), config.l2)
        generator = torch.Generator("cuda").manual_seed(0)
        draws = draw_train(spec.schema, batch_size, task_config.task_probs,
                           generator)
        draws.dropout = generator
        for _ in range(20):
            step(batch, draws)
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            step(batch, draws)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                step(batch, draws)
            torch.cuda.synchronize()
        device, fwd, kernels = device_kernels(prof, 10)
        step_ms = statistics.median(times)
        r = {"step_ms": step_ms, "min_ms": min(times), "max_ms": max(times),
             "device_ms": device, "fwd_ms": fwd, "kernels": kernels,
             "busy": device / step_ms}
        results.setdefault(name, []).append(r)
        print(f"[step] {name}: step {step_ms:.2f} ms (min {min(times):.2f}, "
              f"max {max(times):.2f}); device kernel time {device:.3f} ms "
              f"per step, forward kernel {fwd:.3f} ms, {kernels:.0f} device "
              f"kernels per step, busy {device / step_ms:.1%} [{card}]",
              flush=True)
    attn._kernel = default
    return results


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", action="append", default=[],
                        metavar="NAME=PATH.cu")
    parser.add_argument("--steps", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    source = os.path.join(REPO, "flexdm_tpu_torch", "csrc",
                          "flash_attention_fwd.cu")
    jobs = [(f"w{w}", source, [f"-DFLEXDM_FWD_WARPS={w}"]) for w in WARPS]
    jobs += [(*other.split("=", 1), []) for other in args.other]
    with ThreadPoolExecutor(len(jobs)) as pool:
        builds = list(pool.map(lambda job: build(*job), jobs))
    for name, _, registers in builds:
        print(f"[build] {name}: {'; '.join(registers)}", flush=True)
    out = {"card": card, "kernels": bench_kernels(builds, card)}
    if args.steps:
        step_builds = [builds[0]] + builds[len(WARPS):]
        out["steps"] = bench_steps(step_builds, card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
