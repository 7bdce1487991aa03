"""Compare builds of the port's bf16 flash-attention backward on one GPU.

    python tools/torch_bwd_bf16_bench.py [--other NAME=PATH.cu ...] [--steps]

Builds ``flexdm_tpu_torch/csrc/flash_attention_bwd_bf16.cu`` (as the port
builds it) and every ``--other`` source with the same C entry points (an
earlier revision of the file, with its own headers beside it), one nvcc
each, all at once, and prints each build's ptxas report.  Then:

* checks every build's dq, dk and dv against the plain bf16 backward (one
  bf16 ulp plus 2^-8 of the largest entry) at each timed shape;
* times every build's dq and dk/dv kernels at (256, 8, 50, 32),
  (64, 8, 500, 32) and (1, 2, 4096, 64) as device time (CUDA graph of 20
  calls, median of 50), in turns: the builds in the order given, then
  reversed; beside them the library's bf16 backward
  (``scaled_dot_product_attention`` forward + backward less the forward)
  and the bound of ``chip_smoke.backward_bounds``;
* with ``--steps``: the crello_flat bf16 training step at batch 64 (random
  weights, seed 0; one synthetic batch) with each build swapped in, in
  turns (A, B, B, A): median of 20 warm steps between CUDA events, and from
  ``torch.profiler`` over 10 steps the device kernel time per step and the
  attention kernels' share.

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

SHAPES = ((256, 8, 50, 32), (64, 8, 500, 32), (1, 2, 4096, 64))
ENTRIES = ("flexdm_flash_attention_bwd_dq_bf16",
           "flexdm_flash_attention_bwd_dkv_bf16")


def bind(lib):
    """The ``(dq, dkv)`` entry points of a loaded library."""
    fns = []
    for symbol in ENTRIES:
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
    return tuple(fns)


def build(name, source):
    """``(name, (dq, dkv), ptxas report)``: the port's own library for
    ``source`` None, else nvcc of ``source`` into the build dir."""
    from flexdm_tpu_torch.ops import _build
    from flexdm_tpu_torch.ops import attention as attn

    if source is None:
        path = _build.build_library(*attn.BWD_BF16_LIBRARY)
        report = _build.BUILD_LOGS.get(attn.BWD_BF16_LIBRARY[0], "(reused)")
    else:
        path = os.path.join(_build.BUILD_DIR, f"libbwd_bf16_bench_{name}.so")
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", path, source]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        report = proc.stdout + proc.stderr
    registers = [line.strip() for line in report.splitlines()
                 if "registers" in line or "stack" in line
                 or "Compiling entry" in line or "C75" in line]
    return name, bind(ctypes.CDLL(str(path))), registers


def inputs(shape, seed):
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    b, _, s, _ = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
                   for _ in range(4))
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[:, s - s // 5:] = False
    mask = mask.cuda()
    o, _, m, l = attn._forward(q, k, v, mask, False)
    return q, k, v, do, mask, o, m, l


def run(fns, q, k, v, do, mask, o, m, l):
    """dq, dk, dv through one build's two kernels."""
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    b, h, s, dh = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = attn._stream(q)
    attn._launch("dq", fns[0], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr(), o.data_ptr(), do.data_ptr(), m.data_ptr(),
                 l.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, s, dh,
                 0, stream)
    attn._launch("dkv", fns[1], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(),
                 delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, s, dh,
                 0, stream)
    return dq, dk, dv, delta


def bench_kernels(builds, card):
    import torch
    import torch.nn.functional as F

    from flexdm_tpu_torch.ops import attention as attn

    results = {}
    for shape in SHAPES:
        q, k, v, do, mask, o, m, l = inputs(shape, sum(shape))
        b, _, s, _ = shape
        bias = attn.key_bias(mask, b, s, q.device)
        want = attn.attention_reference_backward(q, k, v, bias, o, do)
        for name, fns, _ in builds:
            got = run(fns, q, k, v, do, mask, o, m, l)[:3]
            for gname, x, w in zip(("dq", "dk", "dv"), got, want):
                ok, err = chip_smoke.bf16_close(x, w)
                chip_smoke.check(ok, f"{name} {gname} at {shape}: {err}")
        times = {name: {"dq": [], "dkv": []} for name, _, _ in builds}
        for name, fns, _ in [*builds, *builds[::-1]]:
            delta = run(fns, q, k, v, do, mask, o, m, l)[3]
            dq, dk, dv = (torch.empty_like(q) for _ in range(3))
            bb, h, ss, dh = q.shape
            # The stream is read at each call: device_ms captures on its own.
            times[name]["dq"].append(chip_smoke.device_ms(
                lambda: fns[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               mask.data_ptr(), o.data_ptr(), do.data_ptr(),
                               m.data_ptr(), l.data_ptr(), delta.data_ptr(),
                               dq.data_ptr(), bb, h, ss, dh, 0,
                               attn._stream(q))))
            times[name]["dkv"].append(chip_smoke.device_ms(
                lambda: fns[1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               mask.data_ptr(), do.data_ptr(), m.data_ptr(),
                               l.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), bb, h, ss, dh, 0,
                               attn._stream(q))))
        sdpa_mask = bias.to(torch.bfloat16)[:, None, None, :]

        def library(backward):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask)
            return torch.autograd.grad(out, leaves, do) if backward else out

        lib = (chip_smoke.device_ms(lambda: library(True))
               - chip_smoke.device_ms(lambda: library(False)))
        bounds = dict(zip(("dq", "dkv"), chip_smoke.backward_bounds(
            shape, 2, chip_smoke.BF16_FLOPS)))
        flops = 2 * shape[0] * shape[1] * s * s * shape[3]
        for name in times:
            t = {part: statistics.mean(v) for part, v in times[name].items()}
            total = t["dq"] + t["dkv"]
            chip_smoke.log(
                f"[bwd bf16] {name} {shape}: dq {times[name]['dq']} ms, "
                f"dkv {times[name]['dkv']} ms (turns); dq + dkv "
                f"{total:.4f} ms, {7 * flops / total / 1e9:.1f} TFLOP/s; "
                f"library backward {lib:.4f} ms; bounds dq "
                f"{bounds['dq']['bound_ms']:.4f}, dkv "
                f"{bounds['dkv']['bound_ms']:.4f} ms [{card}]")
        results[str(shape)] = {"times": times, "library_ms": lib,
                               "bounds": bounds}
    return results


def bench_steps(builds, card):
    """The crello_flat bf16 step with each build's kernels swapped in."""
    import torch

    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.convert import init_params
    from flexdm_tpu_torch.models import make_task_config
    from flexdm_tpu_torch.models.masking import draw_train
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.train.optim import KerasAdam
    from flexdm_tpu_torch.train.trainer import make_train_step

    own = attn._bwd_kernels
    results = {name: [] for name, _, _ in builds}
    with tempfile.TemporaryDirectory() as root:
        data_dir, spec, batch = chip_smoke.train_data(root, "crello", 0)
        args = dict(chip_smoke.load_args(chip_smoke.FLAT_CONFIG, data_dir),
                    dtype=chip_smoke.BF16)
        config = TrainConfig.from_args(args)
        task_config = make_task_config(spec.schema, config.masking_method)
        model = init_params(build_model(config, spec.schema), 0).cuda()
        step = make_train_step(model, task_config,
                               KerasAdam(model.parameters(),
                                         config.learning_rate), config.l2)
        batch = {k: v[:chip_smoke.FLAT_BATCH].cuda() for k, v in batch.items()}
        generator = torch.Generator("cuda").manual_seed(0)
        draws = draw_train(spec.schema, chip_smoke.FLAT_BATCH,
                           task_config.task_probs, generator,
                           **model.draw_options())
        draws.dropout = generator
        try:
            for name, fns, _ in [builds[0], *builds[1:], *builds[1:],
                                 builds[0]]:
                attn._bwd_kernels = (lambda dtype=torch.float32, fns=fns:
                                     fns if dtype == torch.bfloat16
                                     else own(dtype))
                for _ in range(5):
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
                device, attention, kernels, top = chip_smoke.profile_steps(
                    lambda: step(batch, draws), steps=10)
                results[name].append({
                    "step_ms": statistics.median(times), "device_ms": device,
                    "attention_ms": attention, "kernels": kernels})
                chip_smoke.log(
                    f"[bwd bf16 steps] {name}: crello_flat bf16 step "
                    f"{statistics.median(times):.2f} ms (median of 20), "
                    f"device kernel time {device:.3f} ms per step, attention"
                    f" kernels {attention:.3f} ms, {kernels:.0f} kernels; "
                    f"most time: {top} [{card}]")
        finally:
            attn._bwd_kernels = own
    return results


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", action="append", default=[],
                        help="NAME=PATH.cu, another build of the same "
                        "entry points")
    parser.add_argument("--steps", action="store_true",
                        help="also time the crello_flat bf16 step")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this bench needs one GPU")
    card = chip_smoke.card_line()
    jobs = [("this", None)] + [tuple(o.split("=", 1)) for o in args.other]
    with ThreadPoolExecutor(len(jobs)) as pool:
        builds = list(pool.map(lambda job: build(*job), jobs))
    for name, _, registers in builds:
        chip_smoke.log(f"[build] {name}:\n  " + "\n  ".join(registers))
    out = {"card": card, "kernels": bench_kernels(builds, card)}
    if args.steps:
        out["steps"] = bench_steps(builds, card)
    chip_smoke.log(json.dumps(out))


if __name__ == "__main__":
    main()
